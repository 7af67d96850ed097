"""KASportsFormer, the flagship 2D->3D pose lifter: PyTorch port of
`kasportsformer_tpu/models/kasportsformer.py`.

The per-module formulation of the JAX package (`trunk_layer_apply`) as
`nn.Module`s named after the reference state-dict layout
(`layers_with_bone.{i}.att_spatial...`, `bone_refusion.mlp_layers.{g}...`,
`rep_logit.fc`), so `load_state_dict(strict=True)` takes a reference
state_dict. BoneRefusion keeps the reference's 17 ragged per-limb MLPs as
parameters. The TPU-only restructuring of layers >= 1 (`fused_trunk_*`,
`_stream_transpose`) is an exact float32 reorder for the MXU and is not
ported: every layer runs the per-module form.

Forward contract: (B, T=27, J=17, C=3) -> (B, 27, 17, 3), float32 out.
Parameter count with the public config: 29,365,668.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.skeleton import (
    BONE_CHILD,
    BONE_PARENT,
    LIMB_COMBINATIONS,
    limb_combination_matrix,
    spatial_adjacency,
)

TRUNK_MODULES = ("att_spatial", "att_temporal", "graph_spatial",
                 "graph_temporal", "bone_spatial", "bone_temporal")
_MIXERS = ("attention", "attention", "graph", "graph", "bone", "bone")


# ------------------------------------------------------------ kinematic ops


def bone_decomposer(x: torch.Tensor) -> torch.Tensor:
    """[B,T,17,>=2] joints -> [B,T,17,3] bone tokens (dir_x, dir_y, length).

    16 parent-child bone vectors from the 2D joint coordinates, normalised to
    unit length (zero-length guard: a length of 0 is treated as 1), plus the
    per-frame mean bone as a 17th token (≙ `model/KASportsFormer.py:42-62`).
    """
    xy = x[..., :2]
    child = torch.as_tensor(BONE_CHILD, device=x.device)
    parent = torch.as_tensor(BONE_PARENT, device=x.device)
    directions = xy.index_select(-2, child) - xy.index_select(-2, parent)
    lengths = torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    lengths = torch.where(lengths == 0, torch.ones_like(lengths), lengths)
    directions = directions / lengths
    directions = torch.cat([directions, directions.mean(-2, keepdim=True)], -2)
    lengths = torch.cat([lengths, lengths.mean(-2, keepdim=True)], -2)
    return torch.cat([directions, lengths], dim=-1)


class BoneMLP(nn.Module):
    """One limb channel's MLP over its k composed bones: k -> hidden -> 1
    (≙ `model/modules/bone_MLP.py`)."""

    def __init__(self, k: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(k, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.linear(self.fc2, F.gelu(L.linear(self.fc1, x)))


class BoneMLPGroup(nn.Module):
    """The three channel MLPs of one limb combination."""

    def __init__(self, k: int, hidden: int):
        super().__init__()
        self.mlp_dir_x = BoneMLP(k, hidden)
        self.mlp_dir_y = BoneMLP(k, hidden)
        self.mlp_len = BoneMLP(k, hidden)


class BoneRefusion(nn.Module):
    """[B,T,17,3] -> [B,T,17,3] fused limb tokens: for each of the 17 limb
    combinations, gather its members on the joint axis and run the three
    channel MLPs (≙ `model/modules/bone_refusion.py:61-70`)."""

    def __init__(self, hidden: int = 16):
        super().__init__()
        self.mlp_layers = nn.ModuleList(
            BoneMLPGroup(len(combo), hidden) for combo in LIMB_COMBINATIONS)
        idx, _ = limb_combination_matrix()
        self.register_buffer("limb_idx", torch.as_tensor(idx, dtype=torch.long),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = []
        for g, (combo, grp) in enumerate(zip(LIMB_COMBINATIONS,
                                             self.mlp_layers)):
            xg = x.index_select(-2, self.limb_idx[g, : len(combo)])  # (B,T,k,3)
            out.append(torch.cat(
                [mlp(xg[..., c]) for c, mlp in enumerate(
                    (grp.mlp_dir_x, grp.mlp_dir_y, grp.mlp_len))], dim=-1))
        return torch.stack(out, dim=-2)


# ------------------------------------------------------------ trunk layer


@dataclasses.dataclass(frozen=True)
class KASportsFormerConfig:
    """Model hyperparameters (defaults = the public YAML,
    `configs/sportspose-gt-kasportsformer.yaml:70-92`)."""

    n_layers: int = 26
    dim_in: int = 3
    dim_feat: int = 128
    dim_rep: int = 512
    dim_out: int = 3
    mlp_ratio: float = 4.0
    num_heads: int = 8
    qkv_bias: bool = False
    qkv_scale: float | None = None
    num_joints: int = 17
    n_frames: int = 27
    use_layer_scale: bool = True
    layer_scale_init_value: float = 1e-5
    use_adaptive_fusion: bool = True
    use_temporal_similarity: bool = True
    neighbour_num: int = 4
    temporal_connection_len: int = 1


class TrunkLayer(nn.Module):
    """One RepeatFormerPartWithBone (≙ `model/KASportsFormer.py:204-286`):
    attention, graph and bone-cross-attention branch pairs (spatial then
    temporal) and the 3-way adaptive fusion gate."""

    def __init__(self, cfg: KASportsFormerConfig, spatial_norm_adj: np.ndarray,
                 static_temporal_adj: np.ndarray | None):
        super().__init__()
        self.use_adaptive_fusion = cfg.use_adaptive_fusion
        for name, mixer, mode in zip(TRUNK_MODULES, _MIXERS,
                                     ("spatial", "temporal") * 3):
            setattr(self, name, L.FormerModule(
                cfg.dim_feat, cfg.mlp_ratio, mixer, mode, cfg.num_heads,
                cfg.qkv_bias, cfg.layer_scale_init_value, cfg.n_frames,
                use_layer_scale=cfg.use_layer_scale, qk_scale=cfg.qkv_scale,
                neighbour_num=cfg.neighbour_num,
                spatial_norm_adj=spatial_norm_adj,
                static_temporal_adj=static_temporal_adj))
        self.fusion_three_channel = nn.Linear(3 * cfg.dim_feat, 3)

    def forward(self, x: torch.Tensor, bone_in: torch.Tensor,
                x_limb: torch.Tensor) -> torch.Tensor:
        """x_attn / x_graph from the fused stream x, x_bone from `bone_in`
        cross-attending to the limb stream (≙ `trunk_layer_apply`)."""
        x_attn = self.att_temporal(self.att_spatial(x))
        x_graph = self.graph_temporal(self.graph_spatial(x))
        x_bone = self.bone_temporal(self.bone_spatial(bone_in, x_limb), x_limb)
        if self.use_adaptive_fusion:
            return L.adaptive_fusion(self.fusion_three_channel,
                                     [x_attn, x_graph, x_bone])
        return (x_attn + x_graph + x_bone) / 3


# ------------------------------------------------------------ full model


class KASportsFormer(nn.Module):
    """The flagship lifter. `compute_dtype` is the activation dtype
    (float32 or bfloat16); parameters stay float32."""

    def __init__(self, cfg: KASportsFormerConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or KASportsFormerConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        c, j = cfg.dim_feat, cfg.num_joints
        self.joints_embed = nn.Linear(cfg.dim_in, c)
        self.bone_embed = nn.Linear(cfg.dim_in, c)
        self.limb_embed = nn.Linear(cfg.dim_in, c)
        self.pos_embed = nn.Parameter(torch.zeros(1, j, c))
        self.bone_pos_embed = nn.Parameter(torch.zeros(1, j, c))
        self.limb_pos_embed = nn.Parameter(torch.zeros(1, j, c))
        self.bone_refusion = BoneRefusion()

        # degree-normalised skeleton adjacency, a constant of every spatial GCN
        adj = spatial_adjacency(j)
        dinv = adj.sum(-1) ** -0.5
        spatial_norm_adj = (adj * dinv[:, None] * dinv[None, :]).astype(np.float32)
        # use_temporal_similarity=False: the static banded frame adjacency
        # (`model/modules/graph.py:43-44,63-75`)
        static_temporal_adj = (
            None if cfg.use_temporal_similarity
            else L.temporal_adjacency(cfg.n_frames, cfg.temporal_connection_len))
        self.layers_with_bone = nn.ModuleList(
            TrunkLayer(cfg, spatial_norm_adj, static_temporal_adj)
            for _ in range(cfg.n_layers))
        self.norm = nn.LayerNorm(c)
        self.rep_logit = nn.ModuleDict({"fc": nn.Linear(c, cfg.dim_rep)})
        self.head = nn.Linear(cfg.dim_rep, cfg.dim_out)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from `generator` with the JAX package's init:
        torch defaults for linears, N(0, sqrt(2/in)) GCN U/V weights, zero
        position embeddings, unit/zero norms, `layer_scale_init_value` layer
        scales, and a zero-weight, 1/3-bias fusion gate."""
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                if name.endswith("fusion_three_channel"):
                    L.reset_linear(mod, generator, "zeros")
                    with torch.no_grad():
                        mod.bias.fill_(1.0 / mod.out_features)
                else:
                    gcn = name.endswith(".mixer.U") or name.endswith(".mixer.V")
                    L.reset_linear(mod, generator, "gcn" if gcn else "torch")
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
                mod.reset_parameters()
            elif isinstance(mod, L.FormerModule) and mod.use_layer_scale:
                with torch.no_grad():
                    mod.layer_scale_1.fill_(self.cfg.layer_scale_init_value)
                    mod.layer_scale_2.fill_(self.cfg.layer_scale_init_value)
        with torch.no_grad():
            for p in (self.pos_embed, self.bone_pos_embed, self.limb_pos_embed):
                p.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        x_bone = bone_decomposer(x)
        x_limb = self.bone_refusion(x)

        x = L.linear(self.joints_embed, x) + L.cast(self.pos_embed, dt)
        x_bone = (L.linear(self.bone_embed, x_bone)
                  + L.cast(self.bone_pos_embed, dt))
        x_limb = (L.linear(self.limb_embed, x_limb)
                  + L.cast(self.limb_pos_embed, dt))

        # only layer 0's bone branch reads the embedded bone stream; layers
        # >= 1 feed the fused stream (`model/KASportsFormer.py:332-336`)
        for i, layer in enumerate(self.layers_with_bone):
            x = layer(x, x_bone if i == 0 else x, x_limb)

        x = L.layer_norm(self.norm, x)
        x = torch.tanh(L.linear(self.rep_logit["fc"], x))
        return L.linear(self.head, x).float()

    def parameter_count(self) -> int:
        """Parameter count in the reference's ragged layout (29,365,668 with
        the public config, `model/model_tools.py:100-104`)."""
        return sum(p.numel() for p in self.parameters())
