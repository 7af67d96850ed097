"""MotionAGFormer, KASportsFormer's direct ancestor: an attention branch and
a graph branch per layer, fused by a 2-way adaptive gate. PyTorch port of
`kasportsformer_tpu/models/zoo/motionagformer.py` (≙ `model/MotionAGFormer.py`),
named after the reference state-dict layout (`layers.{i}.att_spatial...`,
`rep_logit.fc`), so a reference state_dict loads with `strict=True`.

Variants, as in the reference: `hierarchical` (the two branches on the two
channel halves, `MotionAGFormer.py:141-152`), `graph_only` (a plain GCN/TCN
graph branch, `:97-109`) and `use_tcn` (the MS-TCN temporal mixer in the
graph branch). Every attention core goes to K1 and every AGFormerBlock MLP
tail to K3 on CUDA: 2 and 4 of each per layer in the base variant.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model
from kasportsformer_torch.skeleton import spatial_adjacency


@dataclasses.dataclass(frozen=True)
class MotionAGFormerConfig:
    n_layers: int = 16
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
    hierarchical: bool = False
    use_tcn: bool = False
    graph_only: bool = False


class MotionAGFormerBlock(nn.Module):
    """One layer: spatial then temporal attention, spatial then temporal
    graph mixing, and the fusion of the two streams."""

    def __init__(self, cfg: MotionAGFormerConfig, spatial_norm_adj: np.ndarray,
                 static_temporal_adj: np.ndarray | None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim_feat // 2 if cfg.hierarchical else cfg.dim_feat

        def former(mixer: str, mode: str) -> L.FormerModule:
            return L.FormerModule(
                dim, cfg.mlp_ratio, mixer, mode, cfg.num_heads, cfg.qkv_bias,
                cfg.layer_scale_init_value, cfg.n_frames,
                use_layer_scale=cfg.use_layer_scale, qk_scale=cfg.qkv_scale,
                neighbour_num=cfg.neighbour_num,
                spatial_norm_adj=spatial_norm_adj,
                static_temporal_adj=static_temporal_adj, with_limb_norm=False)

        self.att_spatial = former("attention", "spatial")
        self.att_temporal = former("attention", "temporal")
        if cfg.graph_only:
            self.graph_spatial = L.GCN(dim, 17, "spatial",
                                       spatial_norm_adj=spatial_norm_adj)
            self.graph_temporal = (
                L.MultiScaleTCN(dim, dim) if cfg.use_tcn else
                L.GCN(dim, cfg.n_frames, "temporal", cfg.neighbour_num,
                      static_temporal_adj=static_temporal_adj))
        else:
            self.graph_spatial = former("graph", "spatial")
            self.graph_temporal = former("ms-tcn" if cfg.use_tcn else "graph",
                                         "temporal")
        if cfg.use_adaptive_fusion:
            # allocated in hierarchical mode too, where the forward does not
            # use it, as the reference's parameter layout has it
            self.fusion = nn.Linear(2 * dim, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.hierarchical:
            c = x.shape[-1]
            x_attn, x_graph = x[..., : c // 2], x[..., c // 2:]
        else:
            x_attn = x_graph = x
        x_attn = self.att_temporal(self.att_spatial(x_attn))
        if cfg.hierarchical:
            x_graph = x_graph + x_attn
        x_graph = self.graph_temporal(self.graph_spatial(x_graph))
        if cfg.hierarchical:
            return torch.cat([x_attn, x_graph], dim=-1)
        if cfg.use_adaptive_fusion:
            return L.adaptive_fusion(self.fusion, [x_attn, x_graph])
        return (x_attn + x_graph) * 0.5


class MotionAGFormer(nn.Module):
    """(B, T, 17, C) -> (B, T, 17, 3). `compute_dtype` is the activation
    dtype (float32 or bfloat16); parameters stay float32."""

    def __init__(self, cfg: MotionAGFormerConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or MotionAGFormerConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        adj = spatial_adjacency(cfg.num_joints)
        dinv = adj.sum(-1) ** -0.5
        spatial_norm_adj = (adj * dinv[:, None] * dinv[None, :]).astype(np.float32)
        static_temporal_adj = (
            None if cfg.use_temporal_similarity
            else L.temporal_adjacency(cfg.n_frames, cfg.temporal_connection_len))
        self.joints_embed = nn.Linear(cfg.dim_in, cfg.dim_feat)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, cfg.dim_feat))
        self.layers = nn.ModuleList(
            MotionAGFormerBlock(cfg, spatial_norm_adj, static_temporal_adj)
            for _ in range(cfg.n_layers))
        self.norm = nn.LayerNorm(cfg.dim_feat)
        self.rep_logit = nn.ModuleDict({"fc": nn.Linear(cfg.dim_feat, cfg.dim_rep)})
        self.head = nn.Linear(cfg.dim_rep, cfg.dim_out)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from `generator`: torch defaults for
        linears and convolutions, N(0, sqrt(2/in)) GCN U/V weights, a
        zero-weight, 1/2-bias fusion gate, zero position embedding, unit/zero
        norms and `layer_scale_init_value` layer scales."""
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                if name.endswith(".fusion"):
                    L.reset_linear(mod, generator, "zeros")
                    with torch.no_grad():
                        mod.bias.fill_(1.0 / mod.out_features)
                else:
                    gcn = name.endswith((".U", ".V"))
                    L.reset_linear(mod, generator, "gcn" if gcn else "torch")
            elif isinstance(mod, nn.Conv2d):
                L.reset_conv(mod, generator)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.reset_parameters()
            elif isinstance(mod, L.FormerModule) and mod.use_layer_scale:
                with torch.no_grad():
                    mod.layer_scale_1.fill_(self.cfg.layer_scale_init_value)
                    mod.layer_scale_2.fill_(self.cfg.layer_scale_init_value)
        with torch.no_grad():
            self.pos_embed.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = L.linear(self.joints_embed, x.to(dt)) + L.cast(self.pos_embed, dt)
        for layer in self.layers:
            x = layer(x)
        x = L.layer_norm(self.norm, x)
        x = torch.tanh(L.linear(self.rep_logit["fc"], x))
        return L.linear(self.head, x).float()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("MotionAGFormer")
def _build(config) -> MotionAGFormer:
    cfg = MotionAGFormerConfig(
        n_layers=config.n_layers, dim_in=config.dim_in, dim_feat=config.dim_feat,
        dim_rep=config.dim_rep, dim_out=config.dim_out,
        mlp_ratio=float(config.mlp_ratio), num_heads=config.num_heads,
        qkv_bias=config.qkv_bias, qkv_scale=config.qkv_scale,
        num_joints=config.num_joints, n_frames=config.n_frames,
        use_layer_scale=config.use_layer_scale,
        layer_scale_init_value=config.layer_scale_init_value,
        use_adaptive_fusion=config.use_adaptive_fusion,
        use_temporal_similarity=config.use_temporal_similarity,
        neighbour_num=config.neighbour_num,
        temporal_connection_len=config.temporal_connection_len,
        hierarchical=config.hierarchical, use_tcn=config.use_tcn,
        graph_only=config.graph_only)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return MotionAGFormer(cfg, compute_dtype=dtype)
