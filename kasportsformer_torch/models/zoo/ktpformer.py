"""KTPFormer, a MixSTE trunk behind kinematic and trajectory prior
attention: PyTorch port of `kasportsformer_tpu/models/zoo/ktpformer.py`
(≙ `model/KTPFormer.py`), named after the reference state-dict layout
(`kpattention.attn.kpa.gconv.W`, `tpattention.attn.tpa.gconv1.bn`,
`STEblocks.{i}`, `Spatial_norm`, `head.1`, ...).

KPA lifts the raw 2-channel joints through a learnable graph convolution
over the skeleton adjacency (separate self and neighbour weights, per-node
gains, a learned offset of the topology), batch norm over the channels and
ReLU, adds a spatial position embedding, then MHSA with a residual from the
embedded stream and an MLP tail. TPA is its temporal twin: two stacked graph
convolutions over the chain of frames, with a residual around both. The
trunk is MixSTE's alternating spatial/temporal pairs with shared stream
norms. LayerNorm eps is 1e-6 but for KPA's and TPA's norm1 and the head's
(1e-5). Every attention core goes to K1 and every MLP tail to K3 on CUDA:
2 + 2 * depth of each per forward.

The adjacency priors follow `model/model_tools.py:46-75`: symmetric,
row-normalised, the diagonal set to 1. `in_chans` is 2 whatever the config's
`dim_in` says, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model

_EPS = 1e-6

H36M_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15])


def adj_mx_from_edges(num_pts: int, edges: np.ndarray) -> np.ndarray:
    """Symmetric, row-normalised adjacency with unit diagonal
    (≙ `model/model_tools.py:46-62`)."""
    adj = np.zeros((num_pts, num_pts), np.float32)
    for i, j in edges:
        adj[i, j] = 1.0
    adj = np.maximum(adj, adj.T)
    rowsum = adj.sum(1)
    rinv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    adj = adj * rinv[:, None]
    eye = np.eye(num_pts, dtype=np.float32)
    return adj * (1 - eye) + eye


def adj_mx_from_skeleton(num_joints: int = 17) -> np.ndarray:
    edges = [(i, p) for i, p in enumerate(H36M_PARENTS[:num_joints]) if p >= 0]
    return adj_mx_from_edges(num_joints, np.array(edges))


def adj_mx_from_skeleton_temporal(num_frames: int,
                                  parents: np.ndarray | None = None) -> np.ndarray:
    if parents is None:
        parents = np.arange(-1, num_frames - 1)  # the chain of frames
    edges = [(i, p) for i, p in enumerate(parents) if p >= 0]
    return adj_mx_from_edges(num_frames, np.array(edges))


@dataclasses.dataclass(frozen=True)
class KTPFormerConfig:
    num_frame: int = 27
    num_joints: int = 17
    in_chans: int = 2
    embed_dim: int = 256
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    dim_out: int = 3


class LearnableGraphConv(nn.Module):
    """(B, N, C_in) -> (B, N, C_out) over a fixed base adjacency plus a
    learned offset `adj2`, symmetrised; the diagonal term takes W[0], the
    off-diagonal W[1], both gated per node by M (`KTPFormer.py:39-66`)."""

    def __init__(self, dim_in: int, dim_out: int, base_adj: np.ndarray):
        super().__init__()
        n = base_adj.shape[0]
        self.W = nn.Parameter(torch.zeros(2, dim_in, dim_out))
        self.M = nn.Parameter(torch.ones(n, dim_out))
        self.adj2 = nn.Parameter(torch.full((n, n), 1e-6))
        self.bias = nn.Parameter(torch.zeros(dim_out))
        # constant, not a parameter: kept out of the state_dict
        self.register_buffer("base_adj", torch.as_tensor(base_adj),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """xavier-uniform W (gain 1.414), M = 1, adj2 = 1e-6, bias
        U(-1/sqrt(out), 1/sqrt(out))."""
        dim_in, dim_out = self.W.shape[1:]
        bound_w = 1.414 * math.sqrt(6.0 / (dim_in + dim_out))
        with torch.no_grad():
            self.W.uniform_(-bound_w, bound_w, generator=generator)
            self.M.fill_(1.0)
            self.adj2.fill_(1e-6)
            self.bias.uniform_(-dim_out ** -0.5, dim_out ** -0.5,
                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        w = L.cast(self.W, dt)
        h0, h1 = x @ w[0], x @ w[1]
        adj = L.cast(self.base_adj, dt) + L.cast(self.adj2, dt)
        adj = (adj.T + adj) / 2
        eye = torch.eye(adj.shape[0], dtype=dt, device=adj.device)
        m = L.cast(self.M, dt)
        out = (adj * eye) @ (m * h0)
        out = out + (adj * (1 - eye)) @ (m * h1)
        return out + L.cast(self.bias, dt)


class Prior(nn.Module):
    """The KPA/TPA unit: graph convolution, batch norm over the channels of
    the (B, C, N) layout (running statistics in eval, batch statistics and
    an update of them in training) and ReLU (`KTPFormer.py:88-131`)."""

    def __init__(self, dim_in: int, dim_out: int, base_adj: np.ndarray):
        super().__init__()
        self.gconv = LearnableGraphConv(dim_in, dim_out, base_adj)
        self.bn = nn.BatchNorm1d(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gconv(x).transpose(1, 2)
        return F.relu(L.batch_norm(self.bn, h, self.training).transpose(1, 2))


class StackedPrior(nn.Module):
    """TPA's two stacked priors with a residual around both
    (`KTPFormer.py:134-144`)."""

    def __init__(self, dim: int, base_adj: np.ndarray):
        super().__init__()
        self.gconv1 = Prior(dim, dim, base_adj)
        self.gconv2 = Prior(dim, dim, base_adj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.gconv2(self.gconv1(x))


class PriorAttention(nn.Module):
    """The attention half of KPA or TPA: the prior, its position embedding,
    norm1, qkv and proj (read by `layers.attention_tokens`)."""

    def __init__(self, prior: str, pos: str, n: int, dim: int, qkv_bias: bool,
                 module: nn.Module):
        super().__init__()
        self.add_module(prior, module)
        self.register_parameter(pos, nn.Parameter(torch.zeros(1, n, dim)))
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class PriorBlock(nn.Module):
    """KPA or TPA: `attn` and the MLP tail's `norm2` and `mlp`."""

    def __init__(self, attn: PriorAttention, dim: int, hidden: int):
        super().__init__()
        self.attn = attn
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = L.Mlp(dim, hidden)

    def tail(self, tokens: torch.Tensor, pos: nn.Parameter, num_heads: int,
             qk_scale: float | None) -> torch.Tensor:
        """Position embedding, MHSA with the residual from the embedded
        stream, MLP tail."""
        tokens = tokens + L.cast(pos, tokens.dtype)
        h = L.layer_norm(self.attn.norm1, tokens, 1e-5)
        tokens = tokens + L.attention_tokens(self.attn, h, num_heads, qk_scale)
        return L.mlp_ln_residual(self.norm2, self.mlp, tokens, _EPS)


class KTPFormer(nn.Module):
    """(B, F, J, >=2) -> (B, F, J, dim_out)."""

    def __init__(self, cfg: KTPFormerConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or KTPFormerConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        dim, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        kpa = Prior(cfg.in_chans, dim, adj_mx_from_skeleton(cfg.num_joints))
        tpa = StackedPrior(dim, adj_mx_from_skeleton_temporal(cfg.num_frame))
        self.kpattention = PriorBlock(
            PriorAttention("kpa", "Spatial_pos_embed", cfg.num_joints, dim,
                           cfg.qkv_bias, kpa), dim, hidden)
        self.tpattention = PriorBlock(
            PriorAttention("tpa", "Temporal_pos_embed", cfg.num_frame, dim,
                           cfg.qkv_bias, tpa), dim, hidden)
        self.STEblocks = nn.ModuleList(
            L.TransformerBlock(dim, cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depth))
        self.TTEblocks = nn.ModuleList(
            L.TransformerBlock(dim, cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depth))
        self.Spatial_norm = nn.LayerNorm(dim)
        self.Temporal_norm = nn.LayerNorm(dim)
        self.head = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, cfg.dim_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from `generator`: the graph
        convolutions' own (`LearnableGraphConv.reset_parameters`), torch
        defaults for linears, zero position embeddings, unit/zero norms and
        fresh batch-norm statistics."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                L.reset_linear(mod, generator)
            elif isinstance(mod, LearnableGraphConv):
                mod.reset_parameters(generator)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
                mod.reset_parameters()
        with torch.no_grad():
            self.kpattention.attn.Spatial_pos_embed.zero_()
            self.tpattention.attn.Temporal_pos_embed.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x[..., : cfg.in_chans].to(self.compute_dtype)
        b, f, n, _ = x.shape
        heads, scale = cfg.num_heads, cfg.qk_scale

        def to_temporal(t: torch.Tensor) -> torch.Tensor:  # (b*f,n,c) -> (b*n,f,c)
            return t.reshape(b, f, n, -1).transpose(1, 2).reshape(b * n, f, -1)

        def to_spatial(t: torch.Tensor) -> torch.Tensor:  # (b*n,f,c) -> (b*f,n,c)
            return t.reshape(b, n, f, -1).transpose(1, 2).reshape(b * f, n, -1)

        kpa, tpa = self.kpattention, self.tpattention
        tokens = kpa.attn.kpa(x.reshape(b * f, n, -1))
        tokens = kpa.tail(tokens, kpa.attn.Spatial_pos_embed, heads, scale)
        tokens = to_temporal(L.layer_norm(self.Spatial_norm, tokens, _EPS))

        tokens = tpa.tail(tpa.attn.tpa(tokens), tpa.attn.Temporal_pos_embed,
                          heads, scale)
        tokens = L.layer_norm(self.Temporal_norm, tokens, _EPS)

        for ste, tte in zip(self.STEblocks, self.TTEblocks):
            tokens = ste(to_spatial(tokens), heads, scale, _EPS)
            tokens = L.layer_norm(self.Spatial_norm, tokens, _EPS)
            tokens = tte(to_temporal(tokens), heads, scale, _EPS)
            tokens = L.layer_norm(self.Temporal_norm, tokens, _EPS)

        out = to_spatial(tokens).reshape(b, f, n, -1)
        out = L.layer_norm(self.head[0], out)
        return L.linear(self.head[1], out).float()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("KTPFormer")
def _build(config) -> KTPFormer:
    cfg = KTPFormerConfig(
        num_frame=config.n_frames, num_joints=config.num_joints,
        in_chans=2, embed_dim=config.dim_feat, depth=config.n_layers,
        num_heads=config.num_heads, mlp_ratio=float(config.mlp_ratio),
        qkv_bias=True, qk_scale=config.qkv_scale)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return KTPFormer(cfg, compute_dtype=dtype)
