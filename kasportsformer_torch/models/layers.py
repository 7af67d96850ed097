"""Layer library of the flagship: PyTorch port of
`kasportsformer_tpu/models/layers.py`.

Module and parameter names follow the reference torch repository's
state-dict layout (`mixer.qkv`, `mixer.qkv_q` / `qkv_kv`, `mixer.U` / `V`,
`mixer.batch_norm`, `layer_scale_1`, ...), so a reference state_dict loads
with `load_state_dict(strict=True)`.

Parameters stay float32; activations run in the dtype of the input, and each
linear casts its weights to that dtype, as the JAX package does (outside
autograd the cast is made once and kept, see `cast`). LayerNorm and
batch-norm statistics are float32. The attention core goes to
`ops.attention.masked_sdpa` (kernels K1 and, in the backward, K2 on CUDA)
and every FormerModule's MLP tail to `ops.mlp.fused_mlp_ln` (K3 and K4).
The dynamic top-k adjacency is a comparison, so no gradient flows through
it, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kasportsformer_torch.ops.attention import masked_sdpa
from kasportsformer_torch.ops.mlp import fused_mlp_ln

# ---------------------------------------------------------------- primitives


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Parameter or buffer `t` in `dtype`. Outside autograd (inference or
    no_grad) the converted copy is kept on `t` and made again only when `t`
    changes: in place (its version counter) or by a move (its storage). So
    a bfloat16 forward converts each float32 weight once, not every call."""
    if t.dtype == dtype:
        return t
    if torch.is_grad_enabled():
        return t.to(dtype)
    key = (dtype, t.data_ptr(), t._version)
    hit = getattr(t, "_kasf_cast", None)
    if hit is None or hit[0] != key:
        hit = (key, t.detach().to(dtype))
        t._kasf_cast = hit
    return hit[1]


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`x W^T + b` with the weights cast to the activation dtype."""
    bias = None if layer.bias is None else cast(layer.bias, x.dtype)
    return F.linear(x, cast(layer.weight, x.dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32 (statistics and
    affine) and rounded to the input dtype, as the JAX package does."""
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight, norm.bias,
                        eps).to(x.dtype)


def reset_linear(layer: nn.Linear, generator: torch.Generator,
                 init: str = "torch") -> None:
    """'torch': U(-1/sqrt(in), 1/sqrt(in)) weight and bias (nn.Linear's
    default); 'gcn': N(0, sqrt(2/in)) weight (reference GCN._init_gcn),
    U(-1/sqrt(in), 1/sqrt(in)) bias; 'zeros': zero weight."""
    fan_in = layer.weight.shape[1]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        if init == "torch":
            layer.weight.uniform_(-bound, bound, generator=generator)
        elif init == "gcn":
            layer.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                 generator=generator)
        elif init == "zeros":
            layer.weight.zero_()
        else:
            raise ValueError(init)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)


class Mlp(nn.Module):
    """The parameters of fc1 -> GELU -> fc2 (`model/modules/mlp.py`); the
    FormerModule runs them through `mlp_tail`."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


# ---------------------------------------------------------------- attention


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          axis: str, num_heads: int) -> torch.Tensor:
    """Factored attention on (B, T, J, C) streams: 'spatial' attends over J
    per (B, T); 'temporal' over T per (B, J). The temporal operands go to the
    core as permuted views, with no copy."""
    if axis == "spatial":
        return masked_sdpa(q, k, v, scale, num_heads)
    if axis == "temporal":
        out = masked_sdpa(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), scale, num_heads)
        return out.transpose(1, 2)
    raise ValueError(axis)


class Attention(nn.Module):
    """Self-attention on [B,T,J,C] (≙ `model/modules/selfattention.py`)."""

    def __init__(self, dim: int, qkv_bias: bool = False):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, num_heads: int, mode: str,
                qk_scale: float | None = None) -> torch.Tensor:
        c = x.shape[-1]
        scale = qk_scale or (c // num_heads) ** -0.5
        q, k, v = linear(self.qkv, x).split(c, dim=-1)
        return linear(self.proj, _sdpa(q, k, v, scale, mode, num_heads))


class CrossAttention(nn.Module):
    """Q from one stream, K/V from another
    (≙ `model/modules/bone_crossattention.py`)."""

    def __init__(self, dim: int, qkv_bias: bool = False):
        super().__init__()
        self.qkv_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.qkv_kv = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, x_kv: torch.Tensor, num_heads: int,
                mode: str, qk_scale: float | None = None) -> torch.Tensor:
        c = x.shape[-1]
        scale = qk_scale or (c // num_heads) ** -0.5
        q = linear(self.qkv_q, x)
        k, v = linear(self.qkv_kv, x_kv).split(c, dim=-1)
        return linear(self.proj, _sdpa(q, k, v, scale, mode, num_heads))


# ---------------------------------------------------------------- GCN


def batch_norm_nodes(bn: nn.BatchNorm1d, x: torch.Tensor,
                     train: bool) -> torch.Tensor:
    """Per-node batch norm on (N, nodes, C): statistics over the (N, C) axes
    per node, torch BatchNorm1d(num_nodes) semantics from
    `model/modules/graph.py:37`, where the node axis plays the channel role.
    Computed in float32. In training it normalises with the batch statistics
    and updates the running buffers in place (unbiased variance)."""
    xf = x.float()
    if not train:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, training=False, eps=bn.eps).to(x.dtype)
    mean = xf.mean(dim=(0, 2))
    var = (xf - mean[None, :, None]).square().mean(dim=(0, 2))
    n = x.shape[0] * x.shape[2]
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1 - bn.momentum).add_(
            bn.momentum * var * (n / max(n - 1, 1)))
    y = (xf - mean[None, :, None]) * torch.rsqrt(var[None, :, None] + bn.eps)
    y = y * bn.weight[None, :, None] + bn.bias[None, :, None]
    return y.to(x.dtype)


def temporal_adjacency(n_frames: int, connection_len: int = 1) -> np.ndarray:
    """Static temporal adjacency: frame i connects to itself and the next
    `connection_len` frames (no wraparound), the banded matrix of
    `model/modules/graph.py:63-75`."""
    adj = np.zeros((n_frames, n_frames), np.float32)
    for i in range(n_frames):
        adj[i, i : min(i + connection_len + 1, n_frames)] = 1.0
    return adj


def normalize_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """D^-1/2 A D^-1/2 where both D factors use the *row* degree, with the
    broadcasting of `model/modules/graph.py:77-90`."""
    dinv = adj.sum(-1) ** -0.5
    return adj * dinv[..., :, None] * dinv[..., None, :]


def topk_adjacency(tokens: torch.Tensor, neighbour_num: int) -> torch.Tensor:
    """Dynamic temporal adjacency of (N, T, C) tokens: frame t links to every
    frame whose feature similarity reaches the k-th largest of row t. The k-th
    largest comes from k-1 rounds of "drop the row max", as in the JAX package
    (`layers.py:437-447`): on exact ties it admits every tied value, which
    `torch.topk` would not."""
    sim = torch.matmul(tokens, tokens.transpose(-1, -2))
    s = sim.float()
    for _ in range(neighbour_num - 1):
        m = s.amax(-1, keepdim=True)
        s = torch.where(s >= m, float("-inf"), s)
    kth = s.amax(-1, keepdim=True).to(sim.dtype)
    return (sim >= kth).to(tokens.dtype)


class GCN(nn.Module):
    """Graph mixer on [B,T,J,C] (≙ `model/modules/graph.py:99-134`):
    relu(x + BN(norm_adj @ V(x) + U(x))).

    spatial: the fixed skeleton adjacency, normalised once (`spatial_norm_adj`).
    temporal: a top-k feature-similarity adjacency per (batch, joint)
    sequence, or the static banded one when `static_temporal_adj` is given."""

    def __init__(self, dim: int, num_nodes: int, mode: str,
                 neighbour_num: int = 4,
                 spatial_norm_adj: np.ndarray | None = None,
                 static_temporal_adj: np.ndarray | None = None):
        super().__init__()
        if mode not in ("spatial", "temporal"):
            raise ValueError(mode)
        self.mode = mode
        self.neighbour_num = neighbour_num
        self.U = nn.Linear(dim, dim)
        self.V = nn.Linear(dim, dim)
        self.batch_norm = nn.BatchNorm1d(num_nodes)
        fixed = None
        if mode == "spatial":
            fixed = torch.as_tensor(spatial_norm_adj)
        elif static_temporal_adj is not None:
            fixed = normalize_adjacency(torch.as_tensor(static_temporal_adj))
        # constant, not a parameter: kept out of the state_dict
        self.register_buffer("norm_adj", fixed, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, j, c = x.shape
        if self.mode == "spatial":
            tokens = x.reshape(b * t, j, c)  # nodes = joints
        else:
            tokens = x.transpose(1, 2).reshape(b * j, t, c)  # nodes = frames
        if self.norm_adj is not None:
            norm_adj = cast(self.norm_adj, x.dtype)
        else:
            norm_adj = normalize_adjacency(
                topk_adjacency(tokens, self.neighbour_num))
        agg = torch.matmul(norm_adj, linear(self.V, tokens))
        pre = agg + linear(self.U, tokens)
        out = F.relu(tokens + batch_norm_nodes(self.batch_norm, pre,
                                               self.training))
        if self.mode == "spatial":
            return out.reshape(b, t, j, c)
        return out.reshape(b, j, t, c).transpose(1, 2)


# ---------------------------------------------------------------- former block


class FormerModule(nn.Module):
    """Pre-LN metaformer block (≙ `model/KASportsFormer.py:65-118`):
    x + LS1 * mixer(LN(x)[, LN_limb(x_limb)]); x + LS2 * MLP(LN(x)).
    `norm1_limb` exists for every mixer type, as in the reference."""

    def __init__(self, dim: int, mlp_ratio: float, mixer_type: str, mode: str,
                 num_heads: int, qkv_bias: bool, layer_scale_init: float,
                 n_frames: int, use_layer_scale: bool = True,
                 qk_scale: float | None = None, neighbour_num: int = 4,
                 spatial_norm_adj: np.ndarray | None = None,
                 static_temporal_adj: np.ndarray | None = None):
        super().__init__()
        self.mixer_type = mixer_type
        self.mode = mode
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.use_layer_scale = use_layer_scale
        self.norm1 = nn.LayerNorm(dim)
        self.norm1_limb = nn.LayerNorm(dim)
        if mixer_type == "attention":
            self.mixer = Attention(dim, qkv_bias)
        elif mixer_type == "graph":
            self.mixer = GCN(dim, 17 if mode == "spatial" else n_frames, mode,
                             neighbour_num, spatial_norm_adj,
                             static_temporal_adj)
        elif mixer_type == "bone":
            self.mixer = CrossAttention(dim, qkv_bias)
        else:
            raise ValueError(mixer_type)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if use_layer_scale:
            self.layer_scale_1 = nn.Parameter(
                layer_scale_init * torch.ones(dim))
            self.layer_scale_2 = nn.Parameter(
                layer_scale_init * torch.ones(dim))

    def forward(self, x: torch.Tensor,
                x_limb: torch.Tensor | None = None) -> torch.Tensor:
        h = layer_norm(self.norm1, x)
        if self.mixer_type == "attention":
            mixed = self.mixer(h, self.num_heads, self.mode, self.qk_scale)
        elif self.mixer_type == "graph":
            mixed = self.mixer(h)
        else:
            h_limb = layer_norm(self.norm1_limb, x_limb)
            mixed = self.mixer(h, h_limb, self.num_heads, self.mode,
                               self.qk_scale)
        if self.use_layer_scale:
            x = torch.addcmul(x, cast(self.layer_scale_1, x.dtype), mixed)
        else:
            x = x + mixed
        return mlp_tail(self, x)


def mlp_tail(block: FormerModule, x: torch.Tensor) -> torch.Tensor:
    """The FormerModule MLP tail x + [ls2 *] MLP(LN_norm2(x)), in one call of
    `fused_mlp_ln` (K3 forward and K4 backward on CUDA). Under autograd the
    float32 parameters go in as they are, so their gradients arrive in
    float32 (the op makes its copies in the activation dtype); outside it
    the kept copies of `cast` go in."""
    ls2 = (block.layer_scale_2 if block.use_layer_scale
           else torch.ones_like(block.norm2.weight))
    fc1, fc2, dt = block.mlp.fc1, block.mlp.fc2, x.dtype
    weights = (fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    if not torch.is_grad_enabled():
        weights = tuple(cast(t, dt) for t in weights)
    return fused_mlp_ln(x, block.norm2.weight, block.norm2.bias, *weights,
                        ls2, 1e-5)


def adaptive_fusion(fusion: nn.Linear,
                    branches: list[torch.Tensor]) -> torch.Tensor:
    """Softmax-gated convex combination of branch streams
    (≙ `model/KASportsFormer.py:278-284`)."""
    alpha = torch.softmax(linear(fusion, torch.cat(branches, dim=-1)), dim=-1)
    out = branches[0] * alpha[..., 0:1]
    for i, br in enumerate(branches[1:], start=1):
        out = out + br * alpha[..., i : i + 1]
    return out
