"""Layer library of the flagship and the zoo: PyTorch port of
`kasportsformer_tpu/models/layers.py`.

Module and parameter names follow the reference torch repository's
state-dict layout (`mixer.qkv`, `mixer.qkv_q` / `qkv_kv`, `mixer.U` / `V`,
`mixer.batch_norm`, `layer_scale_1`, ...), so a reference state_dict loads
with `load_state_dict(strict=True)`.

Parameters stay float32; activations run in the dtype of the input, and each
linear casts its weights to that dtype, as the JAX package does (outside
autograd the cast is made once and kept, see `cast`). LayerNorm and
batch-norm statistics are float32 (float64 in a float64 run, whose
activations and parameters are all float64). The attention core goes to
`ops.attention.masked_sdpa` (kernels K1 and, in the backward, K2 on CUDA),
every FormerModule's and transformer block's MLP tail to
`ops.mlp.fused_mlp_ln` (K3 and K4), and `Mlp.forward(fused=True)` to
`ops.mlp.fused_mlp` (K5).
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
from kasportsformer_torch.ops.mlp import fused_mlp, fused_mlp_ln

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


def wide(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32 for statistics, or as it is when it is float64."""
    return x if x.dtype == torch.float64 else x.float()


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32 (statistics and
    affine) and rounded to the input dtype, as the JAX package does."""
    return F.layer_norm(wide(x), (x.shape[-1],), norm.weight, norm.bias,
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


def reset_conv(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """torch Conv2d's default init, drawn from `generator`:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight and bias, fan_in = c_in*kh*kw."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (`model/modules/mlp.py`, dropout-free as
    every shipped config). The FormerModule and the transformer block run
    these parameters through `fused_mlp_ln` instead (`mlp_tail`,
    `mlp_ln_residual`). `bias=False` gives STCFormer's MLP, whose linears
    have no bias parameters: the fused op gets zero biases, kept as
    non-persistent buffers (out of the state dict, moved with the module)."""

    def __init__(self, dim: int, hidden: int, bias: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, dim, bias=bias)
        if not bias:
            self.register_buffer("zero_b1", torch.zeros(hidden), persistent=False)
            self.register_buffer("zero_b2", torch.zeros(dim), persistent=False)

    def weights(self, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        """(fc1.weight, fc1.bias, fc2.weight, fc2.bias) for a fused op whose
        activations are `dtype`: under autograd the float32 parameters as
        they are, so their gradients arrive in float32 (the op makes its
        copies in the activation dtype); outside it the kept copies of
        `cast`. A bias-free MLP hands the op its zero buffers, as the JAX
        `mlp_ln_residual` hands it zeros."""
        b1, b2 = ((self.fc1.bias, self.fc2.bias) if self.fc1.bias is not None
                  else (self.zero_b1, self.zero_b2))
        ws = (self.fc1.weight, b1, self.fc2.weight, b2)
        if torch.is_grad_enabled():
            return ws
        return tuple(cast(t, dtype) for t in ws)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        """The JAX `layers.mlp`: `fused=True` goes to `fused_mlp` (kernel K5
        on CUDA, its plain version on the CPU), otherwise linear -> GELU ->
        linear op by op."""
        if fused:
            return fused_mlp(x, *self.weights(x.dtype))
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


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


def attention_tokens(attn: Attention, x: torch.Tensor, num_heads: int,
                     qk_scale: float | None = None) -> torch.Tensor:
    """Standard MHSA on a flat token stream (M, N, C), the block of the
    MixSTE/DSTFormer family (`model/MixSTE.py:61-106`), where M batches
    whatever axis is not attended over. The core takes the stream as the
    view (1, M, N, C)."""
    c = x.shape[-1]
    scale = qk_scale or (c // num_heads) ** -0.5
    q, k, v = linear(attn.qkv, x).split(c, dim=-1)
    return linear(attn.proj, masked_sdpa(q, k, v, scale, num_heads))


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


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    """Batch norm over axis 1 of x (N, C, ...), torch semantics, computed in
    float32: the GCN's per-node norm on (N, nodes, C) (BatchNorm1d(num_nodes)
    of `model/modules/graph.py:37`, the node axis in the channel role; the
    JAX `batch_norm_nodes`) and the TCN's per-channel norm on NCHW (the JAX
    `batch_norm_2d`). In training it normalises with the batch statistics
    and updates the running buffers in place (unbiased variance)."""
    xf = wide(x)
    if not train:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, training=False, eps=bn.eps).to(x.dtype)
    dims = (0, *range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = xf.mean(dim=dims)
    var = (xf - mean.view(shape)).square().mean(dim=dims)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1 - bn.momentum).add_(
            bn.momentum * var * (n / max(n - 1, 1)))
    y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
    y = y * bn.weight.view(shape) + bn.bias.view(shape)
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
    s = wide(sim)
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
        out = F.relu(tokens + batch_norm(self.batch_norm, pre, self.training))
        if self.mode == "spatial":
            return out.reshape(b, t, j, c)
        return out.reshape(b, j, t, c).transpose(1, 2)


# ---------------------------------------------------------------- former block


class FormerModule(nn.Module):
    """Pre-LN metaformer block (≙ `model/KASportsFormer.py:65-118`):
    x + LS1 * mixer(LN(x)[, LN_limb(x_limb)]); x + LS2 * MLP(LN(x)).
    `norm1_limb` exists for every mixer type, as in the reference;
    `with_limb_norm=False` gives MotionAGFormer's AGFormerBlock
    (`model/MotionAGFormer.py:14-50`), which has none and also takes the
    "ms-tcn" mixer."""

    def __init__(self, dim: int, mlp_ratio: float, mixer_type: str, mode: str,
                 num_heads: int, qkv_bias: bool, layer_scale_init: float,
                 n_frames: int, use_layer_scale: bool = True,
                 qk_scale: float | None = None, neighbour_num: int = 4,
                 spatial_norm_adj: np.ndarray | None = None,
                 static_temporal_adj: np.ndarray | None = None,
                 with_limb_norm: bool = True):
        super().__init__()
        self.mixer_type = mixer_type
        self.mode = mode
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.use_layer_scale = use_layer_scale
        self.norm1 = nn.LayerNorm(dim)
        if with_limb_norm:
            self.norm1_limb = nn.LayerNorm(dim)
        if mixer_type == "attention":
            self.mixer = Attention(dim, qkv_bias)
        elif mixer_type == "graph":
            self.mixer = GCN(dim, 17 if mode == "spatial" else n_frames, mode,
                             neighbour_num, spatial_norm_adj,
                             static_temporal_adj)
        elif mixer_type == "bone":
            self.mixer = CrossAttention(dim, qkv_bias)
        elif mixer_type == "ms-tcn":
            self.mixer = MultiScaleTCN(dim, dim)
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
        elif self.mixer_type in ("graph", "ms-tcn"):
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
    `fused_mlp_ln` (K3 forward and K4 backward on CUDA)."""
    ls2 = (block.layer_scale_2 if block.use_layer_scale
           else torch.ones_like(block.norm2.weight))
    return fused_mlp_ln(x, block.norm2.weight, block.norm2.bias,
                        *block.mlp.weights(x.dtype), ls2, 1e-5)


def drop_path(branch: torch.Tensor, rate: float,
              generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth, `timm` semantics: each leading row of the residual
    branch is kept with probability 1 - rate and rescaled by 1/(1 - rate).
    Active only with a rate > 0 and a generator. The mask is drawn on the
    CPU from `generator` (a train step's, see `train/loop.py`), so the card
    and the CPU drop the same rows."""
    if rate <= 0.0 or generator is None:
        return branch
    keep = 1.0 - rate
    shape = (branch.shape[0],) + (1,) * (branch.dim() - 1)
    mask = torch.empty(shape).bernoulli_(keep, generator=generator)
    return branch * mask.to(branch.device, branch.dtype) / keep


def mlp_ln_residual(norm: nn.LayerNorm, mlp: Mlp, x: torch.Tensor,
                    eps: float = 1e-5, drop_path_rate: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """x + MLP(LN(x)), the zoo blocks' shared MLP tail: one `fused_mlp_ln`
    call with ls2 = 1 (K3 on CUDA). With stochastic depth active the
    per-sample mask sits between the MLP and the residual add, which the
    fused form cannot express: LN and the unfused MLP, as the JAX package
    does."""
    if drop_path_rate > 0.0 and generator is not None:
        y = mlp(layer_norm(norm, x, eps))
        return x + drop_path(y, drop_path_rate, generator)
    return fused_mlp_ln(x, norm.weight, norm.bias, *mlp.weights(x.dtype),
                        torch.ones_like(norm.weight), eps)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block on (M, N, C) tokens (`model/MixSTE.py:299-342`):
    x + attn(LN(x)); x + MLP(LN(x)), LN eps as given (1e-6 in the MixSTE
    family). Stochastic depth drops rows of both residual branches, the
    attention's mask drawn first, when given a rate and a generator."""

    def __init__(self, dim: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, num_heads: int,
                qk_scale: float | None = None, eps: float = 1e-5,
                drop_path_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = attention_tokens(self.attn, layer_norm(self.norm1, x, eps),
                             num_heads, qk_scale)
        x = x + drop_path(h, drop_path_rate, generator)
        return mlp_ln_residual(self.norm2, self.mlp, x, eps, drop_path_rate,
                               generator)


# ---------------------------------------------------------------- conv / TCN


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """NCHW convolution with the module's stride, padding, dilation and
    groups, its weights cast to the activation dtype."""
    bias = None if conv.bias is None else cast(conv.bias, x.dtype)
    return F.conv2d(x, cast(conv.weight, x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class TemporalConv(nn.Module):
    """Dilated (k, 1) convolution over frames and its batch norm
    (`model/modules/tcn.py`, a branch's index 3)."""

    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        pad = (kernel_size + (kernel_size - 1) * (dilation - 1) - 1) // 2
        self.conv = nn.Conv2d(channels, channels, (kernel_size, 1),
                              padding=(pad, 0), dilation=(dilation, 1))
        self.bn = nn.BatchNorm2d(channels)


class MultiScaleTCN(nn.Module):
    """Multi-branch dilated temporal convolution mixer
    (≙ `model/modules/tcn.py:25-86`) on [B,T,J,C]: one branch per dilation
    [1x1 conv, BN, ReLU, TemporalConv], a max-pool branch [1x1 conv, BN,
    ReLU, (3,1) max-pool, BN] and a 1x1 branch [1x1 conv, BN], channels split
    evenly, identity residual. The reference's Sequential indices are kept,
    so its state_dict keys load as they are."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5,
                 dilations: tuple[int, ...] = (1, 2)):
        super().__init__()
        bc = c_out // (len(dilations) + 2)
        if bc * (len(dilations) + 2) != c_out:
            raise ValueError(f"{c_out} channels do not split over "
                             f"{len(dilations) + 2} branches")
        branches = [nn.Sequential(nn.Conv2d(c_in, bc, 1), nn.BatchNorm2d(bc),
                                  nn.ReLU(), TemporalConv(bc, kernel_size, d))
                    for d in dilations]
        branches.append(nn.Sequential(
            nn.Conv2d(c_in, bc, 1), nn.BatchNorm2d(bc), nn.ReLU(),
            nn.MaxPool2d((3, 1), 1, (1, 0)), nn.BatchNorm2d(bc)))
        branches.append(nn.Sequential(nn.Conv2d(c_in, bc, 1),
                                      nn.BatchNorm2d(bc)))
        self.branches = nn.ModuleList(branches)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = self.training
        xc = x.permute(0, 3, 1, 2)  # NCHW = (B, C, T, J)
        outs = []
        for br in self.branches[:-2]:
            h = F.relu(batch_norm(br[1], conv2d(br[0], xc), train))
            outs.append(batch_norm(br[3].bn, conv2d(br[3].conv, h), train))
        br = self.branches[-2]
        h = F.relu(batch_norm(br[1], conv2d(br[0], xc), train))
        h = F.max_pool2d(h, (3, 1), 1, (1, 0))
        outs.append(batch_norm(br[4], h, train))
        br = self.branches[-1]
        outs.append(batch_norm(br[1], conv2d(br[0], xc), train))
        out = torch.cat(outs, dim=1) + xc
        return out.permute(0, 2, 3, 1)


def adaptive_fusion(fusion: nn.Linear,
                    branches: list[torch.Tensor]) -> torch.Tensor:
    """Softmax-gated convex combination of branch streams
    (≙ `model/KASportsFormer.py:278-284`)."""
    alpha = torch.softmax(linear(fusion, torch.cat(branches, dim=-1)), dim=-1)
    out = branches[0] * alpha[..., 0:1]
    for i, br in enumerate(branches[1:], start=1):
        out = out + br * alpha[..., i : i + 1]
    return out
