"""STCFormer, the channel-split spatio-temporal criss-cross transformer:
PyTorch port of `kasportsformer_tpu/models/zoo/stcformer.py`
(≙ `model/STCFormer.py`), named after the reference state-dict layout
(`pose_emb`, `stcformer.stc_block.{i}.stc_att.qkv`, `.layer_norm`,
`.mlp.fc1`, `regress_head`, ...).

Each block splits the channels in half: the first half attends over the
joints of each frame, the second over the frames of each joint. Both halves
get a depthwise 3x3 convolution of their values (sep2) and a shared
body-part embedding (sep1), then concatenation, projection and the residual,
followed by a pre-LN MLP residual without biases. As in the reference:

* the qkv projection interleaves q, k and v along the last axis (stride-3
  columns, `reshape(..., c, 3)`), not in thirds;
* the scale is the half-channel width's, (c // 2) ** -0.5, not a head's;
* the part embedding enters scaled by 1e-4 (spatial half) and 1e-9
  (temporal half);
* the pose embedding and the head are bias-free linears, the pose embedding
  followed by exact GELU; the input's first 2 channels are used.

The split attention is batched matmuls and a softmax, outside any kernel,
as in the JAX package. The MLP tail goes to K3 on CUDA (zero biases, LN eps
1e-5): one launch a block, none of K1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model

# body-part id of each joint (`STCFormer.py:60`)
PART_IDS = np.array([0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 3, 3, 3, 4, 4, 4])


@dataclasses.dataclass(frozen=True)
class STCFormerConfig:
    """The JAX config's fields that shape the model: its frame and joint
    counts shape nothing (the 17 joints are `PART_IDS`'s), and the MLP is 4x
    wide whatever its `mlp_ratio` says, as in the reference."""

    n_layers: int = 6
    d_hid: int = 256
    num_heads: int = 8
    dim_out: int = 3


class STCAttention(nn.Module):
    """x + proj([spatial half | temporal half]) on (B, T, S, C)
    (`STCFormer.py:40-125`)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        half = dim // 2
        self.num_heads = num_heads
        self.layer_norm = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.sep2_s = nn.Conv2d(half, half, 3, padding=1, groups=half)
        self.sep2_t = nn.Conv2d(half, half, 3, padding=1, groups=half)
        self.emb = nn.Embedding(5, half // num_heads)
        self.register_buffer("part_ids", torch.as_tensor(PART_IDS),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, s, c = x.shape
        h, half = self.num_heads, c // 2
        d = half // h
        dt = x.dtype
        qkv = L.linear(self.qkv, L.layer_norm(self.layer_norm, x))
        q, k, v = qkv.reshape(b, t, s, c, 3).unbind(-1)
        scale = half ** -0.5

        def heads_s(z: torch.Tensor) -> torch.Tensor:  # -> (b, h, t, s, d)
            return z.reshape(b, t, s, h, d).permute(0, 3, 1, 2, 4)

        def heads_t(z: torch.Tensor) -> torch.Tensor:  # -> (b, h, s, t, d)
            return z.reshape(b, t, s, h, d).permute(0, 3, 2, 1, 4)

        def softmax(a: torch.Tensor) -> torch.Tensor:
            return torch.softmax(L.wide(a), dim=-1).to(dt)

        q_s, q_t = q[..., :half], q[..., half:]
        k_s, k_t = k[..., :half], k[..., half:]
        v_s, v_t = v[..., :half], v[..., half:]
        att_s = softmax(heads_s(q_s) @ heads_s(k_s).transpose(-1, -2) * scale)
        att_t = softmax(heads_t(q_t) @ heads_t(k_t).transpose(-1, -2) * scale)

        # sep2: depthwise convolutions of the values as (b, half, t, s)
        sep2_s = L.conv2d(self.sep2_s, v_s.permute(0, 3, 1, 2))
        sep2_t = L.conv2d(self.sep2_t, v_t.permute(0, 3, 1, 2))
        sep2_s = sep2_s.reshape(b, h, d, t, s).permute(0, 1, 3, 4, 2)
        sep2_t = sep2_t.reshape(b, h, d, t, s).permute(0, 1, 4, 3, 2)
        # sep1: the part embedding of each joint, (s, d)
        sep = L.cast(self.emb.weight, dt)[self.part_ids]

        x_s = att_s @ heads_s(v_s) + sep2_s + 1e-4 * sep  # (b, h, t, s, d)
        x_t = att_t @ heads_t(v_t) + sep2_t  # (b, h, s, t, d)
        x_t = x_t.transpose(2, 3) + 1e-9 * sep
        out = torch.cat([x_s, x_t], dim=-1).permute(0, 2, 3, 1, 4)
        return L.linear(self.proj, out.reshape(b, t, s, c)) + x


class STCBlock(nn.Module):
    """The STC attention, then x + MLP(LN(x)) (`STCFormer.py:128-150`)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.stc_att = STCAttention(dim, num_heads)
        self.layer_norm = nn.LayerNorm(dim)
        self.mlp = L.Mlp(dim, dim * 4, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.mlp_ln_residual(self.layer_norm, self.mlp, self.stc_att(x))


class STCStack(nn.Module):
    """The reference's `stcformer` container of blocks."""

    def __init__(self, cfg: STCFormerConfig):
        super().__init__()
        self.stc_block = nn.ModuleList(STCBlock(cfg.d_hid, cfg.num_heads)
                                       for _ in range(cfg.n_layers))


class STCFormer(nn.Module):
    """(B, F, J, >=2) -> (B, F, J, dim_out)."""

    def __init__(self, cfg: STCFormerConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or STCFormerConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.pose_emb = nn.Linear(2, cfg.d_hid, bias=False)
        self.stcformer = STCStack(cfg)
        self.regress_head = nn.Linear(cfg.d_hid, cfg.dim_out, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from `generator`: torch defaults for
        linears and the depthwise convolutions (U(+-1/3)), a standard normal
        part embedding, unit/zero norms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                L.reset_linear(mod, generator)
            elif isinstance(mod, nn.Conv2d):
                L.reset_conv(mod, generator)
            elif isinstance(mod, nn.Embedding):
                with torch.no_grad():
                    mod.weight.normal_(generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[..., :2].to(self.compute_dtype)
        x = F.gelu(L.linear(self.pose_emb, x))
        for blk in self.stcformer.stc_block:
            x = blk(x)
        return L.linear(self.regress_head, x).float()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("STCFormer")
def _build(config) -> STCFormer:
    cfg = STCFormerConfig(
        n_layers=config.n_layers, d_hid=config.dim_feat,
        num_heads=config.num_heads, dim_out=config.dim_out)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return STCFormer(cfg, compute_dtype=dtype)
