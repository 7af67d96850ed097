"""DSTFormer (the MotionBERT backbone): dual-stream ST/TS blocks fused by a
per-depth gate. PyTorch port of `kasportsformer_tpu/models/zoo/dstformer.py`
(≙ `model/DSTFormer.py:278-371`), named after the reference state-dict
layout (`blocks_st.{i}.attn_s.qkv`, `ts_attn.{i}`, `pre_logits.fc`, ...).

Tokens live as (B*F, J, C). Each depth runs a spatial-first and a
temporal-first block on the same input and fuses them with a softmax gate
(`ts_attn`, zero weight and 0.5 bias at init). The temporal attention attends
over the frames of each joint: its q, k and v go to the core as the strided
(B, J, F, C) view of the qkv projection, with no copy. Every half block's
attention core goes to K1 and its MLP tail to K3 on CUDA: 4 of each per
depth. Linear weights are trunc-normal(0.02) with zero biases, the position
and frame embeddings trunc-normal(0.02), as in the JAX package
(`DSTFormer.py:323-330`); the frame embedding is cut to the clip length.
In training, given a generator (a train step passes its own), stochastic
depth drops rows of every residual branch at the rates
linspace(0, drop_path_rate, depth), depth i at rate i, as the JAX model does
when given a key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model
from kasportsformer_torch.ops.attention import masked_sdpa


@dataclasses.dataclass(frozen=True)
class DSTFormerConfig:
    dim_in: int = 3
    dim_out: int = 3
    dim_feat: int = 256
    dim_rep: int = 512
    depth: int = 5
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_joints: int = 17
    maxlen: int = 243
    qkv_bias: bool = True
    qk_scale: float | None = None
    att_fuse: bool = True
    drop_path_rate: float = 0.0


def _attn_temporal(attn: L.Attention, x: torch.Tensor, seqlen: int,
                   num_heads: int, qk_scale: float | None) -> torch.Tensor:
    """Temporal MHSA on (B*F, J, C) tokens: attend over F per joint
    (`DSTFormer.py:189-201`)."""
    bf, j, c = x.shape
    b = bf // seqlen
    scale = qk_scale or (c // num_heads) ** -0.5
    q, k, v = L.linear(attn.qkv, x).split(c, dim=-1)

    def grouped(z: torch.Tensor) -> torch.Tensor:  # (B*F, J, C) -> (B, J, F, C)
        return z.reshape(b, seqlen, j, c).transpose(1, 2)

    out = masked_sdpa(grouped(q), grouped(k), grouped(v), scale, num_heads)
    return L.linear(attn.proj, out.transpose(1, 2).reshape(bf, j, c))


class DSTBlock(nn.Module):
    """One stream's spatial and temporal half blocks (`DSTFormer.py:205-275`)."""

    def __init__(self, dim: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        for s in ("s", "t"):
            setattr(self, f"norm1_{s}", nn.LayerNorm(dim))
            setattr(self, f"norm2_{s}", nn.LayerNorm(dim))
            setattr(self, f"attn_{s}", L.Attention(dim, qkv_bias))
            setattr(self, f"mlp_{s}", L.Mlp(dim, hidden))

    def half(self, x: torch.Tensor, which: str, seqlen: int, num_heads: int,
             qk_scale: float | None, rate: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
        h = L.layer_norm(getattr(self, f"norm1_{which}"), x)
        attn = getattr(self, f"attn_{which}")
        if which == "s":
            h = L.attention_tokens(attn, h, num_heads, qk_scale)
        else:
            h = _attn_temporal(attn, h, seqlen, num_heads, qk_scale)
        x = x + L.drop_path(h, rate, generator)
        return L.mlp_ln_residual(getattr(self, f"norm2_{which}"),
                                 getattr(self, f"mlp_{which}"), x, 1e-5, rate,
                                 generator)


class DSTFormer(nn.Module):
    """(B, F, J, dim_in) -> (B, F, J, dim_out)."""

    def __init__(self, cfg: DSTFormerConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or DSTFormerConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        dim = cfg.dim_feat
        self.joints_embed = nn.Linear(cfg.dim_in, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, dim))
        self.temp_embed = nn.Parameter(torch.zeros(1, cfg.maxlen, 1, dim))
        self.blocks_st = nn.ModuleList(
            DSTBlock(dim, cfg.mlp_ratio, cfg.qkv_bias) for _ in range(cfg.depth))
        self.blocks_ts = nn.ModuleList(
            DSTBlock(dim, cfg.mlp_ratio, cfg.qkv_bias) for _ in range(cfg.depth))
        if cfg.att_fuse:
            self.ts_attn = nn.ModuleList(nn.Linear(2 * dim, 2)
                                         for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(dim)
        self.pre_logits = nn.ModuleDict({"fc": nn.Linear(dim, cfg.dim_rep)})
        self.head = nn.Linear(cfg.dim_rep, cfg.dim_out)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from `generator`: trunc-normal(0.02)
        linear weights (cut at two standard deviations) with zero biases, the
        fusion gates at zero weight and 0.5 bias, trunc-normal embeddings and
        unit/zero norms."""

        def trunc_normal(t: torch.Tensor) -> None:
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)

        gates = set(map(id, self.ts_attn)) if self.cfg.att_fuse else set()
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    if id(mod) in gates:
                        mod.weight.zero_()
                        mod.bias.fill_(0.5)
                    else:
                        trunc_normal(mod.weight)
                        mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.reset_parameters()
            trunc_normal(self.pos_embed)
            trunc_normal(self.temp_embed)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        rates = (np.linspace(0, cfg.drop_path_rate, cfg.depth) if self.training
                 else np.zeros(cfg.depth))
        x = x.to(self.compute_dtype)
        dt = x.dtype
        b, f, j, _ = x.shape
        tokens = L.linear(self.joints_embed, x.reshape(b * f, j, -1))
        tokens = tokens + L.cast(self.pos_embed, dt)
        tokens = (tokens.reshape(b, f, j, -1)
                  + L.cast(self.temp_embed, dt)[:, :f]).reshape(b * f, j, -1)

        for i in range(cfg.depth):
            st, ts = self.blocks_st[i], self.blocks_ts[i]

            def half(blk: DSTBlock, t: torch.Tensor, which: str) -> torch.Tensor:
                return blk.half(t, which, f, cfg.num_heads, cfg.qk_scale,
                                float(rates[i]), generator)

            x_st = half(st, half(st, tokens, "s"), "t")
            x_ts = half(ts, half(ts, tokens, "t"), "s")
            if cfg.att_fuse:
                alpha = L.linear(self.ts_attn[i], torch.cat([x_st, x_ts], dim=-1))
                alpha = torch.softmax(L.wide(alpha), dim=-1).to(dt)
                tokens = x_st * alpha[..., 0:1] + x_ts * alpha[..., 1:2]
            else:
                tokens = (x_st + x_ts) * 0.5

        tokens = L.layer_norm(self.norm, tokens)
        out = tokens.reshape(b, f, j, -1)
        out = torch.tanh(L.linear(self.pre_logits["fc"], out))
        return L.linear(self.head, out).float()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("DSTFormer")
def _build(config) -> DSTFormer:
    cfg = DSTFormerConfig(
        dim_in=config.dim_in, dim_out=config.dim_out, dim_feat=config.dim_feat,
        dim_rep=config.dim_rep, depth=config.n_layers,
        num_heads=config.num_heads, mlp_ratio=float(config.mlp_ratio),
        num_joints=config.num_joints, qkv_bias=True, qk_scale=config.qkv_scale,
        drop_path_rate=config.drop_path)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return DSTFormer(cfg, compute_dtype=dtype)
