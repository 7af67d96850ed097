"""MixSTE, the alternating seq-to-seq spatial/temporal transformer: PyTorch
port of `kasportsformer_tpu/models/zoo/mixste.py` (≙ `model/MixSTE.py:405-567`,
class MixSTE2), named after the reference state-dict layout
(`STEblocks.{i}`, `TTEblocks.{i}`, `Spatial_norm`, `head.0`, ...).

Flow: spatial block 0 over the joints of each frame -> Spatial_norm ->
temporal block 0 over the frames of each joint (+ temporal position
embedding) -> Temporal_norm -> depth-1 alternating spatial/temporal pairs,
each followed by the same shared Spatial_norm / Temporal_norm -> LayerNorm +
Linear head. LayerNorm eps is 1e-6 (the head's 1e-5), qkv bias on. Every
block's attention core goes to K1 and its MLP tail to K3 on CUDA: 2*depth of
each per forward. In training, given a generator (a train step passes its
own), stochastic depth drops rows of each block's residual branches at the
rates linspace(0, drop_path_rate, depth), pair i at rate i, as the JAX model
does when given a key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MixSTEConfig:
    num_frame: int = 27
    num_joints: int = 17
    in_chans: int = 2
    embed_dim: int = 512  # embed_dim_ratio
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    drop_path_rate: float = 0.2
    dim_out: int = 3


class MixSTE(nn.Module):
    """(B, F, J, >=in_chans) -> (B, F, J, 3)."""

    def __init__(self, cfg: MixSTEConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or MixSTEConfig()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        dim = cfg.embed_dim
        self.Spatial_patch_to_embedding = nn.Linear(cfg.in_chans, dim)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, dim))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_frame, dim))
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
        """The JAX package's init, drawn from `generator`: torch defaults for
        linears, zero position embeddings, unit/zero norms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                L.reset_linear(mod, generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
        with torch.no_grad():
            self.Spatial_pos_embed.zero_()
            self.Temporal_pos_embed.zero_()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x[..., : self.cfg.in_chans].to(self.compute_dtype)
        b, f, n, _ = x.shape
        tokens = L.linear(self.Spatial_patch_to_embedding, x.reshape(b * f, n, -1))
        tokens = tokens + L.cast(self.Spatial_pos_embed, x.dtype)
        return self.trunk(tokens, b, f, generator)

    def trunk(self, tokens: torch.Tensor, b: int, f: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """The blocks and the head on the embedded spatial tokens
        (b*f, n, c): (b, f, n, dim_out) in float32."""
        cfg = self.cfg
        n, dt = tokens.shape[1], tokens.dtype
        rates = (np.linspace(0, cfg.drop_path_rate, cfg.depth) if self.training
                 else np.zeros(cfg.depth))

        def block(blk: L.TransformerBlock, tokens: torch.Tensor,
                  i: int) -> torch.Tensor:
            return blk(tokens, cfg.num_heads, cfg.qk_scale, _EPS,
                       float(rates[i]), generator)

        def to_temporal(t: torch.Tensor) -> torch.Tensor:  # (b*f,n,c) -> (b*n,f,c)
            return t.reshape(b, f, n, -1).transpose(1, 2).reshape(b * n, f, -1)

        def to_spatial(t: torch.Tensor) -> torch.Tensor:  # (b*n,f,c) -> (b*f,n,c)
            return t.reshape(b, n, f, -1).transpose(1, 2).reshape(b * f, n, -1)

        tokens = block(self.STEblocks[0], tokens, 0)
        tokens = L.layer_norm(self.Spatial_norm, tokens, _EPS)

        tokens = to_temporal(tokens) + L.cast(self.Temporal_pos_embed, dt)
        tokens = block(self.TTEblocks[0], tokens, 0)
        tokens = L.layer_norm(self.Temporal_norm, tokens, _EPS)

        for i in range(1, cfg.depth):
            tokens = block(self.STEblocks[i], to_spatial(tokens), i)
            tokens = L.layer_norm(self.Spatial_norm, tokens, _EPS)
            tokens = block(self.TTEblocks[i], to_temporal(tokens), i)
            tokens = L.layer_norm(self.Temporal_norm, tokens, _EPS)

        out = to_spatial(tokens).reshape(b, f, n, -1)
        out = L.layer_norm(self.head[0], out)
        return L.linear(self.head[1], out).float()

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("MixSTE")
def _build(config) -> MixSTE:
    cfg = MixSTEConfig(
        num_frame=config.n_frames, num_joints=config.num_joints,
        in_chans=config.dim_in if config.dim_in in (2, 3) else 2,
        embed_dim=config.dim_feat, depth=config.n_layers,
        num_heads=config.num_heads, mlp_ratio=float(config.mlp_ratio),
        qkv_bias=True, qk_scale=config.qkv_scale,
        drop_path_rate=config.drop_path)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return MixSTE(cfg, compute_dtype=dtype)
