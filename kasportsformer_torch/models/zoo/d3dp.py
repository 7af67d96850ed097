"""D3DP (DiffusionPose), diffusion-based 3D pose lifting: PyTorch port of
`kasportsformer_tpu/models/zoo/d3dp.py` (≙ `model/diffusionpose.py`), named
after the reference state-dict layout (the denoiser under `pose_estimator.`,
its time MLP's linears `time_mlp.1` and `time_mlp.3`).

A time-conditioned MixSTE2 denoiser (2D pose and noisy 3D pose -> clean 3D
pose; a sinusoidal timestep embedding through a 2-layer MLP) inside a
cosine-schedule DDIM sampler:

* `sample` runs `sampling_timesteps` DDIM steps over `num_proposals`
  parallel hypotheses, the flip-TTA inside each denoiser call (one call on
  the stacked normal and mirrored batch), and returns every step's x_start,
  (B, steps, H, F, 17, 3); `forward` is `sample`, as the JAX model's eval
  `apply` is;
* `eval_predict` is the eval protocol's forward: the proposals' mean at the
  last step, (B, F, 17, 3). `train.evaluator.tta_forward`, and with it
  `LiftService` and `evaluate`, call it in place of their own flip-TTA;
* `train_predict` is the train forward (the JAX model's `apply(train=True)`):
  the target noised at a drawn timestep by `q_sample`, then denoised, (B,
  F, 17, 3). `train.loop.make_grads_fn` calls it in place of the forward,
  so the standard loss against the target is D3DP's training objective.

The schedule is float64 numpy, as in the reference: `q_sample` gathers it as
float32 tables, the DDIM update uses it as Python floats. The sampler's
noise is drawn on the CPU from a `torch.Generator` (seed 0 unless one is
given, as the JAX model's default key), and so are the train forward's
timesteps and noise (from torch's default generator unless one is given);
both are copied to the device through pinned memory, so the card and the
CPU draw the same numbers and the copy does not stall the card's queue.
Each denoiser pass is one call on the
whole stacked batch: the JAX package's `denoise_chunk`, 64-clip chunks that
fit the TPU's on-chip memory, is not ported, as one call ran 4-10 % faster
on an H100 for about 3x the peak memory (`scripts/d3dp_chunk_ab.py`). A
block's attention core goes to K1 and its MLP tail to K3 on CUDA, 2 * depth
of each per pass. The frequencies of the time embedding are a non-persistent
buffer (`pose_estimator.time_mlp.0.freqs`): `torch.exp` and `jnp.exp` differ
by an ulp on some of them, and a caller may load another table.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kasportsformer_torch.models import layers as L
from kasportsformer_torch.models.registry import register_model
from kasportsformer_torch.models.zoo.mixste import MixSTE, MixSTEConfig
from kasportsformer_torch.utils.common import joint_flip


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """(`diffusionpose.py:333-345`), float64 like the reference."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


@dataclasses.dataclass(frozen=True)
class D3DPConfig:
    num_frame: int = 27
    num_joints: int = 17
    in_chans: int = 2
    embed_dim: int = 512  # args.cs
    depth: int = 8  # args.dep
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    timesteps: int = 1000  # args.timestep
    sampling_timesteps: int = 1
    num_proposals: int = 1
    scale: float = 1.0  # args.scale
    flip_tta: bool = True  # args.test_time_augmentation


class SinusoidalPositionEmbeddings(nn.Module):
    """(B,) timesteps -> (B, dim): [sin(t f), cos(t f)] with the frequencies
    exp(-i log(10000) / (dim/2 - 1)) (`diffusionpose.py:130-142`)."""

    def __init__(self, dim: int):
        super().__init__()
        half = dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                          * (-math.log(10000.0) / (half - 1)))
        self.register_buffer("freqs", freqs, persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.to(self.freqs.dtype)[:, None] * self.freqs[None, :]
        return torch.cat([args.sin(), args.cos()], dim=-1)


class Denoiser(MixSTE):
    """MixSTE2 of `diffusionpose.py:145-298`: MixSTE over the 2D pose and
    the noisy 3D pose (5 channels), its spatial tokens offset by the time
    embedding. The time MLP runs in the frequencies' dtype (float32, or
    float64 in a float64 copy), as the JAX package runs it outside the
    compute dtype."""

    def __init__(self, cfg: D3DPConfig, compute_dtype: torch.dtype):
        super().__init__(MixSTEConfig(
            num_frame=cfg.num_frame, num_joints=cfg.num_joints,
            in_chans=cfg.in_chans + 3, embed_dim=cfg.embed_dim,
            depth=cfg.depth, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale, drop_path_rate=0.0),
            compute_dtype)
        dim = cfg.embed_dim
        self.time_mlp = nn.Sequential(SinusoidalPositionEmbeddings(dim),
                                      nn.Linear(dim, dim * 2), nn.GELU(),
                                      nn.Linear(dim * 2, dim))

    def denoise(self, x_2d: torch.Tensor, x_3d: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """(B,F,N,2) + (B,F,N,3) + (B,) -> (B,F,N,3) in float32."""
        b, f, n, _ = x_2d.shape
        x = torch.cat([x_2d, x_3d], dim=-1).to(self.compute_dtype)
        dt = x.dtype
        tokens = L.linear(self.Spatial_patch_to_embedding, x.reshape(b * f, n, -1))
        tokens = tokens + L.cast(self.Spatial_pos_embed, dt)
        mlp = self.time_mlp
        emb = mlp[0](t)
        emb = L.linear(mlp[3], F.gelu(L.linear(mlp[1], emb)))
        # b-major, as jnp.repeat(t_emb[:, None], f, axis=0): clip i's f frames
        tokens = tokens + emb[:, None, :].repeat_interleave(f, dim=0).to(dt)
        return self.trunk(tokens, b, f)


def on_device(draw: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A CPU draw on `dev`; to a card through pinned memory, so the copy
    does not wait for the work queued before it."""
    if dev.type == "cuda" and draw.device.type == "cpu":
        return draw.pin_memory().to(dev, non_blocking=True)
    return draw.to(dev)


class D3DP(nn.Module):
    """(B, F, J, >=2) -> the DDIM sampler's x_start of every step,
    (B, steps, H, F, J, 3); `eval_predict` gives (B, F, J, 3)."""

    def __init__(self, cfg: D3DPConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = cfg or D3DPConfig()
        self.cfg = cfg
        self.pose_estimator = Denoiser(cfg, compute_dtype)
        ac = np.cumprod(1.0 - cosine_beta_schedule(cfg.timesteps))
        self.alphas_cumprod = ac
        self.sqrt_alphas_cumprod = np.sqrt(ac)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - ac)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / ac)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / ac - 1.0)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.pose_estimator.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: torch.dtype) -> None:
        self.pose_estimator.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: MixSTE's (torch defaults for linears, the
        time MLP's too, zero position embeddings, unit/zero norms)."""
        self.pose_estimator.reset_parameters(generator)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The forward diffusion at timesteps t (B,), the schedule gathered
        as float32 tables."""
        def table(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=x_start.device)[t]

        shape = (-1,) + (1,) * (x_start.dim() - 1)
        return (table(self.sqrt_alphas_cumprod).reshape(shape) * x_start
                + table(self.sqrt_one_minus_alphas_cumprod).reshape(shape) * noise)

    def sample(self, x_2d: torch.Tensor,
               generator: torch.Generator | None = None,
               noise: Iterable[torch.Tensor] | None = None) -> torch.Tensor:
        """DDIM sampling with proposals and the fused flip-TTA
        (`diffusionpose.py:507-548`): (B, steps, H, F, N, 3). The draws (the
        initial pose, then one a step but the last) come from `noise` when
        given, else from `generator` on the CPU (seed 0 when None)."""
        cfg = self.cfg
        dev = x_2d.device
        b, f, n, _ = x_2d.shape
        h = cfg.num_proposals
        if noise is None:
            gen = generator or torch.Generator().manual_seed(0)

            def draws():
                while True:
                    yield torch.randn((b, h, f, n, 3), generator=gen)

            noise = draws()
        noise = iter(noise)
        x_2d = x_2d[..., : cfg.in_chans]
        x2d_rep = x_2d[:, None].expand(b, h, f, n, cfg.in_chans).reshape(
            b * h, f, n, cfg.in_chans)
        if cfg.flip_tta:
            x2d_both = torch.cat([x2d_rep, joint_flip(x2d_rep)])

        times = np.linspace(-1, cfg.timesteps - 1, cfg.sampling_timesteps + 1)
        times = list(reversed(times.astype(int).tolist()))
        lim = 1.1 * cfg.scale
        img = on_device(next(noise).to(torch.float32), dev)
        preds = []
        for time, time_next in zip(times[:-1], times[1:]):
            t = torch.full((b * h,), time, dtype=torch.long, device=dev)
            x_t = (img.clamp(-lim, lim) / cfg.scale).reshape(b * h, f, n, 3)
            if cfg.flip_tta:
                both = self.pose_estimator.denoise(
                    x2d_both, torch.cat([x_t, joint_flip(x_t)]), torch.cat([t, t]))
                pred = (both[: b * h] + joint_flip(both[b * h:])) / 2
            else:
                pred = self.pose_estimator.denoise(x2d_rep, x_t, t)
            x_start = (pred.reshape(b, h, f, n, 3) * cfg.scale).clamp(-lim, lim)
            preds.append(x_start)
            if time_next < 0:
                img = x_start
                continue
            # pred_noise from x_start (`diffusionpose.py:424-428`)
            sr = float(self.sqrt_recip_alphas_cumprod[time])
            srm1 = float(self.sqrt_recipm1_alphas_cumprod[time])
            pred_noise = (sr * img - x_start) / srm1
            alpha = float(self.alphas_cumprod[time])
            alpha_next = float(self.alphas_cumprod[time_next])
            sigma = math.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                              / (1 - alpha))
            c = math.sqrt(1 - alpha_next - sigma ** 2)
            img = (x_start * math.sqrt(alpha_next) + c * pred_noise
                   + sigma * on_device(next(noise).to(torch.float32), dev))
        return torch.stack(preds, dim=1)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.sample(x, generator)

    def train_predict(self, x: torch.Tensor, y: torch.Tensor,
                      generator: torch.Generator | None = None,
                      t: torch.Tensor | None = None,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
        """The train forward (`diffusionpose.py:565-581`, the JAX model's
        `apply(train=True)`): the clean target y (B, F, N, 3) noised at
        timesteps t (B,) drawn uniformly from [0, timesteps) by `q_sample`
        with standard normal noise of y's shape, clipped to +-1.1 scale and
        divided by scale, then denoised with x's first `in_chans` channels:
        (B, F, N, 3). t and noise come from the caller when both are given
        (the tests inject the JAX package's draws), else from `generator`
        on the CPU (torch's default generator when None), t first, and are
        moved to x's device."""
        cfg = self.cfg
        dev = x.device
        if t is None or noise is None:
            t = torch.randint(0, cfg.timesteps, (x.shape[0],), generator=generator)
            noise = torch.randn(y.shape, generator=generator)
        t = on_device(t.to(torch.long), dev)
        noise = on_device(noise.to(torch.float32), dev)
        lim = 1.1 * cfg.scale
        x_t = self.q_sample(y.to(torch.float32) * cfg.scale, t, noise)
        x_t = x_t.clamp(-lim, lim) / cfg.scale
        return self.pose_estimator.denoise(x[..., : cfg.in_chans], x_t, t)

    def eval_predict(self, x: torch.Tensor) -> torch.Tensor:
        """The eval forward: DDIM-sample (flip-TTA inside the sampler when
        configured) and average the proposals of the last step."""
        return self.sample(x)[:, -1].mean(dim=1)

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("D3DP")
def _build(config) -> D3DP:
    cfg = D3DPConfig(
        num_frame=config.n_frames, num_joints=config.num_joints,
        embed_dim=config.dim_feat, depth=config.n_layers,
        num_heads=config.num_heads, mlp_ratio=float(config.mlp_ratio),
        flip_tta=config.flip)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return D3DP(cfg, compute_dtype=dtype)
