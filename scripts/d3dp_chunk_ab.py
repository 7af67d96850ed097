#!/usr/bin/env python3
"""D3DP's sampler with each denoiser pass as one call against the same pass
in chunks of 64 clips (the JAX package's `denoise_chunk`, a workaround for
the TPU's on-chip memory), on the card at full width (-cs 512 -dep 8).

Run on the card from the repository root:

    python3 scripts/d3dp_chunk_ab.py

Builds the kernels (`ops/_build.py`) and the model with seeded weights, then
times `D3DP.sample` in turns (one call, chunked, chunked, one call) for the
served configuration (128 clips, 1 proposal, 1 DDIM step, the flip inside:
one 256-clip pass, four chunks) in f32 and bf16, and for the paper's eval
sampler (8 clips, 20 proposals, 10 steps: ten 320-clip passes, five chunks
each) in f32. A line a case: each order's ms per sample, the peak device
memory of each variant, and the largest difference between their samples.
The chunked variant wraps the denoiser and calls it on 64-clip slices; the
model's own `sample` is the one-call variant.
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.getcwd())

CHUNK = 64


def main() -> int:
    import torch

    import chip_smoke as cs
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.ops import _build

    _build.build_all()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    model = build_model(cs.zoo_config("D3DP"), device=dev,
                        generator=torch.Generator().manual_seed(19))
    denoise = model.pose_estimator.denoise

    def chunked(x2d, x3d, t):
        n = x2d.shape[0]
        if n <= CHUNK or n % CHUNK:
            return denoise(x2d, x3d, t)
        return torch.cat([denoise(x2d[s:s + CHUNK], x3d[s:s + CHUNK], t[s:s + CHUNK])
                          for s in range(0, n, CHUNK)])

    def run(variant, x):
        if variant == "chunked":
            model.pose_estimator.denoise = chunked
        try:
            return model.sample(x, torch.Generator().manual_seed(0))
        finally:
            model.pose_estimator.__dict__.pop("denoise", None)

    base = model.cfg
    cases = (("served", 128, 1, 1, torch.float32, 5),
             ("served", 128, 1, 1, torch.bfloat16, 5),
             ("paper", 8, 20, 10, torch.float32, 2))
    with torch.inference_mode():
        for label, b, h, k, dt, iters in cases:
            model.cfg = dataclasses.replace(base, num_proposals=h,
                                            sampling_timesteps=k)
            model.compute_dtype = dt
            x = cs.clip_batch(torch.Generator().manual_seed(4), b).to(dev)
            peak, out = {}, {}
            for variant in ("one call", "chunked"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                out[variant] = run(variant, x)
                torch.cuda.synchronize()
                peak[variant] = torch.cuda.max_memory_allocated() / 2 ** 30
            diff = (out["one call"].float() - out["chunked"].float()).abs().max().item()
            del out
            ms = {v: [] for v in ("one call", "chunked")}
            for variant in ("one call", "chunked", "chunked", "one call"):
                ms[variant].append(cs.time_ms(lambda: run(variant, x), iters, warmup=1))
            dname = str(dt).split(".")[1]
            print(f"{label} B={b} H={h} K={k} {dname} ({2 * b * h} clips a pass): "
                  f"one call {ms['one call'][0]:.2f} / {ms['one call'][1]:.2f} ms, "
                  f"chunked {ms['chunked'][0]:.2f} / {ms['chunked'][1]:.2f} ms a sample; "
                  f"peak {peak['one call']:.3f} / {peak['chunked']:.3f} GiB; "
                  f"max |one call - chunked| {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
