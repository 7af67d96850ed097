#!/usr/bin/env python3
"""Reruns of K1-K4 at the shapes the zoo and the flagship give them, each
compared bit for bit with the kernel's first result.

Run on the card from the repository root:

    python3 scripts/k_rerun_stress.py [--reruns 1000]

Builds the kernels (`ops/_build.py`), then for both dtypes: K2 (backward)
and K1 (forward) on `chip_smoke.zoo_sdpa_views` (heads of 8, 32 and 64) and
the flagship's (B, 27, 17, 128) over 8 heads, at batch 32 and 4, each
`--reruns` times; K4 (backward) and K3 (forward) at C/H 64/256, 128/512,
256/1024 and 512/1024, M = 14,688, 1,377, 1,836 and 459, half as many times.
A line a shape: the first result's largest error against the plain version
(K4's over each gradient's largest entry) and the reruns that were not
bitwise equal. Exits 1 if any rerun differed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reruns", type=int, default=1000)
    reruns = parser.parse_args().reruns

    import torch

    import chip_smoke as cs
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import (LIMITS, masked_sdpa, masked_sdpa_bwd,
                                                    masked_sdpa_bwd_reference)
    from kasportsformer_torch.ops.mlp import (fused_mlp_ln, fused_mlp_ln_bwd,
                                              fused_mlp_ln_bwd_reference)

    _build.build_all()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    unequal = 0
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):
        for b in (32, 4):
            views = cs.zoo_sdpa_views(dev, gen, dt, b)
            views["flagship D=16"] = (tuple(torch.randn(
                b, 27, 17, 384, device=dev, generator=gen).to(dt).split(128, -1)), 8)
            for name, ((q, k, v), heads) in views.items():
                d = q.shape[-1] // heads
                if d not in LIMITS["masked_sdpa_bwd"][0]:
                    continue
                if q.dim() == 3:  # a flat stream enters as the view (1, M, N, C)
                    q, k, v = (z[None] for z in (q, k, v))
                g = torch.randn(q.shape, device=dev, generator=gen).to(dt)
                scale = d ** -0.5
                first = masked_sdpa_bwd(q, k, v, g, scale, heads)
                first_fwd = masked_sdpa(q, k, v, scale, heads)
                want = masked_sdpa_bwd_reference(*(z.float() for z in (q, k, v, g)),
                                                 scale, heads)
                err = max((a.float() - w).abs().max().item() for a, w in zip(first, want))
                n_bwd = n_fwd = 0
                for _ in range(reruns):
                    again = masked_sdpa_bwd(q, k, v, g, scale, heads)
                    n_bwd += not all(torch.equal(a, c) for a, c in zip(first, again))
                    n_fwd += not torch.equal(first_fwd, masked_sdpa(q, k, v, scale, heads))
                unequal += n_bwd + n_fwd
                print(f"K2/K1 {name} B={b} {dt}: K2 err {err:.2e}, reruns not bitwise "
                      f"equal K2 {n_bwd}/{reruns}, K1 {n_fwd}/{reruns}", flush=True)
        for c, h in ((64, 256), (128, 512), (256, 1024), (512, 1024)):
            eps = 1e-6 if c == 512 else 1e-5
            for m in (14688, 1377, 1836, 459):
                args = cs.mlp_args(dev, gen, m, dt, c, h)
                g = torch.randn(m, c, device=dev, generator=gen).to(dt)
                first = fused_mlp_ln_bwd(*args, g, eps)
                first_fwd = fused_mlp_ln(*args, eps)
                want = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), eps)
                err = max(((a.float() - w).abs().max() / w.abs().max().clamp(min=1)).item()
                          for a, w in zip(first, want))
                n_bwd = n_fwd = 0
                for _ in range(reruns // 2):
                    again = fused_mlp_ln_bwd(*args, g, eps)
                    n_bwd += not all(torch.equal(a, c2) for a, c2 in zip(first, again))
                    n_fwd += not torch.equal(first_fwd, fused_mlp_ln(*args, eps))
                unequal += n_bwd + n_fwd
                print(f"K4/K3 C/H={c}/{h} M={m} {dt}: K4 err {err:.2e}, reruns not "
                      f"bitwise equal K4 {n_bwd}/{reruns // 2}, K3 {n_fwd}/{reruns // 2}",
                      flush=True)
    print(f"{unequal} reruns not bitwise equal, {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
