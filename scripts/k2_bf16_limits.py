#!/usr/bin/env python3
"""The readings behind the limits of K2's bf16 checks at heads of 16 (its
tensor-core kernel, `masked_sdpa_bwd_mma_kernel`), and whether those limits
tell a kernel that rounds P and dS as the TPU kernel does from one that does
not.

Run on the card from the repository root:

    python3 scripts/k2_bf16_limits.py [--seeds 4]

For N = 1, 17, 27 and 32, the spatial and the temporal view of the card
checks (`chip_smoke.k2_bf16_case`: 8 x 27 sequences of 8 heads of 16, column
slices of one qkv projection, temporally their permuted views and a
transposed gradient), over `--seeds` seeds, it prints each of dq, dk and
dv's worst distance from the plain version run in bfloat16 on the same
inputs, per element (scaled by max(1, |y|)) and as mean |a - b| / mean |b|
(`chip_smoke.mean_err`):

- of the kernel (`masked_sdpa_bwd` on the bfloat16 tensors);
- of the control, K2 in float32 on the same values with its results rounded
  to bfloat16 (`chip_smoke.k2_bf16_control`: what the CUDA-core kernel
  computed in bfloat16 before the tensor-core kernel);
- and, for scale, the bfloat16 plain version's own mean distance from the
  plain version run in float32.

Beside each it prints `chip_smoke.K2_BF16_LIMITS` (and the per-element
1e-2), and at the end whether the kernel passes every limit and the control
fails a mean limit in every case from N = 2 on.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    args = parser.parse_args()

    import torch

    from chip_smoke import (_K2_GRADS, K2_BF16_LIMITS, card_line, k2_bf16_case,
                            k2_bf16_control, k2_kernel, mean_err, scaled_err)
    from kasportsformer_torch.ops.attention import masked_sdpa_bwd, masked_sdpa_bwd_reference

    if not torch.cuda.is_available():
        print("k2_bf16_limits: needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    heads, scale = 8, 16 ** -0.5
    kernel_ok, control_fails = True, True
    for n in (1, 17, 27, 32):
        print(f"N={n}: {k2_kernel(torch.bfloat16, n)}", flush=True)
        for view in ("spatial", "temporal"):
            worst = {key: [0.0] * 6 for key in ("kernel", "control")}
            rounding = [0.0] * 3
            control_fails_here = True
            for seed in range(args.seeds):
                gen = torch.Generator(device=dev).manual_seed(200 + seed)
                a = k2_bf16_case(dev, gen, n, view)
                want = masked_sdpa_bwd_reference(*a, scale, heads)
                exact = masked_sdpa_bwd_reference(*(z.float() for z in a), scale, heads)
                rounding = [max(r, mean_err(w, x)) for r, w, x in zip(rounding, want, exact)]
                got = masked_sdpa_bwd(*a, scale, heads)
                ctl = k2_bf16_control(a, scale, heads)
                for key, out in (("kernel", got), ("control", ctl)):
                    errs = ([scaled_err(o, w) for o, w in zip(out, want)]
                            + [mean_err(o, w) for o, w in zip(out, want)])
                    worst[key] = [max(w, e) for w, e in zip(worst[key], errs)]
                    over_mean = any(e > K2_BF16_LIMITS[nm] for nm, e in zip(_K2_GRADS, errs[3:]))
                    if key == "kernel":
                        kernel_ok &= not over_mean and max(errs[:3]) <= 1e-2
                    else:
                        control_fails_here &= over_mean
            if n > 1:
                control_fails &= control_fails_here
            print(f"   {view}: worst over {args.seeds} seeds from the plain version in "
                  "bfloat16 (limit, kernel, control)", flush=True)
            for i, nm in enumerate(_K2_GRADS):
                k, c = worst["kernel"], worst["control"]
                print(f"      {nm} per element (1e-2) {k[i]:.3e} {c[i]:.3e}; mean "
                      f"({K2_BF16_LIMITS[nm]:.1e}) {k[3 + i]:.3e} {c[3 + i]:.3e}"
                      f"{'  KERNEL OVER' if k[3 + i] > K2_BF16_LIMITS[nm] else ''}; the bf16 "
                      f"plain version's mean from the f32 one {rounding[i]:.3e}", flush=True)
            print(f"      the control over a mean limit in every seed: {control_fails_here}",
                  flush=True)
    print(f"the kernel within every limit: {kernel_ok}; the control over one in every "
          f"case from N = 2 on: {control_fails}", flush=True)
    return 0 if kernel_ok and control_fails else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
