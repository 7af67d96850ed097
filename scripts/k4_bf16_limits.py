#!/usr/bin/env python3
"""The readings behind the limits of K4's bf16 checks at C/H = 128/512 (its
tensor-core passes), and whether those limits tell a kernel that rounds as
the TPU kernel does from one that does not.

Run on the card from the repository root:

    python3 scripts/k4_bf16_limits.py [--seeds 4]

For each M of the card checks (`chip_smoke.py` phase 7 and
`tests/test_torch_cuda.py`, 14,688 down to 1) and for the nearly constant
rows of `tests/test_torch_cuda.py` (x = 0.25 + 0.01 noise, rstd ~ 100, M =
1,377), over `--seeds` seeds, it prints each
of the eight gradients' worst distance from the plain version run in
bfloat16 on the same inputs (dx per element scaled by max(1, |y|), the
parameter gradients against their largest entry, and dx against its
largest entry too, "dx/max"):

- of the kernel (`fused_mlp_ln_bwd` on the bfloat16 tensors);
- of a kernel that does not round LN(x), the hidden, do and dz: K4 in
  float32 on the same values, dx then rounded to bfloat16 (what the CUDA-core
  passes computed from bfloat16 inputs before the tensor-core passes).

Beside each it prints `chip_smoke.K4_BF16_LIMITS` (for the nearly constant
rows' dx the test's: 0.2 per element, 1e-2 of its largest entry), and at
the end whether the kernel passes every limit and the control fails one in
every case.
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

    from chip_smoke import _MLP_GRADS, K4_BF16_LIMITS, card_line, grad_errs, mlp_args, sum_err
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_reference

    if not torch.cuda.is_available():
        print("k4_bf16_limits: needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    limits = [K4_BF16_LIMITS[name] for name in _MLP_GRADS]
    # the nearly constant rows' dx: per element, and against its largest entry
    flat_dx = (0.2, 1e-2)
    cases = [(str(m), m, False)
             for m in (14688, 5121, 1377, 680, 129, 113, 112, 111, 65, 63, 41, 40, 39, 5, 1)]
    cases.append(("1377 nearly constant", 1377, True))
    kernel_ok, control_fails = True, True
    for label, m, flat in cases:
        worst = {"kernel": [0.0] * 9, "control": [0.0] * 9}
        lims = ([flat_dx[0]] + limits[1:] + [flat_dx[1]]) if flat else limits + [float("inf")]
        control_fails_here = True
        for seed in range(args.seeds):
            gen = torch.Generator(device=dev).manual_seed(100 + seed)
            a = list(mlp_args(dev, gen, m, torch.bfloat16))
            if flat:
                a[0] = (0.25 + 0.01 * torch.randn(m, 128, device=dev, generator=gen)).to(
                    torch.bfloat16)
            g = torch.randn(m, 128, device=dev, generator=gen).to(torch.bfloat16)
            want = fused_mlp_ln_bwd_reference(*a, g, 1e-5)
            got = fused_mlp_ln_bwd(*a, g, 1e-5)
            ctl = list(fused_mlp_ln_bwd(*(t.float() for t in a), g.float(), 1e-5))
            ctl[0] = ctl[0].to(torch.bfloat16)
            for key, out in (("kernel", got), ("control", ctl)):
                errs = grad_errs(out, want) + [sum_err(out[0], want[0])]
                worst[key] = [max(w, e) for w, e in zip(worst[key], errs)]
                over = any(e > lim for e, lim in zip(errs, lims))
                if key == "kernel":
                    kernel_ok &= not over
                else:
                    control_fails_here &= over
        control_fails &= control_fails_here
        print(f"M={label}: worst over {args.seeds} seeds, against the plain version in "
              "bfloat16 (limit, kernel, control)", flush=True)
        for name, lim, k, c in zip(_MLP_GRADS + ("dx/max",), lims, worst["kernel"],
                                   worst["control"]):
            print(f"   {name:6s} limit {lim:9.3e}  kernel {k:.3e}  control {c:.3e}"
                  f"{'  KERNEL OVER' if k > lim else ''}", flush=True)
        print(f"   the control fails a limit in every seed: {control_fails_here}", flush=True)
    print(f"the kernel within every limit: {kernel_ok}; the control over one in every "
          f"case: {control_fails}", flush=True)
    return 0 if kernel_ok and control_fails else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
