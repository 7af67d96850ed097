#!/usr/bin/env python3
"""K4 in bf16 at C/H = 128/512 (its tensor-core passes) against edited
copies of the two kernels, in turns.

Run on the card from the repository root:

    python3 scripts/k4_bf16_variants.py [--m 14688] [--rounds 4] [--only NAME ...]

Each variant is the repository's `csrc/mlp_ln_bwd.cu` with a few text edits
to `mlp_ln_bwd_dx_mma_kernel` or `mlp_ln_bwd_w_mma_kernel` (or to what both
share), built with every other width's dispatch taken out (one nvcc each,
all started together, into `build/bf16_variants/<name>/kernels`). The script
runs K4 through `fused_mlp_ln_bwd` in bfloat16 with each variant's library
in turns (forward, then reverse order, `--rounds` times) and prints the dx
pass's and the weight pass's device time a launch (torch.profiler), the
worst error of the eight gradients against the plain version run in
bfloat16 (dx scaled by max(1, |y|), the rest against their largest entry)
and whether a rerun is bitwise equal. Variants marked "diagnostic" compute
something else on purpose (their error says so): they only time a part of
the work. An anchor that is not found once stops the script; the
repository's own sources and libraries stay untouched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the dispatch over widths, cut to C = 128
_ONLY128 = ("""  return C == 64    ? f(std::integral_constant<int, 64>{})
         : C == 128 ? f(std::integral_constant<int, 128>{})
         : C == 256 ? f(std::integral_constant<int, 256>{})
                    : f(std::integral_constant<int, 512>{});""",
            "  return f(std::integral_constant<int, 128>{});")
# the six call sites of GELU and GELU' in the two passes (each edit below
# names how often its anchor occurs; once where it does not say)
_GELU = "tc::gelu_and_grad(z[u]["
_MM = "namespace mm {\n"
_Q_LOOP = "#pragma unroll 1\n    for (int q = 0; q < kKC / 16; ++q) {"
_STAGES = "constexpr int kStages = 3;\n// a stage (bf16)"

VARIANTS = {
    "shipped": ("the kernels as they are", []),
    "erff GELU": ("both passes' GELU and GELU' with erff (wp::gelu_and_grad) in place of "
                  "erf by Abramowitz and Stegun 7.1.26 (tc::gelu_and_grad)", [
                      (_GELU, _GELU.replace("tc::", "wp::"), 6)]),
    "dx q by 2": ("the dx pass's 16-column steps unrolled by two", [
        (_Q_LOOP, _Q_LOOP.replace("unroll 1", "unroll 2"))]),
    "dx 4 stages": ("the dx pass's cp.async ring of four stages", [
        (_STAGES, _STAGES.replace("3;", "4;"))]),
    "diagnostic: no GELU": ("h = z, GELU' = 1 in both passes: the GELU math left out (wrong)", [
        (_MM, _MM + "__device__ __forceinline__ float2 no_gelu(float z) { "
         "return make_float2(z, 1.0f); }\n"),
        (_GELU, _GELU.replace("tc::gelu_and_grad", "no_gelu"), 6)]),
}


def variant_source(edits: list) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    for anchor, replacement, *count in [_ONLY128] + edits:
        if text.count(anchor) != (count or [1])[0]:
            raise SystemExit(f"anchor not found {(count or [1])[0]} times in mlp_ln_bwd.cu: "
                             f"{anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, default=14688)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=None)
    args = parser.parse_args()
    names = args.only or list(VARIANTS)
    sources = {name: variant_source(VARIANTS[name][1]) for name in names}

    import torch

    from chip_smoke import card_line, grad_errs, k4_launch_ms, mlp_args
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_reference

    if not torch.cuda.is_available():
        print("k4_bf16_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "bf16_variants" / re.sub(r"[^A-Za-z0-9]+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "kasportsformer_torch" / "ops" / "csrc", d / "csrc")
        (d / "csrc" / "mlp_ln_bwd.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "kernels"
        jobs[name] = _build._start("mlp_ln_bwd")
    libs = {}
    for name, job in jobs.items():
        log = _build._finish("mlp_ln_bwd", *job)
        libs[name] = ctypes.CDLL(str(job[2]))
        current, regs = "", []
        for ln in log.splitlines():  # each kernel's properties, then its registers
            if "Function properties for" in ln:
                current = ln
            elif "mma_kernel" in current and ("spill" in ln or "Used " in ln):
                regs.append(ln.strip())
        print(f"{name}: the mma kernels' {regs}", flush=True)
    print(card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    a = mlp_args(dev, gen, args.m, dt, 128, 512)
    g = torch.randn(args.m, 128, device=dev, generator=gen).to(dt)
    want = fused_mlp_ln_bwd_reference(*a, g, 1e-5)
    res: dict = {}
    for rnd in range(args.rounds):
        order = names if rnd % 2 == 0 else names[::-1]
        for name in order:
            _build._libs["mlp_ln_bwd"] = libs[name]
            call = (lambda: fused_mlp_ln_bwd(*a, g, 1e-5))
            got = call()
            again = call()
            err = max(grad_errs(got, want))
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            per = k4_launch_ms(call, 20)
            res.setdefault(name, []).append((per["dx pass"], per["weight pass"], err, same))
    for name in names:
        r = res[name]
        print(f"M={args.m} C/H=128/512 bfloat16 {name:22s} dx pass "
              + " / ".join(f"{d:.4f}" for d, _, _, _ in r) + " ms; weight pass "
              + " / ".join(f"{w:.4f}" for _, w, _, _ in r)
              + f" ms; err {max(e for _, _, e, _ in r):.1e}; reruns bitwise equal "
              f"{all(s for _, _, _, s in r)}  ({VARIANTS[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
