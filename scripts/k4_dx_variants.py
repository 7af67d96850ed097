#!/usr/bin/env python3
"""K4's dx pass at C/H = 64/256 against edited copies of its kernel, in turns.

Run on the card from the repository root:

    python3 scripts/k4_dx_variants.py [--m 14688] [--rounds 4] [--only NAME ...]

Each variant is the repository's `csrc/mlp_ln_bwd.cu` with a few text edits
to `mlp_ln_bwd_dx_wg_kernel` (the two-warp-group dx pass at C = 64), built
with every other width's dispatch taken out (one nvcc each, all started
together, into `build/dx_variants/<name>/kernels`). For each dtype the
script runs K4 through `fused_mlp_ln_bwd` with each variant's library in
turns (forward, then reverse order, `--rounds` times) and prints the dx
pass's device time a launch (torch.profiler), the worst error of the eight
gradients against the plain version in f32 (scaled by max(1, |largest
entry|)) and whether a rerun is bitwise equal. Variants marked "diagnostic"
compute something else on purpose (their error says so): they only time a
part of the work. An anchor that is not found once stops the script; the
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

# the dispatch over widths, cut to C = 64
_ONLY64 = ("""  return C == 64    ? f(std::integral_constant<int, 64>{})
         : C == 128 ? f(std::integral_constant<int, 128>{})
         : C == 256 ? f(std::integral_constant<int, 256>{})
                    : f(std::integral_constant<int, 512>{});""",
           "  return f(std::integral_constant<int, 64>{});")
_GELU = "make_float2(h.x * dxg::gelu_grad(z.x), h.y * dxg::gelu_grad(z.y));"
_FC1_DH = "    dxg::fc1_dh(aS, dS, w1c, w2c, b1c, zS, hS, q1, p1);\n"
_HALVES = "  const int jb = grp * (H / 2), je = jb + H / 2;  // the group's hidden columns\n"

VARIANTS = {
    "shipped": ("the kernel as it is", []),
    "erff": ("dz with erff and expf (gelu_erf_grad) in place of dxg::gelu_grad", [
        (_GELU, "make_float2(h.x * gelu_erf_grad(z.x), h.y * gelu_erf_grad(z.y));")]),
    "two loops": ("fc1, then dh, by the one-block pass's dxp functions", [
        (_FC1_DH, "    dxp::fc1_chunk<C>(aS, w1c, b1c, zS, q1, p1, 0);\n"
                  "    dxp::dh_chunk<C>(dS, w2c, hS, q1, p1, 0);\n")]),
    "group 1 out of step": ("group 1 runs dh, then fc1, as two loops (the groups out of step)", [
        (_FC1_DH, "    if (grp == 1) {\n      dxp::dh_chunk<C>(dS, w2c, hS, q1, p1, 0);\n"
                  "      dxp::fc1_chunk<C>(aS, w1c, b1c, zS, q1, p1, 0);\n    } else {\n"
                  "  " + _FC1_DH + "    }\n")]),
    "group 0 alone": ("group 0 walks all of H, group 1 none: one warp a scheduler in the chunks", [
        (_HALVES, "  const int jb = 0, je = grp ? 0 : H;\n")]),
    "diagnostic: half the chunks": ("group 1 walks no chunk: group 0's half alone (wrong da)", [
        (_HALVES, "  const int jb = grp * (H / 2), je = grp ? jb : jb + H / 2;\n")]),
    "diagnostic: dz without GELU'": ("dz = dh * z, the GELU' math left out (wrong)", [
        (_GELU, "make_float2(h.x * z.x, h.y * z.y);")]),
}


def variant_source(edits: list) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    for anchor, replacement in [_ONLY64] + edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in mlp_ln_bwd.cu: {anchor!r}")
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

    from chip_smoke import card_line, k4_launch_ms, mlp_args
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_reference

    if not torch.cuda.is_available():
        print("k4_dx_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "dx_variants" / re.sub(r"[^A-Za-z0-9]+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "kasportsformer_torch" / "ops" / "csrc", d / "csrc")
        (d / "csrc" / "mlp_ln_bwd.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "kernels"
        jobs[name] = _build._start("mlp_ln_bwd")
    libs = {}
    for name, job in jobs.items():
        _build._finish("mlp_ln_bwd", *job)
        libs[name] = ctypes.CDLL(str(job[2]))
    print(card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        a = mlp_args(dev, gen, args.m, dt, 64, 256)
        g = torch.randn(args.m, 64, device=dev, generator=gen).to(dt)
        want = fused_mlp_ln_bwd_reference(*(t.float() for t in a), g.float(), 1e-5)
        res: dict = {}
        for rnd in range(args.rounds):
            order = names if rnd % 2 == 0 else names[::-1]
            for name in order:
                _build._libs["mlp_ln_bwd"] = libs[name]
                call = (lambda: fused_mlp_ln_bwd(*a, g, 1e-5))
                got = call()
                again = call()
                err = max(((x.float() - w).abs().max() / w.abs().max().clamp(min=1)).item()
                          for x, w in zip(got, want))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                res.setdefault(name, []).append(
                    (k4_launch_ms(call, 20)["dx pass"], err, same))
        for name in names:
            r = res[name]
            print(f"M={args.m} C/H=64/256 {str(dt).split('.')[1]:8s} {name:30s} dx pass "
                  + " / ".join(f"{ms:.4f}" for ms, _, _ in r)
                  + f" ms; err {max(e for _, e, _ in r):.1e}; reruns bitwise equal "
                  f"{all(s for _, _, s in r)}  ({VARIANTS[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
