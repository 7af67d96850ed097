#!/usr/bin/env python3
"""K4's weight pass at C/H = 64/256 against edited copies of its kernel, in turns.

Run on the card from the repository root:

    python3 scripts/k4_w_variants.py [--m 14688] [--rounds 4] [--only NAME ...]

Each variant is the repository's `csrc/mlp_ln_bwd.cu` with a few text edits
to `mlp_ln_bwd_w_tc_kernel` (the 3xTF32 weight pass at C = 64), built with
every other width's dispatch taken out (one nvcc each, all started
together, into `build/w_variants/<name>/kernels`). For each dtype the script
runs K4 through `fused_mlp_ln_bwd` with each variant's library in turns
(forward, then reverse order, `--rounds` times) and prints the weight
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

import k4_dx_variants  # noqa: E402  (this directory: the cut to C = 64)

_MMA3 = "using kasf_mma::mma_tf32x3;\n"
_GELU = """    // h = GELU(z + b1) in place of z, dz = dh GELU'(z + b1) in place of dh;
    // db1 over the thread's rows in order
#pragma unroll
    for (int n = 0; n < kRS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = gelu_and_grad(z[n][i] + b1j[i >> 1]);
        z[n][i] = e.x;
        d[n][i] *= e.y;
        db1[i >> 1] += d[n][i];
      }
"""
_OUTER = """    for (int n = 0; n < kRS; ++n) {
      uint32_t hh[4], hl[4], zh[4], zl[4];
"""
_GELU_AT = """    for (int n = 0; n < kRS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = gelu_and_grad(z[n][i] + b1j[i >> 1]);
        z[n][i] = e.x;
        d[n][i] *= e.y;
        db1[i >> 1] += d[n][i];
      }
      uint32_t hh[4], hl[4], zh[4], zl[4];
"""
# c += a b from the hi parts alone: one TF32 product in place of three
_ONE = """__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&)[2]) {
  kasf_mma::mma_tf32(c, ahi, bhi[0], bhi[1]);
}
"""

_P12 = """        mma_tf32x3(z[n], w1h, w1l, ah, al);
        mma_tf32x3(d[n], w2h, w2l, gh, gl);
"""
_P12_TERMS = """        kasf_mma::mma_tf32(z[n], w1l, ah[0], ah[1]);
        kasf_mma::mma_tf32(d[n], w2l, gh[0], gh[1]);
        kasf_mma::mma_tf32(z[n], w1h, al[0], al[1]);
        kasf_mma::mma_tf32(d[n], w2h, gl[0], gl[1]);
        kasf_mma::mma_tf32(z[n], w1h, ah[0], ah[1]);
        kasf_mma::mma_tf32(d[n], w2h, gh[0], gh[1]);
"""
_P34_START = "        // n8 step 2q: channel 16q + 2g, the units' first; 2q + 1 the second\n"
_P34_END = "        mma_tf32x3(gg[2 * q + 1], hh, hl, bh, bl);\n"
_P34_TERMS = """        // n8 step 2q: channel 16q + 2g, the units' first; 2q + 1 the second
        const float4* u[4] = {&a0, &a0, &g0, &g0};
        const float4* v[4] = {&a1, &a1, &g1, &g1};
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool second = e & 1;
          bh[e][0] = __float_as_uint(second ? u[e]->y : u[e]->x);
          bh[e][1] = __float_as_uint(second ? v[e]->y : v[e]->x);
          bl[e][0] = __float_as_uint(second ? u[e]->w : u[e]->z);
          bl[e][1] = __float_as_uint(second ? v[e]->w : v[e]->z);
        }
        float (*acc[4])[4] = {&dw[2 * q], &dw[2 * q + 1], &gg[2 * q], &gg[2 * q + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) kasf_mma::mma_tf32(*acc[e], *(e < 2 ? &zl : &hl), bh[e][0], bh[e][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) kasf_mma::mma_tf32(*acc[e], *(e < 2 ? &zh : &hh), bl[e][0], bl[e][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) kasf_mma::mma_tf32(*acc[e], *(e < 2 ? &zh : &hh), bh[e][0], bh[e][1]);
"""


def _block(text: str, start: str, end: str) -> str:
    """The text from start through end, for a replacement of the whole."""
    i = text.index(start)
    return text[i:text.index(end, i) + len(end)]


VARIANTS = {
    "shipped": ("the kernel as it is", []),
    "GELU in the outer loop": ("h and dz of row step n just before its outer products", [
        (_GELU, ""), (_OUTER, _GELU_AT)]),
    "terms interleaved": ("each step's lo hi products first, then hi lo, then hi hi", [
        (_P12, _P12_TERMS), ("P34", _P34_TERMS)]),
    "diagnostic: 1xTF32": ("each product hi hi alone: a third of the mma (wrong)", [
        (_MMA3, _ONE)]),
    "diagnostic: no GELU": ("h = z, dz = dh (wrong)", [
        ("        const float2 e = gelu_and_grad(z[n][i] + b1j[i >> 1]);\n",
         "        const float2 e = make_float2(z[n][i], 1.0f);\n")]),
}


def variant_source(edits: list) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    for anchor, replacement in [k4_dx_variants._ONLY64] + edits:
        if anchor == "P34":  # the outer products' step, start to end
            anchor = _block(text, _P34_START, _P34_END)
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
        print("k4_w_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "w_variants" / re.sub(r"[^A-Za-z0-9]+", "_", name)
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
                    (k4_launch_ms(call, 20)["weight pass"], err, same))
        for name in names:
            r = res[name]
            print(f"M={args.m} C/H=64/256 {str(dt).split('.')[1]:8s} {name:30s} weight pass "
                  + " / ".join(f"{ms:.4f}" for ms, _, _ in r)
                  + f" ms; err {max(e for _, e, _ in r):.1e}; reruns bitwise equal "
                  f"{all(s for _, _, s in r)}  ({VARIANTS[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
