#!/usr/bin/env python3
"""K4's reduce at C/H = 64/256 or 512/1024 against edited copies of its kernel, in turns.

Run on the card from the repository root:

    python3 scripts/k4_reduce_variants.py [--c 64|512] [--m 14688] [--rounds 4] [--only NAME ...]

Each variant is the repository's `csrc/mlp_ln_bwd.cu` with a few text edits
to `mlp_ln_bwd_reduce_seg_kernel` (the reduce over segments at C = 64) or
`mlp_ln_bwd_reduce_wide_kernel` (the reduce over equal blocks at C = 512),
built with every other width's dispatch taken out (one nvcc each, all
started together, into `build/reduce_variants/<c>/<name>/kernels`); the
compiler's registers and spills of the kernel are printed for each. For
each dtype the script runs the reduce alone (`fused_mlp_ln_bwd_reduce`) on
seeded partials of M rows with each variant's library in turns (forward,
then reverse order, `--rounds` times) and prints its device time a launch
(torch.profiler), whether its six summed gradients equal the plain
version's bit for bit, dls2's error against its largest entry, and whether
a rerun is bitwise equal. Variants marked "diagnostic" compute something
else on purpose: they only time a part of the work. An anchor that is not
found once stops the script; the repository's own sources and libraries
stay untouched.
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
sys.path.insert(0, str(ROOT / "scripts"))

from k4_dx_variants import _ONLY64  # noqa: E402

_INIT = "  if (tid < nbars) mbar_init(&bars[tid], 1);\n"
_BULK = """  if (warp == 0 && lane < nbars) {  // lane l: splits 8 l .. 8 l + 7 on barrier l
    const int s0 = lane * kGroup, ns = min(kGroup, n_w - s0);
    mbar_arm(&bars[lane], static_cast<unsigned>(ns * len * sizeof(float)));
    for (int s = s0; s < s0 + ns; ++s)
      bulk_load(seg + s * len, part_w + s * stride + off,
                static_cast<unsigned>(len * sizeof(float)), &bars[lane]);
  }
"""
_SPLIT_ORDER = """  if (warp == 0) {  // lane l arms barrier l, then issues splits l, l + 32, ...: in split order
    if (lane < nbars)
      mbar_arm(&bars[lane],
               static_cast<unsigned>(min(kGroup, n_w - lane * kGroup) * len * sizeof(float)));
    __syncwarp();
    for (int s = lane; s < n_w; s += 32)
      bulk_load(seg + s * len, part_w + s * stride + off,
                static_cast<unsigned>(len * sizeof(float)), &bars[s / kGroup]);
  }
"""
_SMEM = "    const int smem = rds::smem_bytes(H, splits);\n"
_CP_ASYNC = """  if (tid < kT) {  // an item thread: its float4s of every split, a group at a time
    for (int g0 = 0; g0 < n_w; g0 += kGroup) {
      for (int s = g0; s < min(g0 + kGroup, n_w); ++s)
        for (int f = tid; f < len / 4; f += kT)
          kasf_mma::cp_async16(seg + s * len + 4 * f, part_w + s * stride + off + 4 * f);
      kasf_mma::cp_async_arrive(&bars[g0 / kGroup]);
    }
  }
"""
_CHAINS = "    for (int n0 = 0; n0 < n_dx; n0 += per) {\n"
_ADD = "            for (int c = 0; c < kW; ++c) acc[c] += v[u][c];\n"
_BOUNDS = "__global__ void __launch_bounds__(rds::kTB)\n"
_WIDTH = ("constexpr int kW = 2;                  // floats an item thread sums over the splits\n"
          "constexpr int kT = 128;                // item threads: warps 0-3\n")
_LOOP = """      for (int g0 = 0; g0 < n_w; g0 += kGroup) {
        mbar_wait(&bars[g0 / kGroup], 0);
        float v[kGroup][kW];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          ldv(v[u], seg + (g0 + u < n_w ? g0 + u : n_w - 1) * len + kW * f);
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (g0 + u < n_w) {
#pragma unroll
            for (int c = 0; c < kW; ++c) acc[c] += v[u][c];
          }
      }
"""
_HALVES = """      for (int g0 = 0; g0 < n_w; g0 += kGroup) {
        mbar_wait(&bars[g0 / kGroup], 0);
#pragma unroll
        for (int h4 = 0; h4 < kGroup; h4 += 4) {
          float v[4][kW];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ldv(v[u], seg + (g0 + h4 + u < n_w ? g0 + h4 + u : n_w - 1) * len + kW * f);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (g0 + h4 + u < n_w) {
#pragma unroll
              for (int c = 0; c < kW; ++c) acc[c] += v[u][c];
            }
        }
      }
"""
_PIPELINED = """      float v[kGroup][kW], nv[kGroup][kW];
      mbar_wait(&bars[0], 0);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) ldv(v[u], seg + (u < n_w ? u : n_w - 1) * len + kW * f);
      for (int g0 = 0; g0 < n_w; g0 += kGroup) {
        const int g1 = g0 + kGroup;
        if (g1 < n_w) {
          mbar_wait(&bars[g1 / kGroup], 0);
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            ldv(nv[u], seg + (g1 + u < n_w ? g1 + u : n_w - 1) * len + kW * f);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (g0 + u < n_w) {
#pragma unroll
            for (int c = 0; c < kW; ++c) acc[c] += v[u][c];
          }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
#pragma unroll
          for (int c = 0; c < kW; ++c) v[u][c] = nv[u][c];
      }
"""


def _width(w: int, t: int) -> list:
    """Item threads `t` summing `w` floats each."""
    return [(_WIDTH, f"constexpr int kW = {w};\nconstexpr int kT = {t};\n")]


VARIANTS = {
    "shipped": ("the kernel as it is: 128 item threads, two floats each", []),
    "float4 a thread": ("64 item threads, a float4 each", _width(4, 64)),
    "one item warp": ("32 item threads, two float4s each", _width(4, 32)),
    "copies in split order": ("lane l issues splits l, l + 32, ..., so groups land in order", [
        (_BULK, _SPLIT_ORDER)]),
    "one block a SM": ("120 KB of dynamic shared memory asked, so no SM holds two blocks", [
        (_SMEM, "    const int smem = max(rds::smem_bytes(H, splits), 120 * 1024);\n")]),
    "cp.async": ("16-byte cp.async by the item threads, arriving on the group's barrier", [
        (_INIT, "  if (tid < nbars) mbar_init(&bars[tid], kT);\n"), (_BULK, _CP_ASYNC)]),
    "bounds (kTB, 1)": ("__launch_bounds__ with one block a SM as its minimum", [
        (_BOUNDS, "__global__ void __launch_bounds__(rds::kTB, 1)\n")]),
    "four loads a batch": ("a group's loads and adds in two batches of four", [
        (_LOOP, _HALVES)]),
    "pipelined groups": ("a group's loads issued before the adds of the group before", [
        (_LOOP, _PIPELINED)]),
    "diagnostic: no dx chains": ("the dx warp sums no dx partial (wrong dgamma, dbeta, db2, dls2)", [
        (_CHAINS, "    for (int n0 = 0; n0 < 0; n0 += per) {\n")]),
    "diagnostic: copies only": ("the item threads wait for the copies and add nothing (wrong)", [
        (_ADD, "            for (int c = 0; c < 0; ++c) acc[c] += v[u][c];\n")]),
}


# the reduce at C/H = 512/1024: its own anchors
_ONLY512 = (_ONLY64[0], "  return f(std::integral_constant<int, 512>{});")
_CHAINS512 = "    for (int n0 = 0; n0 < n_dx; n0 += kDxTiles) {\n"
_ADD512 = ("        const float4 v = dxp::ld4(seg + s * len + at);\n        acc.x += v.x;\n"
           "        acc.y += v.y;\n        acc.z += v.z;\n        acc.w += v.w;\n")
_WIDE = "  } else if constexpr (C == 512) {\n    const int smem = rdw::smem_bytes<T>(H, splits);\n"

VARIANTS_512 = {
    "shipped": ("the kernel as it is: 128 blocks, an mbarrier a split and part", []),
    "C = 128's grid": ("the reduce of C = 128 (640 blocks at H = 1024), as before", [
        (_WIDE, "  } else if constexpr (C == -1) {\n    const int smem = rdw::smem_bytes<T>(H, splits);\n")]),
    "diagnostic: no dx chains": ("warp 8 copies and adds no dx partial (wrong dgamma, dbeta, db2, dls2)", [
        (_CHAINS512, "    for (int n0 = 0; n0 < 0; n0 += kDxTiles) {\n")]),
    "diagnostic: copies only": ("the item threads wait for the copies and add nothing (wrong)", [
        (_ADD512, "")]),
}
WIDTHS = {64: (256, _ONLY64, VARIANTS, "reduce_seg"),
          512: (1024, _ONLY512, VARIANTS_512, "reduce_wide")}


def variant_source(edits: list, c: int = 64) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    for anchor, replacement in [WIDTHS[c][1]] + edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in mlp_ln_bwd.cu: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def ptxas_lines(log: str, key: str = "reduce_seg") -> list[str]:
    """The compiler's lines on the width's reduce kernel (`key` in its
    name): its entry and the registers, shared memory and spills reported
    after it."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if key in line and "Compiling entry" in line:
            out += [line.strip()] + [x.strip() for x in lines[i + 1:i + 4]]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--c", type=int, choices=sorted(WIDTHS), default=64)
    parser.add_argument("--m", type=int, default=14688)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--only", nargs="+", default=None)
    args = parser.parse_args()
    c = args.c
    h, _, variants, key = WIDTHS[c]
    names = args.only or list(variants)
    unknown = set(names) - set(variants)
    if unknown:
        parser.error(f"no variants {sorted(unknown)} at C = {c}; known: {sorted(variants)}")
    sources = {name: variant_source(variants[name][1], c) for name in names}

    import torch

    from chip_smoke import card_line, k4_launch_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import (fused_mlp_ln_bwd_partition, fused_mlp_ln_bwd_reduce,
                                              fused_mlp_ln_bwd_reduce_reference)

    if not torch.cuda.is_available():
        print("k4_reduce_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "reduce_variants" / str(c) / re.sub(r"[^A-Za-z0-9]+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "kasportsformer_torch" / "ops" / "csrc", d / "csrc")
        (d / "csrc" / "mlp_ln_bwd.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "kernels"
        jobs[name] = _build._start("mlp_ln_bwd")
    libs = {}
    print(card_line())
    for name, job in jobs.items():
        log = _build._finish("mlp_ln_bwd", *job)
        libs[name] = ctypes.CDLL(str(job[2]))
        libs[name].kasf_error_string.argtypes = [ctypes.c_int]
        libs[name].kasf_error_string.restype = ctypes.c_char_p
        print(f"{name}: " + " | ".join(ptxas_lines(log, key)), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        p = fused_mlp_ln_bwd_partition(args.m, h, c)  # the two passes' partials
        work = torch.randn(p["dx_tiles"] * 3 * c + p["splits"] * (2 * h * c + h), device=dev,
                           generator=gen)
        w2 = torch.randn(c, h, device=dev, generator=gen).mul(h ** -0.5).to(dt)
        b2 = torch.randn(c, device=dev, generator=gen).mul(0.1).to(dt)
        ls2 = torch.rand(c, device=dev, generator=gen)
        a = (work, w2, b2, ls2, args.m)
        want = fused_mlp_ln_bwd_reduce_reference(*a)
        res: dict = {}
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _build._libs["mlp_ln_bwd"] = libs[name]
                got = fused_mlp_ln_bwd_reduce(*a)
                again = fused_mlp_ln_bwd_reduce(*a)
                equal = all(torch.equal(x, w) for x, w in zip(got[:6], want[:6]))
                err = ((got[6] - want[6]).abs().max() / want[6].abs().max().clamp(min=1)).item()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                ms = k4_launch_ms(lambda: fused_mlp_ln_bwd_reduce(*a), 20).get(
                    "reduce", float("nan"))
                res.setdefault(name, []).append((ms, equal, err, same))
        for name in names:
            r = res[name]
            print(f"M={args.m} C/H={c}/{h} {str(dt).split('.')[1]:8s} {name:26s} reduce "
                  + " / ".join(f"{ms:.4f}" for ms, *_ in r)
                  + f" ms; six bitwise equal {all(x[1] for x in r)}; dls2 err "
                  f"{max(x[2] for x in r):.1e}; reruns bitwise equal {all(x[3] for x in r)}"
                  f"  ({variants[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
