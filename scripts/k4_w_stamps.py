#!/usr/bin/env python3
"""Where a tile of K4's cluster weight pass spends its cycles.

Run on the card from the repository root:

    python3 scripts/k4_w_stamps.py [--m 14688] [--c 512 256] [--dtype float32]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps_w/csrc`, puts
`clock64` stamps into the copy of `mlp_ln_bwd_w_cluster_kernel`
(`csrc/mlp_ln_bwd.cu`, C = 256 and 512) after each of a tile's phases
(threads 0 and 128, the first lanes of an fc1 and of a dh warp, add each
phase's cycles into a device array as they go), builds the copy with
`ops/_build.py` into `build/stamps_w/kernels` and launches it through
`fused_mlp_ln_bwd` at C/H = C/1024. For each width and M it prints the card,
the shipped and the stamped weight pass's device time (torch.profiler) and
each phase's cycles for threads 0 and 128: sums over every block and tile
of the launch, divided by the block tiles (a tile is a cluster's, so the
figures are a block's share of one). The repository's own sources and
libraries stay untouched; an anchor that is not found once in the source
stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import k4_dx_stamps  # noqa: E402  (this directory: the stamping and its reader)

PHASES = ("rows landed, block barrier", "rows + LayerNorm (one exchange)",
          "block barrier, next rows' copies issued", "fc1 (thread 0) / dh (thread 128)",
          "reduce-scatter, partials sent", "wait for the partials", "block barrier",
          "h, dz = GELU, sent", "wait for the other h, dz", "block barrier",
          "dW1c (thread 0) / G_c (thread 128)")
_KERNEL = "mlp_ln_bwd_w_cluster_kernel(const __grid_constant__ CUtensorMap xmap"


_at = functools.partial(k4_dx_stamps._at, indent=4)


_LOOP = ("  for (long long t = t_begin; t < t_end; ++t) {\n"
         "    const unsigned par = static_cast<unsigned>((t - t_begin) & 1);\n")
EDITS = [
    (_LOOP,
     "  long long kasf_t0 = clock64();\n"
     "  const bool kasf_me = tid == 0 || tid == 128;\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); if (kasf_me) "
     "atomicAdd(&kasf_stamp_sums[tid >> 7][k], n_ - kasf_t0); kasf_t0 = n_; }\n" + _LOOP),
    _at("    __syncthreads();  // tile t's rows landed; the last tile's products done\n", 0),
    _at("    if (tid == 0) mbar_arm(bar + 2, K::kLnBytes);  // the next tile's\n", 1),
    _at("      fetch_rows<C>(raw, &xmap, &gmap, (t + 1) * kR, rank, bar, par ^ 1u);\n", 2),
    _at("          rows_dot8<C, kLdG>(gS, w2c, pa, q, p, s);\n      }\n", 3, indent=6),
    _at("    mbar_wait_cluster(bar + 3, par);  // the other block's partials are in\n", 4,
        before=True),
    _at("    mbar_wait_cluster(bar + 3, par);  // the other block's partials are in\n", 5),
    _at("    if (tid == 0) mbar_arm(bar + 3, K::kXBytes);\n", 6),
    _at("    mbar_wait_cluster(bar + 4, par);  // the other block's h and dz are in\n", 7,
        before=True),
    _at("    mbar_wait_cluster(bar + 4, par);  // the other block's h and dz are in\n", 8),
    _at("    if (tid == 0) mbar_arm(bar + 4, K::kXBytes);\n", 9),
    _at("      outer_rows<kR, kLdG, CS / 2, kJ, kJ / 2>(gS + 4 * g16, hS + 4 * g8, acc);\n", 10),
    ("template <typename T, int C>\n__global__ void __launch_bounds__(wpc::kT, 1)\n",
     "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n"
     "template <typename T, int C>\n__global__ void __launch_bounds__(wpc::kT, 1)\n"),
]
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, nargs="+", default=[14688])
    parser.add_argument("--c", type=int, nargs="+", default=[512, 256], choices=(256, 512))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = parser.parse_args()

    import torch

    from chip_smoke import card_line, k4_launch_ms, mlp_args
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_partition

    if not torch.cuda.is_available():
        print("k4_w_stamps: needs a CUDA device")
        return 1
    dev, dt, hidden = torch.device("cuda", 0), getattr(torch, args.dtype), 1024
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    for c in args.c:
        for m in args.m:
            a = mlp_args(dev, gen, m, dt, c, hidden)
            g = torch.randn(m, c, device=dev, generator=gen).to(dt)
            call = (lambda a=a, g=g: fused_mlp_ln_bwd(*a, g, 1e-6))
            cases[(c, m)] = (call, k4_launch_ms(call, 10)["weight pass"])

    # the stamped copy: _build reads its source and build directories from
    # these two names, so fused_mlp_ln_bwd loads the stamped library from here
    stamps_dir = ROOT / "build" / "stamps_w"
    k4_dx_stamps.stamped_sources(stamps_dir / "csrc", _KERNEL, EDITS)
    _build.CSRC = stamps_dir / "csrc"
    _build.BUILD_DIR = stamps_dir / "kernels"
    _build._libs.pop("mlp_ln_bwd", None)
    lib = _build.library("mlp_ln_bwd")
    read = lib.kasf_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 32)()
    print(card_line())
    for (c, m), (call, shipped) in cases.items():
        stamped = k4_launch_ms(call, 10)["weight pass"]
        torch.cuda.synchronize()
        _build.check(lib, read(None, 1), "reset the stamps")
        call()
        torch.cuda.synchronize()
        _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
        p = fused_mlp_ln_bwd_partition(m, hidden, c)
        chunks = hidden // (8192 // (c // 2))
        tiles = -(-m // p["w_rows"]) * chunks * 2  # block tiles, summed
        print(f"M={m} C/H={c}/{hidden} {args.dtype}: weight pass (profiler) {shipped:.4f} ms, "
              f"stamped {stamped:.4f}; cycles a block's {p['w_rows']}-row tile (mean of "
              f"{tiles} block tiles), thread 0 / 128:")
        total = [0.0, 0.0]
        for k, name in enumerate(PHASES):
            a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
            total[0] += a0
            total[1] += a1
            print(f"  {name:40s} {a0:10.0f} {a1:10.0f}")
        print(f"  {'a tile':40s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
