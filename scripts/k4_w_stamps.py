#!/usr/bin/env python3
"""Where a tile of K4's weight pass spends its cycles.

Run on the card from the repository root:

    python3 scripts/k4_w_stamps.py [--m 14688] [--c 512 256 64] [--dtype float32]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps_w/<kernel>/csrc`,
puts `clock64` stamps into the copy of the weight pass that runs at each
width (`csrc/mlp_ln_bwd.cu`) after each of its phases (threads 0 and 128
add each phase's cycles into a device array as they go), builds the copy
with `ops/_build.py` into `build/stamps_w/<kernel>/kernels` and launches it
through `fused_mlp_ln_bwd` at the width's hidden size (C/H 64/256, 128/512,
256/1024, 512/1024). The kernel stamped at each width:
`mlp_ln_bwd_w_cluster_kernel` at C = 256 and 512 (threads 0 and 128 the
first lanes of an fc1 and of a dh warp; a tile is a cluster's, so the
figures are a block's share of one), `mlp_ln_bwd_w_kernel` at 128 (thread 0
runs fc1 and dW1c, thread 128 dh and G_c), and at 64 that one-block kernel
or, in a tree that has it, `mlp_ln_bwd_w_tc_kernel` (3xTF32 on the tensor
cores; threads 0 and 128 lead warps 0 and 4, each over 16 hidden columns).
For each width and M it prints the card, the shipped and the stamped weight
pass's device time (torch.profiler) and each phase's cycles for threads 0
and 128: a tile's phases as sums over every block and tile of the launch
divided by the block tiles, a block's once-only phases (prologue, the
weights' split, epilogue) divided by the blocks, then a block's whole: the
once-only phases and its tiles' mean times the tiles a block takes.
`--mma-only` runs the 3xTF32 kernel's copy with the products' fragment loads
at addresses that do not change with the k8 step (z^T, dh^T) or the row step
(dW1c, G_c^T), so the compiler loads each once a tile and every product
keeps its own operands: its product phases are then the tensor-core
products (and the split of h and dz) alone, their time against the shipped
one the share of the fragment loads (its results are wrong; a diagnostic of
time only). The repository's
own sources and libraries stay untouched; an anchor that is not found once
in the source stops the script.
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

# the cluster kernel at C = 256 and 512
PHASES = ("rows landed, block barrier", "rows + LayerNorm (one exchange)",
          "block barrier, next rows' copies issued", "fc1 (thread 0) / dh (thread 128)",
          "reduce-scatter, partials sent", "wait for the partials", "block barrier",
          "h, dz = GELU, sent", "wait for the other h, dz", "block barrier",
          "dW1c (thread 0) / G_c (thread 128)")
_KERNEL = "mlp_ln_bwd_w_cluster_kernel(const __grid_constant__ CUtensorMap xmap"
_STAMP = ("  long long kasf_t0 = clock64();\n"
          "  const bool kasf_me = tid == 0 || tid == 128;\n"
          "#define KASF_STAMP(k) { const long long n_ = clock64(); if (kasf_me) "
          "atomicAdd(&kasf_stamp_sums[tid >> 7][k], n_ - kasf_t0); kasf_t0 = n_; }\n")
_ARRAY = "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n"


_at = functools.partial(k4_dx_stamps._at, indent=4)


_LOOP = ("  for (long long t = t_begin; t < t_end; ++t) {\n"
         "    const unsigned par = static_cast<unsigned>((t - t_begin) & 1);\n")
_CLUSTER_DEF = "template <typename T, int C>\n__global__ void __launch_bounds__(wpc::kT, 1)\n"
EDITS = [
    (_LOOP, _STAMP + _LOOP),
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
    (_CLUSTER_DEF, _ARRAY + _CLUSTER_DEF),
]

# the one-block kernel at C = 128 (and at 64 in a tree from before the
# 3xTF32 kernel): thread 0 runs fc1 and dW1c, thread 128 dh and G_c
PHASES_ONE = ("prologue: rows issued, weights staged, block barrier",
              "rows' wait, block barrier", "rows + LayerNorm",
              "block barrier, next rows issued", "fc1 (thread 0) / dh (thread 128)",
              "block barrier: z and dh in", "h, dz = GELU, db1",
              "block barrier: h and dz in", "dW1c (thread 0) / G_c (thread 128)",
              "epilogue: the split's partial")
_KERNEL_ONE = "mlp_ln_bwd_w_kernel(const T* __restrict__ x"
_ONE_TOP = ("  const long long t_end = t_begin + per < n_tiles ? t_begin + per : n_tiles;\n"
            "  if (tid == 0) mbar_init(bar);\n")
_ONE_END = "    base[2LL * H * C + j0 + tid] = s;\n  }\n}\n"
_ONE_DEF = "template <typename T, int C>\n__global__ void __launch_bounds__(wp::kT, 1)\n"
EDITS_ONE = [
    (_ONE_TOP, _ONE_TOP.split("\n")[0] + "\n" + _STAMP + _ONE_TOP.split("\n")[1] + "\n"),
    _at("  __syncthreads();  // the weights are staged\n", 0, indent=2),
    _at("    __syncthreads();  // tile t's rows landed; the last tile's products are done\n", 1),
    _at("    stage_rows<C>(raw, aS, gS, gm, bt, t * kR, M, eps, warp, lane);\n", 2),
    _at("    if (tid == 0 && t + 1 < t_end) fetch_rows<C>(raw, x, g, (t + 1) * kR, M, bar);\n", 3),
    _at("      split_product<C>(gS, w2s, out, kh, q8, p8);\n", 4),
    _at("    __syncthreads();  // every split's z and dh in\n", 5),
    _at("    __syncthreads();  // h and dz in\n", 6, before=True),
    _at("    __syncthreads();  // h and dz in\n", 7),
    _at("      outer_tile<kR, kLdA, C / 2, kLdZ, kJ / 2>(gS + 4 * g16, zS + 4 * g8, acc);\n", 8),
    (_ONE_END, _ONE_END[:-2] + "  KASF_STAMP(9)\n#undef KASF_STAMP\n}\n"),
    (_ONE_DEF, _ARRAY + _ONE_DEF),
]

# the 3xTF32 kernel at C = 64: threads 0 and 128 lead warps 0 and 4
PHASES_TC = ("prologue: rows and weights issued, constants", "rows' wait",
             "rows + LayerNorm, a and g split into planes",
             "first tile: the weights' wait", "first tile: the weights split into fragments",
             "block barrier, next rows issued", "z^T, dh^T (fragment loads, 2 x 168 mma)",
             "h, dz = GELU, db1", "dW1c, G_c^T (h, dz split, loads, 2 x 168 mma)",
             "block barrier: the planes read", "epilogue: the split's partial")
_KERNEL_TC = "mlp_ln_bwd_w_tc_kernel(const T* __restrict__ x"
_TC_TOP = "  const int gq = lane >> 2, tq = lane & 3, jr = 16 * warp + gq;\n"
_TC_END = "    if (tq == 0) base[2LL * H * C + j0 + jr + 8 * h] = s;\n  }\n}\n"
_TC_DEF = "template <typename T>\n__global__ void __launch_bounds__(tc::kT, 1)\n"
_TC_BARRIER = "    __syncthreads();  // the planes are read: the next tile's may replace them\n"
EDITS_TC = [
    (_TC_TOP, _TC_TOP + _STAMP),
    _at("  float db1[2] = {0.f, 0.f};  // columns jr, jr + 8 over the thread's rows\n", 0,
        indent=2),
    _at("    kasf_mma::mbar_wait(bars, static_cast<unsigned>((t - t_begin) & 1));\n", 1),
    _at("    stage_rows<T>(raw, aP, gP, gm, bt, t * kR, M, eps, warp, lane);\n", 2),
    _at("      kasf_mma::mbar_wait(bars + 1, 0);\n", 3, indent=6),
    _at("      split_weights<T>(w1F, w2F, ls2, tid);\n", 4, indent=6),
    _at("    if (tid == 0 && t + 1 < t_end) wp::fetch_rows<C>(raw, x, g, (t + 1) * kR, M, bars);\n",
        5),
    _at("    // h = GELU(z + b1) in place of z, dz = dh GELU'(z + b1) in place of dh;\n", 6,
        before=True),
    _at("    // 3-4. dW1c += dz^T a and G_c^T += h^T g: k8 step n over rows 8 n..,\n", 7,
        before=True),
    _at(_TC_BARRIER, 8, before=True),
    _at(_TC_BARRIER, 9),
    (_TC_END, _TC_END[:-2] + "  KASF_STAMP(10)\n#undef KASF_STAMP\n}\n"),
    (_TC_DEF, _ARRAY + _TC_DEF),
]

# the diagnostic: the products' fragment loads at addresses that do not
# change with the k8 step (1-2) or the row step (3-4), so the compiler loads
# each once a tile; the products keep distinct operands, so none is elided
MMA_ONLY = [
    ("      const int p = 4 * k + tq;  // channels 8k + 2t (slot t), 8k + 2t + 1 (slot t + 4)\n",
     "      const int p = tq;\n"),
    ("      const int f = ((8 * warp + k) * 32 + lane) * 4;\n",
     "      const int f = (8 * warp * 32 + lane) * 4;\n"),
    ("      const int r = 8 * n + 2 * tq;\n", "      const int r = 2 * tq;\n"),
]

# each variant: the kernel's signature, its stamps, the phases' names, the
# phases that run once a block (the rest once a tile), and the blocks a
# (hidden chunk, row split) takes
VARIANTS = {
    "cluster": dict(kernel=_KERNEL, edits=EDITS, phases=PHASES, once=(), blocks=2),
    "one-block": dict(kernel=_KERNEL_ONE, edits=EDITS_ONE, phases=PHASES_ONE, once=(0, 9),
                      blocks=1),
    "tc": dict(kernel=_KERNEL_TC, edits=EDITS_TC, phases=PHASES_TC, once=(0, 3, 4, 10),
               blocks=1, mma_only=MMA_ONLY),
}
HIDDEN = {64: 256, 128: 512, 256: 1024, 512: 1024}


def variant_of(c: int, text: str) -> str:
    """The weight pass's kernel at width c in a tree whose mlp_ln_bwd.cu is
    text."""
    if c >= 256:
        return "cluster"
    if c == 64 and "tc" in VARIANTS and VARIANTS["tc"]["kernel"] in text:
        return "tc"
    return "one-block"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, nargs="+", default=[14688])
    parser.add_argument("--c", type=int, nargs="+", default=[512, 256],
                        choices=(64, 128, 256, 512))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--mma-only", action="store_true",
                        help="the 3xTF32 kernel's fragment loads once a tile (time only)")
    args = parser.parse_args()
    if args.dtype == "bfloat16" and 128 in args.c:
        parser.error("bf16 at C = 128 runs the tensor-core passes, which carry no stamps; "
                     "scripts/k4_bf16_variants.py times them")

    import torch

    from chip_smoke import card_line, k4_launch_ms, mlp_args
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import (_BWD_TILES, fused_mlp_ln_bwd,
                                              fused_mlp_ln_bwd_partition)

    if not torch.cuda.is_available():
        print("k4_w_stamps: needs a CUDA device")
        return 1
    dev, dt = torch.device("cuda", 0), getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    for c in args.c:
        for m in args.m:
            a = mlp_args(dev, gen, m, dt, c, HIDDEN[c])
            g = torch.randn(m, c, device=dev, generator=gen).to(dt)
            call = (lambda a=a, g=g: fused_mlp_ln_bwd(*a, g, 1e-6))
            cases[(c, m)] = (call, k4_launch_ms(call, 10)["weight pass"])

    # the stamped copy, one kernel at a time (they share the device array):
    # _build reads its source and build directories from these two names, so
    # fused_mlp_ln_bwd loads the stamped library from here
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    print(card_line())
    for name in dict.fromkeys(variant_of(c, text) for c in args.c):
        v = VARIANTS[name]
        diag = args.mma_only and "mma_only" in v
        stamps_dir = ROOT / "build" / "stamps_w" / (name + ("-mma" if diag else ""))
        k4_dx_stamps.stamped_sources(stamps_dir / "csrc", v["kernel"],
                                     v["edits"] + (v["mma_only"] if diag else []))
        _build.CSRC = stamps_dir / "csrc"
        _build.BUILD_DIR = stamps_dir / "kernels"
        _build._libs.pop("mlp_ln_bwd", None)
        lib = _build.library("mlp_ln_bwd")
        read = lib.kasf_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        sums = (ctypes.c_ulonglong * 32)()
        for (c, m), (call, shipped) in cases.items():
            if variant_of(c, text) != name:
                continue
            hidden = HIDDEN[c]
            stamped = k4_launch_ms(call, 10)["weight pass"]
            torch.cuda.synchronize()
            _build.check(lib, read(None, 1), "reset the stamps")
            call()
            torch.cuda.synchronize()
            _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
            p = fused_mlp_ln_bwd_partition(m, hidden, c)
            chunks = hidden // _BWD_TILES[c][2]
            blocks = chunks * p["splits"] * v["blocks"]
            tiles = -(-m // p["w_rows"]) * chunks * v["blocks"]  # block tiles, summed
            print(f"M={m} C/H={c}/{hidden} {args.dtype} ({name} kernel"
                  + (", fragment loads once a tile: the products' mma alone" if diag else "")
                  + f"): weight pass (profiler) {shipped:.4f} ms, stamped {stamped:.4f}; "
                  f"cycles of a block's {p['w_rows']}-row tile (mean of {tiles} block tiles) "
                  f"and of a block's once-only phases (mean of {blocks} blocks), thread 0 / "
                  "128:")
            tile, once = [0.0, 0.0], [0.0, 0.0]
            for k, phase in enumerate(v["phases"]):
                n = blocks if k in v["once"] else tiles
                a0, a1 = sums[k] / n, sums[16 + k] / n
                acc = once if k in v["once"] else tile
                acc[0] += a0
                acc[1] += a1
                print(f"  {phase:52s} {a0:10.0f} {a1:10.0f}")
            print(f"  {'a tile':52s} {tile[0]:10.0f} {tile[1]:10.0f}")
            if v["once"]:
                per = tiles / blocks
                print(f"  {f'a block ({per:.2f} tiles)':52s} {once[0] + per * tile[0]:10.0f} "
                      f"{once[1] + per * tile[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
