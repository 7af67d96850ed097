#!/usr/bin/env python3
"""Where a tile of K4's dx pass spends its cycles.

Run on the card from the repository root:

    python3 scripts/k4_dx_stamps.py [--m 14688] [--c 512 256 64] [--dtype float32]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps/csrc`, puts
`clock64` stamps into the copy of the dx pass (`csrc/mlp_ln_bwd.cu`) after
each of a tile's phases (threads 0 and 128 add each phase's cycles into a
device array as they go, so the stamps take no registers of the others),
builds the copy with `ops/_build.py` into `build/stamps/kernels` and
launches it through `fused_mlp_ln_bwd` at the width's hidden size (C/H
64/256, 128/512, 256/1024, 512/1024). The kernel stamped at each width:
`mlp_ln_bwd_dx_cluster_kernel` at C = 256 and 512 (a tile is a cluster's,
so the figures are a block's share of one), `mlp_ln_bwd_dx_kernel` at 128
(thread 0 runs fc1, thread 128 dh), and at 64 the one-block kernel or, in a
tree that has it, `mlp_ln_bwd_dx_wg_kernel` (threads 0 and 128 lead the
two warp groups, each over half the hidden width). For each width and M it
prints the card, the shipped and the stamped K4 call's times (CUDA events)
and dx pass's device time (torch.profiler), and each phase's cycles for
threads 0 and 128 (sums over every block and tile of the launch, divided
by the block tiles): the chunk phases summed over the chunks a thread walks
in a tile, and a chunk's mean beside them. The repository's own sources and
libraries stay untouched; an anchor that is not found once in the source
stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("rows + LayerNorm (two exchanges)", "W2^T wait, dh of chunk 0, barriers",
          "W1 wait, fc1, reduce-scatter, sends", "W2^T wait, dh(n + 1)",
          "wait for the partials", "dz = dh GELU'(z)", "block barrier",
          "W2^T copy started, dz sent", "da, own columns", "wait for the other dz",
          "da, other columns", "block barrier closing the chunk", "W1 copy started",
          "epilogue (first tile: prologue)")
_N = len(PHASES)
_CHUNK = range(2, 13)  # the phases of the chunk loop
_KERNEL = "mlp_ln_bwd_dx_cluster_kernel(const T* __restrict__ x"


def _at(anchor: str, k: int, before: bool = False, indent: int = 6) -> tuple[str, str]:
    """Stamp phase k just after (or before) `anchor`."""
    stamp = " " * indent + f"KASF_STAMP({k})\n"
    return anchor, stamp + anchor if before else anchor + stamp


_END = ("        part[(tile * 3 + k3) * C + rank * K::CS + c] = t[k3];\n    }\n  }\n}\n")
EDITS = [
    ("  long long n = 0;  // the block's chunks so far, over its tiles\n",
     "  long long n = 0;  // the block's chunks so far, over its tiles\n"
     "  long long kasf_t0 = clock64();\n"
     "  const bool kasf_me = tid == 0 || tid == 128;\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); if (kasf_me) "
     "atomicAdd(&kasf_stamp_sums[tid >> 7][k], n_ - kasf_t0); kasf_t0 = n_; }\n"),
    _at("    const long long tile = cid + k * ncl, row0 = tile * K::kR;\n", 13, indent=4),
    _at("    stage_rows<C>(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, slots, row0, M, eps, "
        "rank, warp,\n                  lane);\n", 0, indent=4),
    _at("    if (n + 1 < total && w2_copier) fetch_slice<C>(w2s, w2s_g, K::kJ, H, rank, "
        "w2_bar);\n", 1, indent=4),
    _at("      // 2. dh of the next chunk while the partials travel\n", 2, before=True),
    _at("      // 3. dz of this block's columns: the two blocks' partials in rank order\n", 3,
        before=True),
    _at("      if (tid == 0) mbar_arm(bar, K::kRecvBytes);  // the next chunk's\n", 4),
    _at("      __syncthreads();  // this block's dz columns in; W2^T(n + 1) read\n", 5,
        before=True),
    _at("      __syncthreads();  // this block's dz columns in; W2^T(n + 1) read\n", 6),
    _at("      // 5. da += dz W1: this block's columns, then the other block's\n", 7,
        before=True),
    _at("      dxp::da_chunk<K>(zS + K::kW * rank, w1c + K::kW * rank * K::kLdW1, da, q4, "
        "p4);\n", 8),
    _at("      if (tid == 0) mbar_arm(bar + 1, K::kZBytes);  // the next chunk's\n", 9),
    _at("      dxp::da_chunk<K>(zS + K::kW * other, w1c + K::kW * other * K::kLdW1, da, q4, "
        "p4);\n", 10),
    _at("      __syncthreads();  // W1(n) and zS read\n", 11),
    _at("        fetch_slice<C>(w1c, w1s_g, (j + 2) % chunks * K::kJ, H, rank, w1_bar + (n & 1));"
        "\n", 12),
    (_END, _END[:-2] + "  KASF_STAMP(13)\n#undef KASF_STAMP\n}\n"),
    ("template <typename T, int C>\n__global__ void __launch_bounds__(dxc::kT, 1)\n",
     "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n"
     "template <typename T, int C>\n__global__ void __launch_bounds__(dxc::kT, 1)\n"),
]
_READER = """
extern "C" int kasf_stamps(unsigned long long* host, int reset) {
  if (reset) {
    static const unsigned long long zero[32] = {};
    return cudaMemcpyToSymbol(kasf_stamp_sums, zero, sizeof zero);
  }
  return cudaMemcpyFromSymbol(host, kasf_stamp_sums, 32 * sizeof(unsigned long long));
}
"""


# the one-block dx pass (C = 64 before its warp-group kernel, and 128 in
# f32): thread 0 runs fc1, thread 128 dh
PHASES_ONE = ("prologue: chunk 0 issued, rows + LayerNorm", "chunk's wait and block barrier",
              "next chunk issued", "fc1 (thread 0) / dh (thread 128)",
              "block barrier: z and dh in", "dz = dh GELU'(z)",
              "block barrier: dz in", "da += dz W1c",
              "epilogue: dx rows, the tile's sums")
_KERNEL_ONE = "mlp_ln_bwd_dx_kernel(const T* __restrict__ x"
_ONE_DEF = "template <typename T, int C>\n__global__ void __launch_bounds__(dxp::kT, 1)\n"
EDITS_ONE = [
    ("  fetch_chunk<C>(st0, w1, w2, b1, 0, H, tid);\n",
     "  long long kasf_t0 = clock64();\n"
     "  const bool kasf_me = tid == 0 || tid == 128;\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); if (kasf_me) "
     "atomicAdd(&kasf_stamp_sums[tid >> 7][k], n_ - kasf_t0); kasf_t0 = n_; }\n"
     "  fetch_chunk<C>(st0, w1, w2, b1, 0, H, tid);\n"),
    _at("  stage_rows<C>(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, row0, M, eps, warp, "
        "lane);\n", 0, indent=2),
    _at("    __syncthreads();  // this chunk is in; the last chunk's zS and stage are consumed\n",
        1, indent=4),
    _at("    fetch_chunk<C>(s ? st0 : st1, w1, w2, b1, j0 + K::kKC, H, tid);\n", 2, indent=4),
    _at("      dh_chunk<C>(dS, w2c, hS, q1, p1, s1);\n", 3, indent=4),
    _at("    __syncthreads();  // z and dh in\n", 4, indent=4),
    _at("    __syncthreads();  // dz in\n", 5, before=True, indent=4),
    _at("    __syncthreads();  // dz in\n", 6, indent=4),
    _at("    da_chunk<K>(zS, w1c, da, q4, p4);\n", 7, indent=4),
    ("  dx_epilogue<K, C>(da, x, g, gamma, sMean, sRstd, aS, dx, part, row0, M, q4, p4, tid);\n}\n",
     "  dx_epilogue<K, C>(da, x, g, gamma, sMean, sRstd, aS, dx, part, row0, M, q4, p4, tid);\n"
     "  KASF_STAMP(8)\n#undef KASF_STAMP\n}\n"),
    (_ONE_DEF, "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n" + _ONE_DEF),
]

# the warp-group dx pass at C = 64: threads 0 and 128 lead groups 0 and 1
PHASES_WG = ("prologue: chunk 0 issued, rows + LayerNorm, block barrier",
             "chunk's wait and group barrier", "next chunk issued", "fc1 and dh (one loop)",
             "group barrier: z and dh in", "dz = dh GELU'(z)",
             "bf16 widening, group barrier: dz in", "da += dz W1c",
             "block barrier: both groups done", "da of the two groups added",
             "epilogue: dx rows, the tile's sums")
_KERNEL_WG = "mlp_ln_bwd_dx_wg_kernel(const T* __restrict__ x"
_WG_DEF = "template <typename T>\n__global__ void __launch_bounds__(dxg::kT, 1)\n"
EDITS_WG = [
    ("  dxp::fetch_chunk<C, kGT>(stage(0), w1, w2, b1, jb, H, gt);\n",
     "  long long kasf_t0 = clock64();\n"
     "  const bool kasf_me = tid == 0 || tid == 128;\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); if (kasf_me) "
     "atomicAdd(&kasf_stamp_sums[tid >> 7][k], n_ - kasf_t0); kasf_t0 = n_; }\n"
     "  dxp::fetch_chunk<C, kGT>(stage(0), w1, w2, b1, jb, H, gt);\n"),
    _at("  // fc1 / dh layout: row group gt / 8, column group gt % 8 (dxp's at C = 64);\n", 0,
        before=True, indent=2),
    _at("    dxg::group_sync(grp);  // this chunk is in; the last chunk's zS and stage are "
        "consumed\n", 1, indent=4),
    _at("    dxg::fc1_dh(aS, dS, w1c, w2c, b1c, zS, hS, q1, p1);\n", 2, before=True, indent=4),
    _at("    dxg::fc1_dh(aS, dS, w1c, w2c, b1c, zS, hS, q1, p1);\n", 3, indent=4),
    _at("    dxg::group_sync(grp);  // z and dh in; bf16: the next chunk landed, W2's buffer "
        "free\n", 4, indent=4),
    _at("    if constexpr (!kF32)  // the next chunk\n      if (j0 + K::kKC < je)\n", 5,
        before=True, indent=4),
    _at("    dxp::da_chunk<K>(zS, w1c, da, q4, p4);\n", 6, before=True, indent=4),
    _at("    dxp::da_chunk<K>(zS, w1c, da, q4, p4);\n", 7, indent=4),
    _at("  // da = aS + dS in the epilogue's layout (16 lanes a row, 4 channels each)\n"
        "  __syncthreads();\n", 8, indent=2),
    _at("  // the sums go through group 0's zS and hS, which no thread reads any more\n", 9,
        before=True, indent=2),
    ("                         qe, pe, tid);\n}\n",
     "                         qe, pe, tid);\n  KASF_STAMP(10)\n#undef KASF_STAMP\n}\n"),
    (_WG_DEF, "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n" + _WG_DEF),
]

# each variant: the kernel's signature, its stamps, the phases' names, the
# chunk phases, the blocks a tile and the hidden columns a thread's chunks
# cover in a tile (the cluster's and the one-block kernel's walk all of H,
# a warp group half of it)
VARIANTS = {
    "cluster": dict(kernel=_KERNEL, edits=EDITS, phases=PHASES, chunk=_CHUNK, blocks=2,
                    walk=1),
    "one-block": dict(kernel=_KERNEL_ONE, edits=EDITS_ONE, phases=PHASES_ONE,
                      chunk=range(1, 8), blocks=1, walk=1),
    "wg": dict(kernel=_KERNEL_WG, edits=EDITS_WG, phases=PHASES_WG, chunk=range(1, 8),
               blocks=1, walk=2),
}
HIDDEN = {64: 256, 128: 512, 256: 1024, 512: 1024}


def variant_of(c: int, text: str) -> str:
    """The dx pass's kernel at width c in a tree whose mlp_ln_bwd.cu is text."""
    if c >= 256:
        return "cluster"
    if c == 64 and "wg" in VARIANTS and VARIANTS["wg"]["kernel"] in text:
        return "wg"
    return "one-block"


def stamped_sources(out: Path, kernel: str = _KERNEL, edits: list = EDITS) -> None:
    """The repository's csrc with the stamps (`edits`) in the kernel whose
    signature starts with `kernel`: by default the cluster dx pass."""
    src = ROOT / "kasportsformer_torch" / "ops" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = (src / "mlp_ln_bwd.cu").read_text()
    if text.count(kernel) != 1:
        raise SystemExit(f"{kernel.split('(')[0]} is not in mlp_ln_bwd.cu")
    for anchor, replacement in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in mlp_ln_bwd.cu: {anchor!r}")
        text = text.replace(anchor, replacement)
    (out / "mlp_ln_bwd.cu").write_text(text + _READER)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, nargs="+", default=[14688])
    parser.add_argument("--c", type=int, nargs="+", default=[512, 256],
                        choices=(64, 128, 256, 512))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = parser.parse_args()
    if args.dtype == "bfloat16" and 128 in args.c:
        parser.error("bf16 at C = 128 runs the tensor-core passes, which carry no stamps; "
                     "scripts/k4_bf16_variants.py times them")

    import torch

    from chip_smoke import card_line, k4_launch_ms, mlp_args, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_kernel_info

    if not torch.cuda.is_available():
        print("k4_dx_stamps: needs a CUDA device")
        return 1
    dev, dt = torch.device("cuda", 0), getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    for c in args.c:
        for m in args.m:
            a = mlp_args(dev, gen, m, dt, c, HIDDEN[c])
            g = torch.randn(m, c, device=dev, generator=gen).to(dt)
            call = (lambda a=a, g=g: fused_mlp_ln_bwd(*a, g, 1e-6))
            cases[(c, m)] = (call, time_ms(call, 10), k4_launch_ms(call, 10)["dx pass"])
    rows = {c: fused_mlp_ln_bwd_kernel_info(dt, 14688, HIDDEN[c], c=c)["dx_pass"]["rows"]
            for c in args.c}

    # the stamped copy, one kernel at a time (they share the device array):
    # _build reads its source and build directories from these two names, so
    # fused_mlp_ln_bwd loads the stamped library from here
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()
    print(card_line())
    for name in dict.fromkeys(variant_of(c, text) for c in args.c):
        v = VARIANTS[name]
        stamps_dir = ROOT / "build" / "stamps" / name
        stamped_sources(stamps_dir / "csrc", v["kernel"], v["edits"])
        _build.CSRC = stamps_dir / "csrc"
        _build.BUILD_DIR = stamps_dir / "kernels"
        _build._libs.pop("mlp_ln_bwd", None)
        lib = _build.library("mlp_ln_bwd")
        read = lib.kasf_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        sums = (ctypes.c_ulonglong * 32)()
        for (c, m), (call, shipped, shipped_dx) in cases.items():
            if variant_of(c, text) != name:
                continue
            hidden = HIDDEN[c]
            chunks = hidden // 32 // v["walk"]
            stamped, stamped_dx = time_ms(call, 10), k4_launch_ms(call, 10)["dx pass"]
            torch.cuda.synchronize()
            _build.check(lib, read(None, 1), "reset the stamps")
            call()
            torch.cuda.synchronize()
            _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
            tiles = -(-m // rows[c]) * v["blocks"]  # block tiles, summed
            print(f"M={m} C/H={c}/{hidden} {args.dtype} ({name} kernel): K4 call "
                  f"{shipped:.4f} ms, stamped {stamped:.4f}; its dx pass (profiler) "
                  f"{shipped_dx:.4f} ms, stamped {stamped_dx:.4f}; cycles a block's tile "
                  f"(mean of {tiles} block tiles; chunk phases over a thread's {chunks} "
                  f"chunks, then a chunk's), thread 0 / 128:")
            total = [0.0, 0.0]
            for k, phase in enumerate(v["phases"]):
                a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
                total[0] += a0
                total[1] += a1
                each = (f"  {a0 / chunks:8.0f} {a1 / chunks:8.0f}" if k in v["chunk"]
                        else "")
                print(f"  {phase:40s} {a0:10.0f} {a1:10.0f}{each}")
            print(f"  {'a tile':40s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
