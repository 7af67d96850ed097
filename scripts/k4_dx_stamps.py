#!/usr/bin/env python3
"""Where a tile of K4's cluster dx pass spends its cycles.

Run on the card from the repository root:

    python3 scripts/k4_dx_stamps.py [--m 14688] [--c 512 256] [--dtype float32]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps/csrc`, puts
`clock64` stamps into the copy of `mlp_ln_bwd_dx_cluster_kernel`
(`csrc/mlp_ln_bwd.cu`, C = 256 and 512) after each of a tile's phases
(threads 0 and 128 add each phase's cycles into a device array as they go,
so the stamps take no registers of the others),
builds the copy with `ops/_build.py` into `build/stamps/kernels` and
launches it through `fused_mlp_ln_bwd` at C/H = C/1024. For each width and M
it prints the card, the shipped and the stamped K4 call's times (CUDA
events) and each phase's cycles for threads 0 and 128 (sums over every
block and tile of the launch, divided by the block tiles: a tile is a
cluster's, so the figures are a block's share of one): the chunk phases
summed over a tile's H / 32 chunks, and a chunk's mean beside them. The
repository's own sources and libraries stay untouched; an anchor that is
not found once in the source stops the script.
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
    parser.add_argument("--c", type=int, nargs="+", default=[512, 256], choices=(256, 512))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = parser.parse_args()

    import torch

    from chip_smoke import card_line, k4_launch_ms, mlp_args, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_kernel_info

    if not torch.cuda.is_available():
        print("k4_dx_stamps: needs a CUDA device")
        return 1
    dev, dt, hidden = torch.device("cuda", 0), getattr(torch, args.dtype), 1024
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    for c in args.c:
        for m in args.m:
            a = mlp_args(dev, gen, m, dt, c, hidden)
            g = torch.randn(m, c, device=dev, generator=gen).to(dt)
            call = (lambda a=a, g=g: fused_mlp_ln_bwd(*a, g, 1e-6))
            cases[(c, m)] = (call, time_ms(call, 10), k4_launch_ms(call, 10)["dx pass"])
    rows = {c: fused_mlp_ln_bwd_kernel_info(dt, 14688, hidden, c=c)["dx_pass"]["rows"]
            for c in args.c}

    # the stamped copy: _build reads its source and build directories from
    # these two names, so fused_mlp_ln_bwd loads the stamped library from here
    stamps_dir = ROOT / "build" / "stamps"
    stamped_sources(stamps_dir / "csrc")
    _build.CSRC = stamps_dir / "csrc"
    _build.BUILD_DIR = stamps_dir / "kernels"
    _build._libs.pop("mlp_ln_bwd", None)
    lib = _build.library("mlp_ln_bwd")
    read = lib.kasf_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 32)()
    chunks = hidden // 32
    print(card_line())
    for (c, m), (call, shipped, shipped_dx) in cases.items():
        stamped, stamped_dx = time_ms(call, 10), k4_launch_ms(call, 10)["dx pass"]
        torch.cuda.synchronize()
        _build.check(lib, read(None, 1), "reset the stamps")
        call()
        torch.cuda.synchronize()
        _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
        tiles = -(-m // rows[c]) * 2  # block tiles, summed
        print(f"M={m} C/H={c}/{hidden} {args.dtype}: K4 call {shipped:.4f} ms, stamped "
              f"{stamped:.4f}; its dx pass (profiler) {shipped_dx:.4f} ms, stamped "
              f"{stamped_dx:.4f}; cycles a block's tile (mean of {tiles} block tiles; "
              f"chunk phases over its {chunks} chunks, then a chunk's), thread 0 / 128:")
        total = [0.0, 0.0]
        for k, name in enumerate(PHASES):
            a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
            total[0] += a0
            total[1] += a1
            each = f"  {a0 / chunks:8.0f} {a1 / chunks:8.0f}" if k in _CHUNK else ""
            print(f"  {name:36s} {a0:10.0f} {a1:10.0f}{each}")
        print(f"  {'a tile':36s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
