#!/usr/bin/env python3
"""Where a tile of K3's float32 kernel at C <= 128 spends its cycles.

Run on the card from the repository root:

    python3 scripts/k3_tile_stamps.py [--m 58752 14688] [--c 128]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps/csrc`, puts
`clock64` stamps into the copy of `mlp_f32_persistent_kernel`
(`csrc/mlp_tile.cuh`) after each of a tile's phases, builds the copy with
`ops/_build.py` into `build/stamps/kernels` and launches it through
`fused_mlp_ln`. For each M it prints the card, the shipped and the stamped
kernel's times (CUDA events) and each phase's cycles a tile for threads 0
and 128 (sums over every block, over the tiles of the launch). The chunk
phases are summed over a tile's H / 64 chunks. The repository's own
sources and libraries stay untouched; an anchor that is not found in the
source stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("wait for the rows", "LayerNorm", "wait for W1t(j)", "barrier opening chunk j",
          "start copying W2t(j)", "fc1 + GELU", "wait for W2t(j)", "barrier after fc1",
          "start copying W1t(j + 1)", "fc2", "epilogue (first tile: prologue)")
N = len(PHASES)

# (anchor in mlp_tile.cuh, its replacement); every anchor is in the
# persistent kernel and occurs once in the file
_EDITS = [(a, a + add) for a, add in (
    ("  long long t = blockIdx.x;\n",
     "  long long kasf_t0 = clock64();\n"
     f"  unsigned long long kasf_st[{N}] = {{}};\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); "
     "kasf_st[k] += n_ - kasf_t0; kasf_t0 = n_; }\n"),
    ("    const bool next_tile = t + step < tiles;\n", f"    KASF_STAMP({N - 1})\n"),
    ("    kasf_mma::mbar_wait(bar, parity);  // the tile's rows have landed\n",
     "    KASF_STAMP(0)\n"),
    ("    stage_rows_f32<C, LN>(raw, aS, gm, bt, row0, M, eps, warp, lane);\n",
     "    KASF_STAMP(1)\n"),
    ("      kasf_mma::mbar_wait(bar + 1, n & 1);  // W1t(j) has landed\n", "      KASF_STAMP(2)\n"),
    ("      __syncthreads();  // aS staged; hS, W2t and the stage free\n", "      KASF_STAMP(3)\n"),
    ("        fetch_chunk<C>(w2s, w2t, j, bar + 2);\n      }\n", "      KASF_STAMP(4)\n"),
    ("      kasf_mma::mbar_wait(bar + 2, n & 1);  // W2t(j) has landed\n", "      KASF_STAMP(6)\n"),
    ("      __syncthreads();  // hS complete; W1t free\n", "      KASF_STAMP(7)\n"),
    ("        fetch_chunk<C>(w1s, w1t, j + 1 < chunks ? j + 1 : 0, bar + 1);\n",
     "      KASF_STAMP(8)\n"),
    ("      row_product<S::J, S::NH, 64, S::LdH, C>(hS + q * S::LdH, w2s + 4 * p, oacc);\n",
     "      KASF_STAMP(9)\n"),
)] + [
    # fc1 + GELU: everything between the copy of W2t(j) and the wait for it
    ("      kasf_mma::mbar_wait(bar + 2, n & 1);  // W2t(j) has landed\n",
     "      KASF_STAMP(5)\n      kasf_mma::mbar_wait(bar + 2, n & 1);  // W2t(j) has landed\n"),
    ("// Blocks walk the tiles blockIdx.x",
     "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n"
     "// Blocks walk the tiles blockIdx.x"),
    ("  }\n}\n\n// ---- bfloat16 on the tensor cores",
     "  }\n  if (tid == 0 || tid == 128)\n"
     f"    for (int k = 0; k < {N}; ++k) atomicAdd(&kasf_stamp_sums[tid >> 7][k], kasf_st[k]);\n"
     "#undef KASF_STAMP\n}\n\n// ---- bfloat16 on the tensor cores"),
]
_READER = """
extern "C" int kasf_stamps(unsigned long long* host, int reset) {
  if (reset) {
    static const unsigned long long zero[32] = {};
    return cudaMemcpyToSymbol(kasf_tile::kasf_stamp_sums, zero, sizeof zero);
  }
  return cudaMemcpyFromSymbol(host, kasf_tile::kasf_stamp_sums, 32 * sizeof(unsigned long long));
}
"""


def stamped_sources(out: Path) -> None:
    """The repository's csrc with the stamps in the persistent kernel."""
    src = ROOT / "kasportsformer_torch" / "ops" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = (src / "mlp_tile.cuh").read_text()
    for anchor, replacement in _EDITS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in mlp_tile.cuh: {anchor!r}")
        text = text.replace(anchor, replacement)
    # a namespace of its own: the static locals of the launchers' templates
    # are unique symbols, which the loader would share with the shipped
    # library's in this process
    rename = ("kasf_tile::", "kasf_tile_stamped::")
    (out / "mlp_tile.cuh").write_text(
        text.replace("namespace kasf_tile {", "namespace kasf_tile_stamped {"))
    (out / "mlp_ln.cu").write_text(
        ((src / "mlp_ln.cu").read_text() + _READER).replace(*rename))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, nargs="+", default=[58752, 14688])
    parser.add_argument("--c", type=int, default=128, choices=(64, 128))
    args = parser.parse_args()

    import torch

    from chip_smoke import card_line, mlp_args, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln, fused_mlp_ln_kernel_info

    if not torch.cuda.is_available():
        print("k3_tile_stamps: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    hidden = 4 * args.c
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = {m: mlp_args(dev, gen, m, torch.float32, args.c, hidden) for m in args.m}
    shipped = {m: time_ms(lambda: fused_mlp_ln(*a, 1e-5), 20) for m, a in inputs.items()}
    rows = fused_mlp_ln_kernel_info(torch.float32, args.c)["rows"]

    # the stamped copy: _build reads its source and build directories from
    # these two names, so fused_mlp_ln loads the stamped library from here on
    stamps_dir = ROOT / "build" / "stamps"
    stamped_sources(stamps_dir / "csrc")
    _build.CSRC = stamps_dir / "csrc"
    _build.BUILD_DIR = stamps_dir / "kernels"
    _build._libs.pop("mlp_ln", None)
    lib = _build.library("mlp_ln")
    read = lib.kasf_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 32)()
    print(card_line())
    for m, a in inputs.items():
        stamped = time_ms(lambda: fused_mlp_ln(*a, 1e-5), 20)
        torch.cuda.synchronize()
        _build.check(lib, read(None, 1), "reset the stamps")
        fused_mlp_ln(*a, 1e-5)
        torch.cuda.synchronize()
        _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
        tiles = -(-m // rows)
        print(f"M={m} C/H={args.c}/{hidden} float32: kernel {shipped[m]:.4f} ms, "
              f"stamped {stamped:.4f} ms; cycles a tile (mean of {tiles} tiles), "
              "thread 0 / thread 128:")
        total = [0, 0]
        for k, name in enumerate(PHASES):
            a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
            total[0] += a0
            total[1] += a1
            print(f"  {name:32s} {a0:10.0f} {a1:10.0f}")
        print(f"  {'a tile':32s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
