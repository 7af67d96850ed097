#!/usr/bin/env python3
"""Where a tile of K3's float32 kernel spends its cycles.

Run on the card from the repository root:

    python3 scripts/k3_tile_stamps.py [--m 58752 14688] [--c 128]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps/csrc`, puts
`clock64` stamps into the copy of the float32 kernel of that width
(`csrc/mlp_tile.cuh`: `mlp_f32_persistent_kernel` at C <= 128,
`mlp_f32_cluster_kernel` at C = 256 and 512, at H = 4C and 1024) after each
of a tile's phases, builds the copy with `ops/_build.py` into
`build/stamps/kernels` and launches it through `fused_mlp_ln`. For each M it
prints the card, the shipped and the stamped kernel's times (CUDA events)
and each phase's cycles a tile for threads 0 and 128 (sums over every
block, over the tiles of the launch; at C >= 256 a tile is a cluster's, and
the mean is a block's share of it). The chunk phases are summed over a
tile's H / 64 chunks. The repository's own sources and libraries stay
untouched; an anchor that is not found in the source stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _clock(n: int, anchor: str) -> tuple[str, str]:
    """The stamp declarations, after `anchor` (once per kernel)."""
    return (anchor, anchor + "  long long kasf_t0 = clock64();\n"
            f"  unsigned long long kasf_st[{n}] = {{}};\n"
            "#define KASF_STAMP(k) { const long long n_ = clock64(); "
            "kasf_st[k] += n_ - kasf_t0; kasf_t0 = n_; }\n")


def _sums(n: int, end: str, after: str) -> tuple[str, str]:
    """The per-thread stamps added into kasf_stamp_sums at the kernel's
    end (`end`, followed in the file by `after`)."""
    return (end + after, end[:-2] + "  if (tid == 0 || tid == 128)\n"
            f"    for (int k = 0; k < {n}; ++k) "
            "atomicAdd(&kasf_stamp_sums[tid >> 7][k], kasf_st[k]);\n"
            "#undef KASF_STAMP\n}\n" + after)


_DECL = ("// Blocks walk the tiles blockIdx.x",
         "__device__ unsigned long long kasf_stamp_sums[2][16];\n\n"
         "// Blocks walk the tiles blockIdx.x")

# the persistent kernel (C <= 128)
PHASES_ROWS = ("wait for the rows", "LayerNorm", "wait for W1t(j)", "barrier opening chunk j",
               "start copying W2t(j)", "fc1 + GELU", "wait for W2t(j)", "barrier after fc1",
               "start copying W1t(j + 1)", "fc2", "epilogue (first tile: prologue)")
_N = len(PHASES_ROWS)
# (anchor in mlp_tile.cuh, its replacement); every anchor is in the
# persistent kernel and occurs once in the file
EDITS_ROWS = [_clock(_N, "  long long t = blockIdx.x;\n")] + [(a, a + add) for a, add in (
    ("    const bool next_tile = t + step < tiles;\n", f"    KASF_STAMP({_N - 1})\n"),
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
    _DECL,
    _sums(_N, "        st4(out + row * C + c, y);\n      }\n    }\n  }\n}\n",
          "\n// ---- float32 on the CUDA cores, C = 256 and 512"),
]

# the cluster kernel (C = 256 and 512)
PHASES_CLUSTER = ("rows + LayerNorm (two exchanges)", "barrier after LayerNorm, W1t wait",
                  "fc1, channel groups summed", "b1 loaded", "wait for W2t", "fc2",
                  "own slot stored, block barrier", "weight copies started",
                  "partial sums sent (st.async)", "wait for the partial sums",
                  "reduce-scatter, GELU, all-gather", "wait for W1t(g + 1)",
                  "wait for the hidden (hS)", "epilogue (first tile: prologue)")
_NC = len(PHASES_CLUSTER)


def _at(anchor: str, k: int, before: bool = False, indent: int = 6) -> tuple[str, str]:
    """Stamp phase k just after (or before) `anchor`."""
    stamp = " " * indent + f"KASF_STAMP({k})\n"
    return anchor, stamp + anchor if before else anchor + stamp


_COMBINE = "combine_groups<S::KS>(zf, z, kg);\n"
_FC2 = "cluster_fc2<C>(oacc, hS, w2s, p, q);\n"
_W2T = "mbar_wait(bar + 1, static_cast<unsigned>(g - 1) & 1u);  // "
_RECV = ("      mbar_wait_cluster(bar + 2, static_cast<unsigned>(g) & 1u);  "
         "// every partial sum is in\n")
EDITS_CLUSTER = [
    _clock(_NC, "  long long g = 0;  // the block's chunks so far, over its tiles\n"),
    _at("    const long long row0 = (cid + k * ncl) * S::R;\n", 13, indent=4),
    _at("    stage_rows_cluster<C, LN>(x, aS, stats, gm, bt, row0, M, eps, rank, warp, "
        "lane);\n", 0, indent=4),
    _at("    mbar_wait(bar, static_cast<unsigned>(g) & 1u);  // W1t(g) has landed\n", 1,
        indent=4),
    _at("    " + _COMBINE + "\n", 2, indent=4),
    _at("      if (j > 0) {\n", 3, before=True),
    _at("        " + _W2T + "W2t(g - 1) has landed\n", 4, indent=8),
    _at("        " + _FC2 + "      }\n", 5),
    _at("      // proxy fence); its own slot of recv is in\n", 6),
    _at("        bulk_load(w2s, w2b + static_cast<long long>(j) * S::J * S::CS, "
        "S::kChunkBytes, bar + 1);\n      }\n", 7),
    _at(_RECV, 8, before=True),
    _at(_RECV, 9),
    _at("      if (j + 1 < chunks) {  // fc1 of chunk g + 1 while the hidden arrives\n", 10,
        before=True),
    _at("        mbar_wait(bar, static_cast<unsigned>(g + 1) & 1u);  // W1t(g + 1) has "
        "landed\n", 11, indent=8),
    _at("        " + _COMBINE + "      }\n", 2),
    _at("      mbar_wait_cluster(bar + 3, static_cast<unsigned>(g) & 1u);  // every column is "
        "in hS\n", 12),
    _at("    " + _W2T + "the tile's last W2t\n", 4, indent=4),
    _at("    " + _FC2 + "\n", 5, indent=4),
    _DECL,
    _sums(_NC, "        st4(out + row * C + c, y);\n      }\n    }\n  }\n}\n",
          "\n// ---- bfloat16 on the tensor cores"),
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


def stamped_sources(out: Path, edits: list) -> None:
    """The repository's csrc with the stamps of `edits` in one kernel."""
    src = ROOT / "kasportsformer_torch" / "ops" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = (src / "mlp_tile.cuh").read_text()
    for anchor, replacement in edits:
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
    parser.add_argument("--c", type=int, default=128, choices=(64, 128, 256, 512))
    args = parser.parse_args()
    cluster = args.c >= 256
    phases, edits = ((PHASES_CLUSTER, EDITS_CLUSTER) if cluster
                     else (PHASES_ROWS, EDITS_ROWS))

    import torch

    from chip_smoke import card_line, mlp_args, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln, fused_mlp_ln_kernel_info

    if not torch.cuda.is_available():
        print("k3_tile_stamps: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    hidden = 1024 if cluster else 4 * args.c
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = {m: mlp_args(dev, gen, m, torch.float32, args.c, hidden) for m in args.m}
    shipped = {m: time_ms(lambda: fused_mlp_ln(*a, 1e-5), 20) for m, a in inputs.items()}
    info = fused_mlp_ln_kernel_info(torch.float32, args.c)
    rows, blocks_a_tile = info["rows"], info["cluster"]

    # the stamped copy: _build reads its source and build directories from
    # these two names, so fused_mlp_ln loads the stamped library from here on
    stamps_dir = ROOT / "build" / "stamps"
    stamped_sources(stamps_dir / "csrc", edits)
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
        tiles = -(-m // rows) * blocks_a_tile  # a block's tiles, summed
        print(f"M={m} C/H={args.c}/{hidden} float32: kernel {shipped[m]:.4f} ms, "
              f"stamped {stamped:.4f} ms; cycles a tile (mean of {tiles} "
              f"block tiles, {blocks_a_tile} a tile), thread 0 / thread 128:")
        total = [0, 0]
        for k, name in enumerate(phases):
            a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
            total[0] += a0
            total[1] += a1
            print(f"  {name:32s} {a0:10.0f} {a1:10.0f}")
        print(f"  {'a tile':32s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
