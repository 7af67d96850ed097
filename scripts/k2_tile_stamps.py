#!/usr/bin/env python3
"""Where a tile of K2 (the masked-attention backward) spends its cycles.

Run on the card from the repository root:

    python3 scripts/k2_tile_stamps.py [--d 16|8] [--one-block]

It copies `kasportsformer_torch/ops/csrc` to `build/stamps_k2/csrc`, puts
`clock64` stamps into the copy of `masked_sdpa_bwd.cu` after each phase of a
tile (with `--one-block`, also a persistent grid of one block a SM in place
of the blocks the card holds at once), builds the copy with `ops/_build.py`
into `build/stamps_k2/kernels` and launches it through `masked_sdpa_bwd` at
a train step's shapes, 8 heads of width `--d`: the flagship's at 16
(spatial (32, 27, 17, 128), temporal (32, 17, 27, 128)), MotionAGFormer-XS's
and hierarchical's at 8 (spatial (32, 27, 17, 64), temporal (32, 17, 27,
64)); column slices of one qkv projection, temporally their permuted views
and a transposed gradient; float32 and bfloat16 (bfloat16 at 16 runs
`masked_sdpa_bwd_mma_kernel`, which has no stamps, and is skipped). For
each it prints the
card, the shipped and the stamped kernel's times (CUDA events), the stamped
kernel's largest error against the plain version in float32, the heads a
tile, and each phase's cycles a tile for threads 0 and 128 (sums over every
block and tile of the launch, over the tiles). The repository's own sources
and libraries stay untouched; an anchor that is not found in the source
stops the script. The anchors hold in the sources since the D = 8 tile of
eight heads and in those before it, so the script stamps either tree.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("issue the next tile's copies", "wait for the tile", "widen (bf16)", "pass 1",
          "barrier after pass 1", "pass 2", "barrier after pass 2")
_N = len(PHASES)


def _after(anchor: str, k: int) -> tuple[str, str]:
    return anchor, anchor + f"    KASF_STAMP({k})\n"


EDITS = [
    ("  int t = blockIdx.x;  // the grid has at most one block a tile\n",
     "  int t = blockIdx.x;  // the grid has at most one block a tile\n"
     "  long long kasf_t0 = clock64();\n"
     f"  unsigned long long kasf_st[{_N}] = {{}};\n"
     "#define KASF_STAMP(k) { const long long n_ = clock64(); "
     "kasf_st[k] += n_ - kasf_t0; kasf_t0 = n_; }\n"),
    _after("q, k, v, g, st, nb, G, N, lane);\n    }\n", 0),
    _after("    mbar_wait(bar + it % kStages, (it / kStages) & 1);  // the tile has landed\n", 1),
    _after("(landed, wide, cur.heads, N);\n      __syncthreads();\n", 2),
    _after("    pass1<T, D, NB>(stage, pt, dst, cur.heads, N, scale);\n", 3),
    _after("    __syncthreads();  // P^T and dS^T complete\n", 4),
    _after("    pass2<T, D, NB>(stage, pt, dst, dq, dk, dv, cur, N, C);\n", 5),
    _after("    __syncthreads();  // the stage, P^T and dS^T are free before they refill\n", 6),
    ("    t = next;\n    cur = nb;\n  }\n}\n",
     "    t = next;\n    cur = nb;\n  }\n"
     "  if (threadIdx.x == 0 || threadIdx.x == 128)\n"
     f"    for (int k = 0; k < {_N}; ++k) "
     "atomicAdd(&kasf_stamp_sums[threadIdx.x >> 7][k], kasf_st[k]);\n"
     "#undef KASF_STAMP\n}\n"),
    ("// ------------------------------------------------------------------ kernel\n",
     "// ------------------------------------------------------------------ kernel\n"
     "__device__ unsigned long long kasf_stamp_sums[2][16];\n"),
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
_GRID = "    cached[dev] = per_sm * sms;\n"


def stamped_sources(out: Path, one_block: bool) -> None:
    """The repository's csrc with the stamps in K2 (and one block a SM)."""
    src = ROOT / "kasportsformer_torch" / "ops" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = (src / "masked_sdpa_bwd.cu").read_text()
    edits = list(EDITS)
    if one_block:
        edits.append((_GRID, "    cached[dev] = sms;\n"))
    for anchor, replacement in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in masked_sdpa_bwd.cu: {anchor!r}")
        text = text.replace(anchor, replacement)
    # the reader goes inside the file's anonymous namespace's translation unit
    (out / "masked_sdpa_bwd.cu").write_text(text + _READER)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--d", type=int, default=16, choices=(16, 8),
                        help="head width: the flagship's 16 or MotionAGFormer-XS's 8")
    parser.add_argument("--one-block", action="store_true")
    args = parser.parse_args()

    import torch

    from chip_smoke import card_line, scaled_err, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import (masked_sdpa_bwd,
                                                    masked_sdpa_bwd_kernel_info,
                                                    masked_sdpa_bwd_reference)

    if not torch.cuda.is_available():
        print("k2_tile_stamps: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    heads, scale = 8, args.d ** -0.5
    c = heads * args.d
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        if masked_sdpa_bwd_kernel_info(dt, 17, d=args.d).get("mma"):
            continue  # the tensor-core kernel: no stamps
        qkv = torch.randn(32, 27, 17, 3 * c, device=dev, generator=gen).to(dt)
        gfull = torch.randn(32, 27, 17, c, device=dev, generator=gen).to(dt)
        q, k, v = qkv.split(c, dim=-1)
        cases[("spatial", dt)] = (q, k, v, gfull)
        cases[("temporal", dt)] = tuple(z.transpose(1, 2) for z in (q, k, v, gfull))
    shipped = {key: time_ms(lambda: masked_sdpa_bwd(*a, scale, heads), 50)
               for key, a in cases.items()}

    # the stamped copy: _build reads its source and build directories from
    # these two names, so masked_sdpa_bwd loads the stamped library from here on
    stamps_dir = ROOT / "build" / "stamps_k2"
    stamped_sources(stamps_dir / "csrc", args.one_block)
    _build.CSRC = stamps_dir / "csrc"
    _build.BUILD_DIR = stamps_dir / "kernels"
    _build._libs.pop("masked_sdpa_bwd", None)
    lib = _build.library("masked_sdpa_bwd")
    read = lib.kasf_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 32)()
    print(card_line())
    for (mode, dt), a in cases.items():
        stamped = time_ms(lambda: masked_sdpa_bwd(*a, scale, heads), 50)
        got = masked_sdpa_bwd(*a, scale, heads)
        want = masked_sdpa_bwd_reference(*(z.float() for z in a), scale, heads)
        err = max(scaled_err(x, w) for x, w in zip(got, want))
        torch.cuda.synchronize()
        _build.check(lib, read(None, 1), "reset the stamps")
        masked_sdpa_bwd(*a, scale, heads)
        torch.cuda.synchronize()
        _build.check(lib, read(ctypes.addressof(sums), 0), "read the stamps")
        b, g, n, _ = a[0].shape
        tile_heads = masked_sdpa_bwd_kernel_info(dt, n, d=args.d)["tile_heads"]
        tiles = b * g * -(-heads // tile_heads)
        print(f"{mode} {str(dt).split('.')[1]} {tuple(a[0].shape)}, {tile_heads} heads a "
              f"tile{', one block a SM' if args.one_block else ''}: kernel {shipped[(mode, dt)]:.4f} ms, stamped {stamped:.4f} ms "
              f"(err {err:.2e}); cycles a tile (mean of {tiles}), thread 0 / thread 128:")
        total = [0, 0]
        for k, name in enumerate(PHASES):
            a0, a1 = sums[k] / tiles, sums[16 + k] / tiles
            total[0] += a0
            total[1] += a1
            print(f"  {name:30s} {a0:10.0f} {a1:10.0f}")
        print(f"  {'a tile':30s} {total[0]:10.0f} {total[1]:10.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
