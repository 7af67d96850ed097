#!/usr/bin/env python3
"""K1 at heads of 8 in float32 against edited copies of its kernel, in turns.

Run on the card from the repository root:

    python3 scripts/k1_variants.py [--rounds 4] [--only NAME ...] [--parent FILE]

Each variant is the repository's `csrc/masked_sdpa.cu` with text edits to
the f32 heads-of-8 kernel (`masked_sdpa_h8_kernel`, its tile `Tile8`),
built with every other head width taken out of its dispatch (one nvcc
each, all started together, into `build/k1_variants/<name>/kernels`); the
compiler's registers and spills of the heads-of-8 kernel are printed for
each. An edit replaces one anchor, or the text from a start anchor up to an
end anchor after it; the tiles of two or four sequences and the third stage
replace whole functions. `--parent FILE` adds another version of
`masked_sdpa.cu` (e.g. an older commit's, written out beforehand with `git
show`) as the variant "parent", built as it is. The script runs K1 through
`masked_sdpa` at MotionAGFormer's served shapes (8 heads of 8: spatial (B,
27, 17, 64) and its temporal permutation, strided column slices of one qkv
projection, at B = 128 and 256) with each variant's library in turns
(forward, then reverse order, `--rounds` times) and prints the kernel's time
(CUDA events), the worst error against the plain version (scaled by max(1,
|y|)) and whether a rerun is bitwise equal. An anchor that is not found once
stops the script; the repository's own sources and libraries stay
untouched.
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

# the dispatch over head widths, cut to D = 8
_ONLY8 = [
    ("""    case 16: return launch<T, 16>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, st, B, G, N, H, scale, stream);
""", ""),
    ("""  if (d == 16) describe<T, 16>(info);
  if (d == 32) describe<T, 32>(info);
  if (d == 64) describe<T, 64>(info);
""", ""),
]
_STAGE = "  static constexpr int kStage = 3 * kOperand;\n"
_THREADS = "  static constexpr int kMaxThreads = 32 * ((16 * NB + 31) / 32);\n"
_SMEM = "  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));\n"
_LOAD = "template <int NB>\n__device__ __forceinline__ void load_tile8("
_ROW8 = "// the 8 channels of a head's row in a stage\n"
_LANE = "  // this lane's head and pair of query rows, the same in every tile; the\n"
_RING = "  int t = blockIdx.x;  // the grid has at most one block a tile\n  TileBase cur = tile_base8("
_KERNEL_END = "// blocks of the instantiation resident at once on a device, as\n"
_WALK = "  const int groups = (H + 7) / 8;\n  const long long tiles"
_WALK_END = "  constexpr float kLog2e = 1.4426950408889634f;\n  masked_sdpa_h8_kernel<NB>"
_COMPUTE = "    if (lane_valid)\n      compute8_f32<NB>("
_COPY = "      cp_async16(dst + row * Tl::kPitch, src + row * rs);\n"

# tiles of several (sequence, head group) units: [q, k, v][unit][row]
# [channel] in a stage, a lane a (unit, head, pair of rows), the walk over
# units in tiles of `seqs`, a last tile's missing units neither loaded nor
# stored
_UNITS_LOAD = r"""template <int NB>
__device__ __forceinline__ void load_tile8(float* stage, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v, const SdpaStrides& st,
                                           const Walk8& w, int t, int N) {
  using Tl = Tile8<NB>;
  const int ch = threadIdx.x % 16;
  const int r0 = threadIdx.x / 16, step = blockDim.x / 16;
#pragma unroll
  for (int s = 0; s < Tl::kSeqs; ++s) {
    const int unit = t * Tl::kSeqs + s;
    if (unit >= w.units) break;
    const TileBase tb = tile_base8(unit, w, st);
    if (ch >= tb.heads * 2) continue;
#pragma unroll
    for (int z = 0; z < 3; ++z) {
      const long long rs = z == 0 ? st.q[2] : (z == 1 ? st.k[2] : st.v[2]);
      const float* src = (z == 0 ? q + tb.q : (z == 1 ? k + tb.k : v + tb.v)) + ch * 4;
      float* dst = stage + (z * Tl::kSeqs + s) * Tl::kOperand + ch * 4;
      for (int row = r0; row < N; row += step)
        cp_async16(dst + row * Tl::kPitch, src + row * rs);
    }
  }
}

"""
_UNITS_KERNEL = r"""  const int pairs = (N + 1) / 2;
  const int lane_unit = static_cast<int>(threadIdx.x) / (8 * pairs);
  const bool lane_valid = lane_unit < Tl::kSeqs;
  const int rem = static_cast<int>(threadIdx.x) - lane_unit * 8 * pairs;
  const int lane_head = rem / pairs, lane_row = 2 * (rem - lane_head * pairs);
  __syncthreads();

  int t = blockIdx.x;
  load_tile8<NB>(stages, q, k, v, st, w, t, N);
  cp_async_commit();
  for (int i = 0;; ++i) {
    const int next = t + gridDim.x;
    if (next < w.tiles)
      load_tile8<NB>(stages + ((i + 1) % kStages) * Tl::kStage, q, k, v, st, w, next, N);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (lane_valid) {
      const int unit = t * Tl::kSeqs + lane_unit;
      const bool in = unit < w.units;
      const TileBase tb = tile_base8(in ? unit : 0, w, st);
      const float* stage = stages + (i % kStages) * Tl::kStage;
      compute8_f32<NB>(stage + lane_unit * Tl::kOperand, out, tb, lane_head, lane_row,
                       in && lane_head < tb.heads, st.o[2], N, scale_log2);
    }
    __syncthreads();
    if (next >= w.tiles) break;
    t = next;
  }
}

"""
_UNITS_WALK = r"""  const int groups = (H + 7) / 8;
  const long long units = static_cast<long long>(B) * G * groups;
  if (units > INT32_MAX - Tl::kSeqs * static_cast<long long>(resident))
    return cudaErrorInvalidValue;
  Walk8 w;
  w.units = static_cast<int>(units);
  w.tiles = static_cast<int>((units + Tl::kSeqs - 1) / Tl::kSeqs);
  w.groups = groups;
  w.G = G;
  w.H = H;
  w.by_groups = FastDiv(groups);
  w.by_G = FastDiv(G);
  const unsigned grid = static_cast<unsigned>(w.tiles < resident ? w.tiles : resident);
  const unsigned threads = 32u * ((Tl::kSeqs * 8 * ((N + 1) / 2) + 31) / 32);
"""


def _units(seqs: int) -> list:
    """Tiles of `seqs` units. compute8_f32 is handed the stage from its
    unit's q; its k and v lie kSeqs units further on."""
    return [
        ("  int tiles, groups, G, H;\n", "  int tiles, units, groups, G, H;\n"),
        (_STAGE, f"  static constexpr int kSeqs = {seqs};\n"
                 "  static constexpr int kStage = 3 * kSeqs * kOperand;\n"),
        (_THREADS, "  static constexpr int kMaxThreads = 32 * ((kSeqs * 16 * NB + 31) / 32);\n"),
        ("  const float* ks = stage + Tl::kOperand + h * 8;\n",
         "  const float* ks = stage + Tl::kSeqs * Tl::kOperand + h * 8;\n"),
        ("  const float* vs = stage + 2 * Tl::kOperand + h * 8;\n",
         "  const float* vs = stage + 2 * Tl::kSeqs * Tl::kOperand + h * 8;\n"),
        (_LOAD, _ROW8, _UNITS_LOAD),
        (_LANE, _KERNEL_END, _UNITS_KERNEL),
        (_WALK, _WALK_END, _UNITS_WALK),
    ]


# a ring of three stages: two tiles in flight while one computes
_THREE_STAGES = r"""  int t = blockIdx.x;
  for (int s = 0; s < 2; ++s) {
    const int ts = t + s * gridDim.x;
    if (ts < w.tiles)
      load_tile8<NB>(stages + s * Tl::kStage, q, k, v, st, tile_base8(ts, w, st), N);
    cp_async_commit();
  }
  for (int i = 0;; ++i) {
    const int ahead = t + 2 * gridDim.x;
    if (ahead < w.tiles)
      load_tile8<NB>(stages + ((i + 2) % 3) * Tl::kStage, q, k, v, st,
                     tile_base8(ahead, w, st), N);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    if (lane_valid) {
      const TileBase tb = tile_base8(t, w, st);
      compute8_f32<NB>(stages + (i % 3) * Tl::kStage, out, tb, lane_head, lane_row,
                       lane_head < tb.heads, st.o[2], N, scale_log2);
    }
    __syncthreads();
    t += gridDim.x;
    if (t >= w.tiles) break;
  }
}

"""

VARIANTS = {
    "shipped": ("the kernel as it is: one unit a tile", []),
    "two units": ("tiles of two units", _units(2)),
    "four units": ("tiles of four units", _units(4)),
    "three stages": ("a three-stage ring: two tiles in flight while one computes", [
        (_SMEM, "  static constexpr int kSmem = 3 * kStage * static_cast<int>(sizeof(float));\n"),
        (_RING, _KERNEL_END, _THREE_STAGES)]),
    "diagnostic: loads only": ("the tiles' copies and barriers, no compute (wrong)", [
        (_COMPUTE, "    if (false)\n      compute8_f32<NB>(")]),
    "diagnostic: compute only": ("the compute on the zeroed ring, no copies (wrong)", [
        (_COPY, "      ;\n")]),
}


def variant_source(edits: list) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "masked_sdpa.cu").read_text()
    for edit in _ONLY8 + edits:
        anchor = edit[0]
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in masked_sdpa.cu: {anchor!r}")
        start = text.index(anchor)
        if len(edit) == 2:
            text = text[:start] + edit[1] + text[start + len(anchor):]
            continue
        end = text.find(edit[1], start + len(anchor))
        if end < 0:
            raise SystemExit(f"end anchor not found after {anchor!r}: {edit[1]!r}")
        text = text[:start] + edit[2] + text[end:]
    return text


def ptxas_lines(log: str) -> list[str]:
    """The compiler's lines on the heads-of-8 kernel (each instantiation's
    registers and spills), or on every kernel of a parent without it."""
    lines = log.splitlines()
    key = "h8_kernel" if "h8_kernel" in log else "masked_sdpa_kernel"
    out = []
    for i, line in enumerate(lines):
        if key in line and "Compiling entry" in line:
            out += [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=None)
    parser.add_argument("--parent", type=Path, default=None,
                        help="another masked_sdpa.cu, timed as the variant 'parent'")
    args = parser.parse_args()
    names = args.only or list(VARIANTS)
    sources = {name: variant_source(VARIANTS[name][1]) for name in names}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
        names = ["parent"] + names

    import torch

    from chip_smoke import card_line, mag_sdpa_views, scaled_err, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import masked_sdpa, masked_sdpa_reference

    if not torch.cuda.is_available():
        print("k1_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "k1_variants" / re.sub(r"[^A-Za-z0-9]+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "kasportsformer_torch" / "ops" / "csrc", d / "csrc")
        (d / "csrc" / "masked_sdpa.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "kernels"
        jobs[name] = _build._start("masked_sdpa")
    libs = {}
    print(card_line())
    for name, job in jobs.items():
        log = _build._finish("masked_sdpa", *job)
        libs[name] = ctypes.CDLL(str(job[2]))
        libs[name].kasf_error_string.argtypes = [ctypes.c_int]
        libs[name].kasf_error_string.restype = ctypes.c_char_p
        print(f"{name}: " + " | ".join(ptxas_lines(log)), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 8 ** -0.5
    for dt in (torch.float32,):
        views = {**mag_sdpa_views(dev, gen, dt, 128, ""),
                 **mag_sdpa_views(dev, gen, dt, 256, " B=256")}
        for view, ((q, k, v), heads) in views.items():
            want = masked_sdpa_reference(q.float(), k.float(), v.float(), scale, heads)
            res: dict = {}
            for rnd in range(args.rounds):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    _build._libs["masked_sdpa"] = libs[name]
                    got = masked_sdpa(q, k, v, scale, heads)
                    again = masked_sdpa(q, k, v, scale, heads)
                    ms = time_ms(lambda: masked_sdpa(q, k, v, scale, heads), 50)
                    res.setdefault(name, []).append(
                        (ms, scaled_err(got, want), torch.equal(got, again)))
            for name in names:
                r = res[name]
                what = VARIANTS[name][0] if name in VARIANTS else str(args.parent)
                print(f"{view:22s} {str(dt).split('.')[1]:8s} {tuple(q.shape)} {name:18s} "
                      + " / ".join(f"{ms:.4f}" for ms, _, _ in r)
                      + f" ms; err {max(e for _, e, _ in r):.1e}; reruns bitwise equal "
                      f"{all(s for _, _, s in r)}  ({what})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
