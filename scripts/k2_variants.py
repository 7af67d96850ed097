#!/usr/bin/env python3
"""K2 at heads of 8 against edited copies of its kernel, in turns.

Run on the card from the repository root:

    python3 scripts/k2_variants.py [--rounds 4] [--only NAME ...]

Each variant is the repository's `csrc/masked_sdpa_bwd.cu` with a few text
edits, built with every head width but 8 taken out of its dispatch (one
nvcc each, all started together, into `build/k2_variants/<name>/kernels`).
For each dtype the script runs K2 through `masked_sdpa_bwd` at
MotionAGFormer-XS's train-step shapes (8 heads of 8: spatial (32, 27, 17,
64); temporal (32, 17, 27, 64), the permuted views with a transposed
gradient) with each variant's library in turns (forward, then reverse
order, `--rounds` times) and prints the kernel's time (CUDA events), the
worst error against the plain version in f32 (scaled by max(1, |y|)) and
whether a rerun is bitwise equal. An anchor that is not found once stops
the script; the repository's own sources and libraries stay untouched.
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
    ("""    case 16: return launch_rows<T, 16>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    case 32: return launch_rows<T, 32>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    case 64: return launch_rows<T, 64>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
""", ""),
    ("""  if (d == 16) describe_rows<T, 16>(n, info);
  if (d == 32) describe_rows<T, 32>(n, info);
  if (d == 64) describe_rows<T, 64>(n, info);
""", ""),
]
_WAIT = "    mbar_wait(bar + it % kStages, (it / kStages) & 1);  // the tile has landed\n"
_NEXT = "    const int next = t + gridDim.x;\n"
_PACK = ("  const int ib = !valid ? 0 : D == 8 ? grp % NB : grp / heads;\n"
         "  const int h = !valid ? 0 : D == 8 ? grp / NB : grp - ib * heads;\n")
_BLOCK = "  static constexpr int kPBlock = 4 * kPPitch + (D == 8 ? 4 : 0);\n"
_HEAD = "  static constexpr int kPHead = D == 8 ? kPKeys + (kPKeys % 8 == 4 ? 0 : 4)\n"

VARIANTS = {
    "shipped": ("the kernel as it is", []),
    "heads fastest": ("pass 1's groups packed heads fastest, as at D = 16", [
        (_PACK, "  const int ib = !valid ? 0 : grp / heads;\n"
                "  const int h = !valid ? 0 : grp - ib * heads;\n")]),
    "unpadded key blocks": ("P^T's key blocks 4 x pitch floats, heads 16 banks apart", [
        (_BLOCK, "  static constexpr int kPBlock = 4 * kPPitch;\n"),
        (_HEAD, "  static constexpr int kPHead = false ? 0\n")]),
    "dq eight channels": ("pass 2's dq lanes over eight channels, as at D >= 16", [
        ("  constexpr int Q = D == 8 ? 1 : 2;  // dq's float4s a lane\n",
         "  constexpr int Q = 2;\n")]),
    "land first": ("a tile's copies land before the next tile's are issued", [
        (_WAIT, ""), (_NEXT, _WAIT + _NEXT)]),
}


def variant_source(edits: list) -> str:
    text = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "masked_sdpa_bwd.cu").read_text()
    for anchor, replacement in _ONLY8 + edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in masked_sdpa_bwd.cu: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=None)
    args = parser.parse_args()
    names = args.only or list(VARIANTS)
    sources = {name: variant_source(VARIANTS[name][1]) for name in names}

    import torch

    from chip_smoke import card_line, scaled_err, time_ms
    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import masked_sdpa_bwd, masked_sdpa_bwd_reference

    if not torch.cuda.is_available():
        print("k2_variants: needs a CUDA device")
        return 1
    jobs = {}
    for name, text in sources.items():
        d = ROOT / "build" / "k2_variants" / re.sub(r"[^A-Za-z0-9]+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "kasportsformer_torch" / "ops" / "csrc", d / "csrc")
        (d / "csrc" / "masked_sdpa_bwd.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "kernels"
        jobs[name] = _build._start("masked_sdpa_bwd")
    libs = {}
    for name, job in jobs.items():
        _build._finish("masked_sdpa_bwd", *job)
        libs[name] = ctypes.CDLL(str(job[2]))
    print(card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    scale = 8 ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(32, 27, 17, 192, device=dev, generator=gen).to(dt)
        gfull = torch.randn(32, 27, 17, 64, device=dev, generator=gen).to(dt)
        q, k, v = qkv.split(64, dim=-1)
        for mode, a in (("spatial", (q, k, v, gfull)),
                        ("temporal", tuple(z.transpose(1, 2) for z in (q, k, v, gfull)))):
            want = masked_sdpa_bwd_reference(*(z.float() for z in a), scale, 8)
            res: dict = {}
            for rnd in range(args.rounds):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    _build._libs["masked_sdpa_bwd"] = libs[name]
                    got = masked_sdpa_bwd(*a, scale, 8)
                    again = masked_sdpa_bwd(*a, scale, 8)
                    err = max(scaled_err(x, w) for x, w in zip(got, want))
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    ms = time_ms(lambda: masked_sdpa_bwd(*a, scale, 8), 50)
                    res.setdefault(name, []).append((ms, err, same))
            for name in names:
                r = res[name]
                print(f"{mode:8s} {str(dt).split('.')[1]:8s} {tuple(a[0].shape)} {name:20s} "
                      + " / ".join(f"{ms:.4f}" for ms, _, _ in r)
                      + f" ms; err {max(e for _, e, _ in r):.1e}; reruns bitwise equal "
                      f"{all(s for _, _, s in r)}  ({VARIANTS[name][0]})", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
