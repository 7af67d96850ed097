"""The `clock64` stamp script of K2's tile (`scripts/k2_tile_stamps.py`)
edits a copy of `csrc/masked_sdpa_bwd.cu` at anchors in its text and stops
on the card if one is gone. Here, on the CPU, its anchors are found once in
today's source and each phase of a tile gets its stamp, with and without
the grid of one block a SM, so the script still runs on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import k2_tile_stamps  # noqa: E402


@pytest.mark.parametrize("one_block", [False, True], ids=["resident", "one-block"])
def test_k2_tile_stamps_apply(tmp_path, one_block):
    """The copy holds one stamp a phase (and the macro's definition), the
    device array, the reader, and with `--one-block` a grid of one block a
    SM in place of the blocks the card holds."""
    k2_tile_stamps.stamped_sources(tmp_path / "csrc", one_block)
    text = (tmp_path / "csrc" / "masked_sdpa_bwd.cu").read_text()
    stamps = [f"KASF_STAMP({k})" for k in range(len(k2_tile_stamps.PHASES))]
    assert all(text.count(s) == 1 for s in stamps)
    assert text.count("KASF_STAMP(") == 1 + len(stamps)
    assert "kasf_stamp_sums[2][16]" in text and "kasf_stamps(" in text
    assert ("cached[dev] = sms;" in text) == one_block
    assert len(k2_tile_stamps.PHASES) <= 16  # the device array's row
