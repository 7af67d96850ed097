"""The A/B script of K1 at heads of 8 (`scripts/k1_variants.py`) edits a
copy of `csrc/masked_sdpa.cu` at anchors in its text and stops on the card
if one is gone. Here, on the CPU, every variant's anchors, and the cut of
the dispatch to heads of 8, are found once in today's source, so the script
still runs on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import k1_variants  # noqa: E402


@pytest.mark.parametrize("variant", list(k1_variants.VARIANTS))
def test_k1_variants_apply(variant):
    """Each variant applies its edits once; the copy dispatches heads of 8
    alone, and every variant but the kernel as it is changes its source."""
    text = k1_variants.variant_source(k1_variants.VARIANTS[variant][1])
    assert "masked_sdpa_h8_kernel" in text
    assert "launch<T, 16>(q, k, v, out" not in text
    assert (text == k1_variants.variant_source([])) == (variant == "shipped")
