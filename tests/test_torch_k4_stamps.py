"""The `clock64` stamp scripts of K4's passes (`scripts/k4_dx_stamps.py`,
`scripts/k4_w_stamps.py`, each pass's kernel at every width) and the A/B scripts of the dx
pass, the reduce and the bf16 passes at C = 128 (`scripts/k4_dx_variants.py`,
`scripts/k4_reduce_variants.py`, `scripts/k4_bf16_variants.py`) edit a
copy of `csrc/mlp_ln_bwd.cu` at
anchors in its text and stop on the card if one is gone. Here, on the CPU,
every variant's anchors are found once in today's source and each phase
gets its stamp, so the scripts still run on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import k4_bf16_variants  # noqa: E402
import k4_dx_stamps  # noqa: E402
import k4_dx_variants  # noqa: E402
import k4_reduce_variants  # noqa: E402
import k4_w_stamps  # noqa: E402

SOURCE = (ROOT / "kasportsformer_torch" / "ops" / "csrc" / "mlp_ln_bwd.cu").read_text()


def _stamped(tmp_path, kernel: str, edits: list) -> str:
    k4_dx_stamps.stamped_sources(tmp_path / "csrc", kernel, edits)
    return (tmp_path / "csrc" / "mlp_ln_bwd.cu").read_text()


@pytest.mark.parametrize("variant", sorted(k4_dx_stamps.VARIANTS))
def test_dx_pass_stamps_apply(tmp_path, variant):
    """Each dx-pass kernel's copy holds one stamp a phase (and the macro's
    definition), the device array and the reader."""
    v = k4_dx_stamps.VARIANTS[variant]
    text = _stamped(tmp_path, v["kernel"], v["edits"])
    stamps = {f"KASF_STAMP({k})" for k in range(len(v["phases"]))}
    assert all(text.count(s) >= 1 for s in stamps), variant
    assert text.count("KASF_STAMP(") == 1 + sum(text.count(s) for s in stamps)
    assert "kasf_stamp_sums[2][16]" in text and "kasf_stamps(" in text
    assert len(v["phases"]) <= 16  # the device array's row


@pytest.mark.parametrize("variant", sorted(k4_w_stamps.VARIANTS))
def test_weight_pass_stamps_apply(tmp_path, variant):
    """Each weight-pass kernel's copy (the cluster kernel at C = 256 and
    512, the one-block kernel at 128, the 3xTF32 kernel at 64) holds one
    stamp a phase (and the macro's definition), the device array and the
    reader; the 3xTF32 kernel's diagnostic edits apply on top of them."""
    v = k4_w_stamps.VARIANTS[variant]
    text = _stamped(tmp_path, v["kernel"], v["edits"] + v.get("mma_only", []))
    stamps = {f"KASF_STAMP({k})" for k in range(len(v["phases"]))}
    assert all(text.count(s) == 1 for s in stamps), variant
    assert text.count("KASF_STAMP(") == 1 + len(stamps)
    assert "kasf_stamp_sums[2][16]" in text and "kasf_stamps(" in text
    assert len(v["phases"]) <= 16 and set(v["once"]) < set(range(len(v["phases"])))


def test_weight_stamps_pick_each_widths_kernel():
    """C = 64 stamps the 3xTF32 kernel, 128 the one-block one, 256 and 512
    the cluster one."""
    assert [k4_w_stamps.variant_of(c, SOURCE) for c in (64, 128, 256, 512)] == [
        "tc", "one-block", "cluster", "cluster"]


def test_dx_stamps_pick_each_widths_kernel():
    """C = 64 stamps the warp-group kernel, 128 the one-block one, 256 and
    512 the cluster one."""
    assert [k4_dx_stamps.variant_of(c, SOURCE) for c in (64, 128, 256, 512)] == [
        "wg", "one-block", "cluster", "cluster"]


@pytest.mark.parametrize("variant", list(k4_dx_variants.VARIANTS))
def test_dx_pass_variants_apply(variant):
    """Each A/B variant's edits (and the cut to C = 64) apply once; every
    variant but the kernel as it is changes the warp-group kernel."""
    text = k4_dx_variants.variant_source(k4_dx_variants.VARIANTS[variant][1])
    assert "mlp_ln_bwd_dx_wg_kernel" in text
    assert "std::integral_constant<int, 128>" not in text
    assert (text == k4_dx_variants.variant_source([])) == (variant == "shipped")


@pytest.mark.parametrize("c,variant", [(c, v) for c, w in sorted(k4_reduce_variants.WIDTHS.items())
                                       for v in w[2]])
def test_reduce_variants_apply(c, variant):
    """Each A/B variant of the reduce (at C = 64 its segment kernel, at 512
    its kernel of equal blocks) applies its edits and the cut to that width
    once; every variant but the kernel as it is changes the source."""
    text = k4_reduce_variants.variant_source(k4_reduce_variants.WIDTHS[c][2][variant][1], c)
    assert "std::integral_constant<int, 128>" not in text
    assert f"return f(std::integral_constant<int, {c}>{{}});" in text
    assert (text == k4_reduce_variants.variant_source([], c)) == (variant == "shipped")


@pytest.mark.parametrize("variant", list(k4_bf16_variants.VARIANTS))
def test_bf16_variants_apply(variant):
    """Each A/B variant of the bf16 tensor-core passes at C = 128 applies its
    edits and the cut to that width once; every variant but the kernels as
    they are changes the source."""
    text = k4_bf16_variants.variant_source(k4_bf16_variants.VARIANTS[variant][1])
    assert "mlp_ln_bwd_dx_mma_kernel" in text and "mlp_ln_bwd_w_mma_kernel" in text
    assert "std::integral_constant<int, 64>" not in text
    assert "return f(std::integral_constant<int, 128>{});" in text
    assert (text == k4_bf16_variants.variant_source([])) == (variant == "shipped")
