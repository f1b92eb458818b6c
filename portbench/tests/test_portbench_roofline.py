"""The stage counts of portbench/roofline.py against the shapes of both
configurations and the per-kernel byte counts of chip_smoke.py, which
counted each kernel's own inputs and outputs at 4080x3072."""

import pytest

from portbench import roofline

W12, H12 = 4080, 3072
W3, H3 = 2048, 1536
HLG = roofline.OPS["apply hlg"]


def test_p010_bytes_of_both_configurations():
    assert roofline.p010_bytes(W12, H12) == 2 * W12 * H12 + W12 * H12
    assert roofline.p010_bytes(W12, H12) == 37_601_280
    assert roofline.p010_bytes(W3, H3) == 9_437_184


def test_encode_stage_recounts_b1():
    """chip_smoke.py's B1 row: 57.2 MB a 4080x3072 frame, its P010 input
    and its outputs (gain map, BT.601 Y, U, V). The stage reads the P010
    once and leaves B1's outputs to the next kernel, so its bytes without
    streams are B1's less those outputs."""
    b1_outputs = (W12 // 4) * (H12 // 4) + W12 * H12 + 2 * (W12 // 2) * (
        H12 // 2)
    stage = roofline.encode_stage(W12, H12, "hlg", 1, 0)
    assert round((stage["bytes"] + b1_outputs) / 1e6, 1) == 57.2
    assert roofline.encode_stage(W12, H12, "hlg", 3, 1000)["bytes"] == (
        3 * stage["bytes"] + 1000)


def test_decode_stage_recounts_b6():
    """chip_smoke.py's B6 HLG row: 70.0 MB a frame, its decoded planes and
    gain map in, its RGBA1010102 words out, and its tables (two 65536
    float32 sRGB tables, read once a batch of two frames). The stage
    writes the same words."""
    planes = W12 * H12 + 2 * (W12 // 2) * (H12 // 2) + (W12 // 4) * (
        H12 // 4)
    tables = 2 * 65536 * 4 / 2
    stage = roofline.decode_stage(W12, H12, 1, 0, 4, HLG)
    assert round((stage["bytes"] + planes + tables) / 1e6, 1) == 70.0


def test_blocks_of_both_configurations():
    # Y, two chroma planes, and the gain map padded to whole blocks.
    assert roofline.blocks(W12, H12) == (510 * 384 + 2 * 255 * 192
                                         + 128 * 96)
    assert roofline.blocks(W3, H3) == 256 * 192 + 2 * 128 * 96 + 64 * 48


def test_what_bounds_each_stage():
    """PQ at 3 MP is bound by its float64 pows (seven a pixel, as
    chip_smoke.py found B6); HLG at 12 MP, bound by bytes in B6 alone, is
    bound by float32 operations once the stage counts the IDCT's. The
    encode's bytes and float32 operations are within 2% of each other
    before its streams' bytes are counted."""
    w = roofline.decode_stage(W12, H12, 1, 0, 4, HLG)
    t, by = roofline.least_seconds(w)
    assert by == "operations"
    assert t == pytest.approx((81 * W12 * H12 + 2048 * roofline.blocks(
        W12, H12)) / 67e12)
    assert t > 4 * W12 * H12 / 3.35e12
    t, by = roofline.least_seconds(roofline.decode_stage(
        W3, H3, 1, 0, 4, roofline.OPS["apply pq"]))
    assert by == "operations"
    assert t == pytest.approx(7 * 36 * W3 * H3 / 34e12, rel=1e-9)
    w = roofline.encode_stage(W12, H12, "hlg", 1, 0)
    flops = (114 * (W12 // 4) * (H12 // 4) + 63 * (W12 // 2) * (H12 // 2)
             + 1536 * roofline.blocks(W12, H12))
    assert w["flops"] == flops
    assert roofline.least_seconds(w)[0] == pytest.approx(flops / 67e12)
    assert flops / 67e12 == pytest.approx(37_601_280 / 3.35e12, rel=0.02)
    w = roofline.encode_stage(W12, H12, "hlg", 1, 4_000_000)
    assert roofline.least_seconds(w) == (41_601_280 / 3.35e12, "bytes")
