"""The plain JPEG/R writer that makes the decode cells' inputs: its
tables, its entropy coder against the plain reader, and its container
against the judge's checks, on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from portbench import content, judge
from portbench.reference import codec, jpeg, writer


def test_typical_tables_are_annex_k_and_complete():
    """The tables are typed from T.81 Annex K.3; the program's copy, typed
    apart, agrees; every symbol a baseline scan can need has a code, and
    the codes are prefix-free."""
    from libultrahdr_dev_tpu_torch.jpeg import tables as t

    assert writer.DC_LUMA == (t.DC_LUMA_BITS, t.DC_LUMA_VALS)
    assert writer.DC_CHROMA == (t.DC_CHROMA_BITS, t.DC_CHROMA_VALS)
    assert writer.AC_LUMA == (t.AC_LUMA_BITS, t.AC_LUMA_VALS)
    assert writer.AC_CHROMA == (t.AC_CHROMA_BITS, t.AC_CHROMA_VALS)
    ac_symbols = {0x00, 0xF0} | {(r << 4) | s for r in range(16)
                                 for s in range(1, 11)}
    for bits, vals in (writer.AC_LUMA, writer.AC_CHROMA):
        assert set(vals) == ac_symbols and len(vals) == sum(bits)
    for bits, vals in (writer.DC_LUMA, writer.DC_CHROMA):
        assert vals == list(range(12)) and len(vals) == sum(bits)
    for bits, _ in (writer.DC_LUMA, writer.DC_CHROMA, writer.AC_LUMA,
                    writer.AC_CHROMA):
        assert sum(b / 2 ** (n + 1) for n, b in enumerate(bits)) < 1


def _grid(rng, bh, bw, density):
    """Random zigzag coefficients: DC over its whole range, AC up to
    baseline's 10 bits, sparse enough for runs of 16 and more."""
    g = np.zeros((bh, bw, 64), np.int32)
    g[..., 0] = rng.integers(-1024, 1024, (bh, bw))
    mask = rng.random((bh, bw, 63)) < density
    g[..., 1:] = np.where(mask, rng.integers(-1023, 1024, (bh, bw, 63)), 0)
    g[0, 0, 1:] = 0
    g[0, 0, 63] = -1023      # a last coefficient after 62 zeros
    g[-1, -1, 1:] = 1000     # no EOB, every coefficient coded
    return g


@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
def test_entropy_code_round_trips_through_the_plain_reader(density):
    rng = np.random.default_rng(2**31 + 41)
    grids = [_grid(rng, 6, 10, density), _grid(rng, 3, 5, density),
             _grid(rng, 3, 5, density)]
    q = codec.quant_table(codec.STD_LUMA, 95)
    blob = writer.baseline_jpeg([torch.from_numpy(g) for g in grids],
                                [(2, 2), (1, 1), (1, 1)], [q, q], 80, 48,
                                restart=2)
    j = jpeg.parse_jpeg(blob)
    got = jpeg.decode_coefficients(j)
    assert not j.faults, j.faults
    assert j.restart == 2 and (j.width, j.height) == (80, 48)
    for g, w in zip(got, grids):
        np.testing.assert_array_equal(g, w)


def test_gray_scan_with_padding_round_trips():
    """A gray image whose size is not whole blocks (as a gain map of a
    4080-wide frame): one block an MCU, the grid as the plane pads it."""
    rng = np.random.default_rng(2**31 + 42)
    g = _grid(rng, 3, 4, 0.2)
    q = codec.quant_table(codec.STD_LUMA, 85)
    blob = writer.baseline_jpeg([torch.from_numpy(g)], [(1, 1)], [q], 30,
                                20)
    j = jpeg.parse_jpeg(blob)
    np.testing.assert_array_equal(jpeg.decode_coefficients(j)[0], g)
    assert j.restart == writer.RESTART_MCUS


def test_stuffing_and_markers():
    data = torch.tensor([0x12, 0xFF, 0x34, 0xFF, 0xFF, 0x56])
    out = writer._stuff(data, torch.tensor([2, 3, 1]))
    assert out == bytes([0x12, 0xFF, 0x00, 0xFF, 0xD0, 0x34, 0xFF, 0x00,
                         0xFF, 0x00, 0xFF, 0xD1, 0x56])


@pytest.mark.parametrize("gamut,tf", [("bt2100", "hlg"), ("p3", "pq")])
def test_a_written_jpegr_is_the_reference_encode(gamut, tf):
    """The file holds exactly the reference's quantized coefficients, and
    its container passes every check the judge makes of the program's
    files (MPF, both XMPs, the ICC colorants, tables, restarts)."""
    cfg = dict(width=128, height=64, gamut=gamut, transfer=tf, quality=95,
               gainmap_quality=85)
    y, uv = content.pool(64, 128, 1, 2**31 + 43)
    blob = writer.encode_jpegr(cfg, y[0], uv[0], "cpu")
    faults, bc, gc = judge.encode_faults(cfg, blob)
    assert faults == []
    want_b, want_g = judge.expected_coefficients(cfg, y[0], uv[0], "cpu")
    for g, w in zip(bc + gc, want_b + [want_g]):
        np.testing.assert_array_equal(g, w)
