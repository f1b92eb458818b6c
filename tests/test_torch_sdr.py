"""The port's SDR output (kernel B7) and table-transfer decode (kernel
B11, use_luts=True) on CPU tensors, against the JAX package.

Bars: the plain B7 is bit-exact against the JAX yuv420_to_rgba8888,
odd sizes included; SDR decodes are within <= 1 per channel of the JAX
package's host-route SDR decode with >= 99.9% of channel samples exact
(B5's bar), and the batched, handoff, JpegR and UhdrDecoder routes are
bitwise equal; the plain B11 is within <= 1 ten-bit code / 1 F16 ULP of
the JAX use_luts apply with >= 99.9% exact, and the tables are the JAX
package's own. An SDR decode reads nothing of the gain map."""

import math
import os

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.container import mux as jmux, xmp as jxmp
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.ops import color as jcolor, gainmap as jgm
from libultrahdr_dev_tpu.types import OutputFormat as JOutputFormat
from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                       OutputFormat, PixelFormat, UhdrDecoder,
                                       UhdrError)
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.ops import color as tcolor, gainmap as tgm
from libultrahdr_dev_tpu_torch.parallel import batched

from test_torch_api1 import H, W, _raws
from test_torch_gainmap import _planes
from test_torch_jpegr import channel_diff
import test_torch_threads  # noqa: F401  (caps torch's threads)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _yuv(h, w, kind, seed):
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if kind == "flat":
        return (np.full((h, w), 118, np.uint8), np.full((ch, cw), 90,
                                                        np.uint8),
                np.full((ch, cw), 200, np.uint8))
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "saturated":   # chroma at its extremes: clipping in r, g, b
        c = rng.choice(np.asarray([0, 1, 254, 255], np.uint8), (2, ch, cw))
        return y, c[0], c[1]
    return (y, rng.integers(0, 256, (ch, cw)).astype(np.uint8),
            rng.integers(0, 256, (ch, cw)).astype(np.uint8))


def _padded(a, seed):
    """a as a strided view into a wider, taller buffer of noise."""
    rng = np.random.default_rng(seed)
    h, w = a.shape
    big = rng.integers(0, 256, (h + 3, w + 13)).astype(np.uint8)
    big[1:h + 1, 5:w + 5] = a
    return big[1:h + 1, 5:w + 5]


@pytest.mark.parametrize("h,w,kind", [
    (64, 96, "random"), (67, 93, "random"), (1, 1, "random"),
    (34, 18, "flat"), (31, 45, "saturated"),
    # the edges of B7's 2x8 pixel blocks: widths 7-9 and 15-17, heights
    # 1-3, and planes read through strided views of padded buffers
    (1, 7, "random"), (2, 8, "random"), (3, 9, "random"),
    (1, 15, "random"), (2, 16, "random"), (3, 17, "random"),
    (3, 7, "saturated"), (1, 16, "random"), (2, 9, "random"),
    (35, 41, "padded"), (3, 17, "padded")])
def test_b7_plain_matches_jax(h, w, kind):
    y, u, v = _yuv(h, w, kind, seed=h * w)
    if kind == "padded":
        y, u, v = (_padded(a, seed=k) for k, a in enumerate((y, u, v)))
        assert not y.flags.c_contiguous
    want = np.asarray(jgm.yuv420_to_rgba8888(y, u, v))
    got = tgm.yuv420_to_rgba8888(*(torch.from_numpy(a)[None]
                                   for a in (y, u, v)))
    assert got.dtype == torch.int32 and got.shape == (1, h, w)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)


def jax_host_sdr(blob):
    """The JAX package's host-route SDR decode: host Huffman decode of
    the base, then its fused dequant/IDCT + yuv420_to_rgba8888 program
    (jpegr.py:555-570)."""
    primary, _ = jmux.extract_primary_and_gainmap(blob)
    base = jcodec.decode_jpeg_coefs(primary)
    (yg, ql, *_), (ug, qc, *_), (vg, *_) = base.comps
    dummy = np.zeros((1, 1, 64), np.int16)
    kernel = jjpegr._fused_decode_kernel(
        "sdr", yg.shape, ug.shape, dummy.shape, base.width, base.height, 1,
        False, np.stack([ql, qc, ql]).astype(np.int32).tobytes())
    flat = np.concatenate([a.ravel() for a in (yg, ug, vg, dummy)])
    return np.asarray(kernel(flat, np.zeros(4, np.float32)))


def rgba_diff(got, want):
    """Per-channel |difference| of RGBA8888 words (alpha left out)."""
    g = got.view(np.uint8).reshape(*got.shape, 4)[..., :3]
    w = want.astype(np.uint32).view(np.uint8).reshape(*want.shape, 4)
    return np.abs(g.astype(np.int64) - w[..., :3])


_API1: dict = {}


def api1_blob():
    """A port API-1 JPEG/R (BT.709 SDR, BT.2100 HLG) with its handoff."""
    if not _API1:
        hdr, sdr = _raws("BT709", "BT2100", "HLG", seed=9)
        blobs, handoff = batched.batched_encode_api1(
            hdr["planes"]["y"][None], hdr["planes"]["uv"][None],
            *(sdr["planes"][k][None] for k in ("y", "u", "v")),
            sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg",
            device="cpu", return_handoff=True)
        _API1.update(blob=blobs[0], handoff=handoff)
    return _API1


@pytest.mark.parametrize("name", ["enc0_709_hlg.jpegr", "enc0_p3_hlg.jpegr",
                                  "enc0_2100_hlg.jpegr", "port_api1"])
def test_sdr_decode_matches_jax_host_route(name):
    blob = (api1_blob()["blob"] if name == "port_api1" else
            open(os.path.join(GOLDENS, name), "rb").read())
    res = JpegR("cpu").decode(blob, OutputFormat.SDR)
    got = res.image.planes["rgba"]
    want = jax_host_sdr(blob)
    assert got.dtype == np.uint32 and got.shape == want.shape
    d = rgba_diff(got, want)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999
    assert res.image.fmt == PixelFormat.RGBA8888
    assert res.image.transfer == ColorTransfer.UNSPECIFIED
    assert res.metadata is None
    assert bool(((got >> 24) == 0xFF).all())


def test_sdr_routes_bitwise_equal():
    """batched_decode, batched_decode_from_handoff, JpegR.decode and
    UhdrDecoder (RGBA8888 + sRGB) give the same SDR pixels."""
    enc = api1_blob()
    blob = enc["blob"]
    ref = JpegR("cpu").decode(blob, OutputFormat.SDR)
    want = ref.image.planes["rgba"]
    assert ref.gamut == ColorGamut.BT709   # the SDR gamut's ICC
    assert (ref.width, ref.height) == (W, H)
    got = batched.batched_decode([blob, blob], "sdr", device="cpu")
    assert got.shape == (2, H, W) and got.dtype == torch.int32
    for frame in got:
        np.testing.assert_array_equal(frame.numpy().view(np.uint32), want)
    hand = batched.batched_decode_from_handoff(enc["handoff"], "sdr")
    np.testing.assert_array_equal(hand[0].numpy().view(np.uint32), want)
    dec = UhdrDecoder("cpu").set_image(blob)
    dec.set_out_img_format(PixelFormat.RGBA8888)
    dec.set_out_color_transfer(ColorTransfer.SRGB)
    img = dec.decode()
    assert img.fmt == PixelFormat.RGBA8888
    np.testing.assert_array_equal(img.planes["rgba"], want)


def _strip_gainmap_xmp(blob: bytes) -> bytes:
    """The blob with its gain map's XMP signature broken (same length, so
    the MPF offsets hold): the gain map then carries no XMP."""
    ns = jxmp.XMP_NAMESPACE.encode() + b"\x00"
    second = blob.index(ns, blob.index(ns) + 1)
    assert jmux.extract_primary_and_gainmap(blob)[1].find(ns) >= 0
    return blob[:second] + b"urn:not-xmp" + blob[second + 11:]


def test_sdr_decode_needs_no_gainmap_xmp():
    """A JPEG/R whose gain map has no XMP decodes to SDR in both packages
    with equal pixels, and raises in both for HDR output; the port's SDR
    host stage never parses the gain map."""
    blob = _strip_gainmap_xmp(api1_blob()["blob"])
    frame, = batched.decode_host_stage([blob], "sdr")
    assert frame.streams is not None and len(frame.streams) == 1
    assert frame.metadata is None and frame.gm_width == 0
    got = JpegR("cpu").decode(blob, OutputFormat.SDR).image.planes["rgba"]
    d = rgba_diff(got, jax_host_sdr(blob))
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
    with pytest.raises(Exception, match="XMP"):
        jjpegr.JpegR().decode(blob, JOutputFormat.HDR_LINEAR)
    with pytest.raises(UhdrError, match="XMP"):
        JpegR("cpu").decode(blob, OutputFormat.HDR_LINEAR)


@pytest.mark.parametrize("fmt,scalars", [
    ("hdr_linear", (0.0, 2.3045, 1.0, 4.9396)),
    ("hdr_hlg", (0.0, 2.3045, 0.4342, 2.0)),
    ("hdr_pq", (0.0, 5.6224, 1.0, 49.2611)),
])
def test_b11_plain_matches_jax(fmt, scalars):
    y8, u8, v8, gm = _planes(108, 140, seed=len(fmt) + 1)
    sc = np.asarray(scalars, np.float32)
    want = np.asarray(jgm._apply_kernel(fmt, 4, True)(y8, u8, v8, gm, *sc))
    got = tgm.apply_gainmap(*(torch.from_numpy(a)[None]
                              for a in (y8, u8, v8, gm)),
                            torch.from_numpy(sc)[None], fmt,
                            use_luts=True)[0].numpy()
    d = channel_diff(got.view(np.uint16) if fmt == "hdr_linear" else
                     got.view(np.uint32), want, fmt)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999
    # The tables differ from the computed functions, so the arms differ.
    computed = tgm.apply_gainmap(*(torch.from_numpy(a)[None]
                                   for a in (y8, u8, v8, gm)),
                                 torch.from_numpy(sc)[None], fmt)[0].numpy()
    assert not np.array_equal(computed, got)


_LUT_FNS = {"srgb_inv": "srgb_inv_oetf_lut", "hlg_oetf": "hlg_oetf_lut",
            "hlg_inv": "hlg_inv_oetf_lut", "pq_oetf": "pq_oetf_lut",
            "pq_inv": "pq_inv_oetf_lut"}


def test_luts_and_gain_factor_lut_match_jax():
    """The port's tables are the JAX package's, bit for bit, and index
    the same way; gain_factor_lut (no caller in either package) too."""
    xs = np.linspace(-0.1, 1.2, 4001, dtype=np.float32)
    assert set(tcolor.LUT_SPECS) == set(_LUT_FNS)
    for name, fn in _LUT_FNS.items():
        want = np.asarray(getattr(jcolor, fn)(xs))  # builds jcolor._LUTS
        np.testing.assert_array_equal(tcolor.lut_table(name),
                                      jcolor._LUTS[name])
        np.testing.assert_array_equal(
            getattr(tcolor, fn)(torch.from_numpy(xs)).numpy(), want)
    g = np.linspace(-0.05, 1.05, 3001, dtype=np.float32)
    for boost in (None, 2.5, 0.0):
        np.testing.assert_array_equal(
            tcolor.gain_factor_lut(torch.from_numpy(g), 1.0, 4.926108,
                                   boost).numpy(),
            np.asarray(jcolor.gain_factor_lut(g, 1.0, 4.926108, boost)))


def jax_host_decode_luts(blob, fmt):
    """The JAX host route with use_luts=True (jpegr.py:572-609)."""
    primary, gmb = jmux.extract_primary_and_gainmap(blob)
    base = jcodec.decode_jpeg_coefs(primary)
    gmdec = jcodec.decode_jpeg_coefs(gmb)
    meta = jxmp.get_metadata_from_xmp(gmdec.xmp)
    (yg, ql, *_), (ug, qc, *_), (vg, *_) = base.comps
    gg, qg, gh, gw, _ = gmdec.comps[0]
    kernel = jjpegr._fused_decode_kernel(
        fmt, yg.shape, ug.shape, gg.shape, base.width, base.height,
        base.width // gw, True,
        np.stack([ql, qc, qg]).astype(np.int32).tobytes())
    flat = np.concatenate([a.ravel() for a in (yg, ug, vg, gg)])
    return np.asarray(kernel(flat, batched.apply_scalars(
        metadata_from_jax(meta), math.inf)))


@pytest.mark.parametrize("fmt", ["hdr_hlg", "hdr_pq"])
def test_use_luts_decode_routes(fmt):
    """use_luts=True through JpegR.decode, batched_decode and the handoff:
    bitwise equal to each other, and within the B11 bar of the JAX
    package's use_luts host route."""
    enc = api1_blob()
    res = JpegR("cpu").decode(enc["blob"], OutputFormat(fmt), use_luts=True)
    want = res.image.planes["rgba"]
    d = channel_diff(want, jax_host_decode_luts(enc["blob"], fmt), fmt)
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
    got = batched.batched_decode([enc["blob"]], fmt, device="cpu",
                                 use_luts=True)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)
    hand = batched.batched_decode_from_handoff(enc["handoff"], fmt,
                                               use_luts=True)
    np.testing.assert_array_equal(hand[0].numpy().view(np.uint32), want)
    plain = JpegR("cpu").decode(enc["blob"], OutputFormat(fmt))
    assert not np.array_equal(plain.image.planes["rgba"], want)


def test_b7_b11_wrappers_run_plain_on_cpu():
    y8, u8, v8, gm = (torch.from_numpy(a)[None] for a in _planes(36, 52, 4))
    before = (tgm.yuv420_to_rgba8888.launches, tgm.apply_gainmap.launches,
              tgm.apply_gainmap.lut_launches)
    out = tgm.yuv420_to_rgba8888(y8, u8, v8)
    assert out.shape == (1, 36, 52) and out.dtype == torch.int32
    sc = torch.tensor([[0.0, 2.3, 1.0, 4.9]])
    hdr = tgm.apply_gainmap(y8, u8, v8, gm, sc, "hdr_pq", use_luts=True)
    assert hdr.shape == (1, 36, 52)
    assert (tgm.yuv420_to_rgba8888.launches, tgm.apply_gainmap.launches,
            tgm.apply_gainmap.lut_launches) == before
    with pytest.raises(ValueError):
        tgm.yuv420_to_rgba8888(y8, u8[:, :-1], v8)
