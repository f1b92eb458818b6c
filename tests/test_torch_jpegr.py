"""The port's API-0 round trip (libultrahdr_dev_tpu_torch: JpegR, the
stable API, the batched entry points) on CPU tensors, against the JAX
package and the banked reference goldens.

Bars: JPEG/R bytes identical to the JAX package's encode; decode within
<= 1 ten-bit code / <= 1 F16 ULP of the JAX package's host-route decode
with >= 99.9% of channel samples bit-exact; the reference binary's
decodes of its own encodes (tests/goldens) at F16 PSNR >= 55 dB, the
bar of tests/test_jpegr.py."""

import gzip
import math
import os

import numpy as np
import pytest

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.container import mux as jmux, xmp as jxmp
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage)
from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                       OutputFormat, PixelFormat, RawImage,
                                       UhdrDecoder, UhdrEncoder, UhdrError,
                                       is_uhdr_image)
from libultrahdr_dev_tpu_torch.api import HDR_IMG
from libultrahdr_dev_tpu_torch.interop import (metadata_from_jax,
                                               to_torch_qtables)
from libultrahdr_dev_tpu_torch.parallel import batched
import test_torch_threads  # noqa: F401  (caps torch's threads)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
H, W = 112, 144  # 16-aligned; the 28x36 gain map is not 8-aligned
CONFIGS = [("BT2100", "HLG"), ("BT709", "PQ")]


def synth_p010(h, w, seed=0):
    """bench.py's band-limited HDR content."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
    y = (y + np.roll(y, 7, 0) + np.roll(y, 7, 1)) / 3.0
    y10 = np.clip(y, 64, 940).astype(np.uint16) << 6
    c = rng.integers(448, 576, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    c = np.kron(c, np.ones((16, 32), np.float32))[:h // 2, :w // 2]
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = np.clip(c, 64, 960).astype(np.uint16) << 6
    uv[:, 1::2] = np.clip(c[:, ::-1], 64, 960).astype(np.uint16) << 6
    return y10, uv


_ENCODED: dict = {}


def encode_both(gamut, tf):
    """(JAX JPEG/R, port JPEG/R) of one config, encoded once per run."""
    if (gamut, tf) not in _ENCODED:
        y, uv = synth_p010(H, W, seed=len(gamut))
        jb = jjpegr.JpegR().encode_api0(
            JRawImage(fmt=JPixelFormat.P010, width=W, height=H,
                      gamut=JGamut[gamut], planes={"y": y, "uv": uv}),
            JTransfer[tf], 95)
        tb = JpegR("cpu").encode_api0(
            RawImage(fmt=PixelFormat.P010, width=W, height=H,
                     gamut=ColorGamut[gamut], planes={"y": y, "uv": uv}),
            ColorTransfer[tf], 95)
        _ENCODED[gamut, tf] = (jb, tb)
    return _ENCODED[gamut, tf]


@pytest.mark.parametrize("gamut,tf", CONFIGS)
def test_api0_bytes_identical_to_jax(gamut, tf):
    jb, tb = encode_both(gamut, tf)
    assert tb == jb
    assert is_uhdr_image(tb)
    info = JpegR("cpu").get_info(tb)
    assert (info.width, info.height) == (W, H)
    assert (info.gainmap_width, info.gainmap_height) == (W // 4, H // 4)


def jax_host_decode(blob, fmt):
    """The JAX package's host route: host Huffman decode, then its fused
    dequant/IDCT + apply program (jpegr.py:536-609)."""
    primary, gmb = jmux.extract_primary_and_gainmap(blob)
    base = jcodec.decode_jpeg_coefs(primary)
    gmdec = jcodec.decode_jpeg_coefs(gmb)
    meta = jxmp.get_metadata_from_xmp(gmdec.xmp)
    (yg, ql, *_), (ug, qc, *_), (vg, *_) = base.comps
    gg, qg, gh, gw, _ = gmdec.comps[0]
    kernel = jjpegr._fused_decode_kernel(
        fmt, yg.shape, ug.shape, gg.shape, base.width, base.height,
        base.width // gw, False,
        np.stack([ql, qc, qg]).astype(np.int32).tobytes())
    flat = np.concatenate([a.ravel() for a in (yg, ug, vg, gg)])
    return np.asarray(kernel(flat, batched.apply_scalars(
        metadata_from_jax(meta), math.inf))), (ql, qc, qg), meta


def channel_diff(got, want, fmt):
    if fmt == "hdr_linear":
        return np.abs(got.astype(np.int64) - want.astype(np.int64))[..., :3]
    g, w = got.astype(np.uint32), want.astype(np.uint32)
    return np.stack([np.abs(((g >> s) & 1023).astype(np.int64)
                            - ((w >> s) & 1023)) for s in (0, 10, 20)])


@pytest.mark.parametrize("gamut,tf,fmt", [
    ("BT2100", "HLG", "HDR_LINEAR"), ("BT2100", "HLG", "HDR_HLG"),
    ("BT709", "PQ", "HDR_PQ")])
def test_decode_matches_jax_host_route(gamut, tf, fmt):
    _, blob = encode_both(gamut, tf)
    want, jax_qtables, jax_meta = jax_host_decode(
        blob, OutputFormat[fmt].value)
    res = JpegR("cpu").decode(blob, OutputFormat[fmt])
    got = res.image.planes["rgba"]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = channel_diff(got, want, OutputFormat[fmt].value)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999
    # Both packages decoded from identical state.
    assert res.metadata == metadata_from_jax(jax_meta)
    frame, = batched.decode_host_stage([blob])
    for ours, theirs in zip(to_torch_qtables(*frame.qtables, device="cpu"),
                            to_torch_qtables(*jax_qtables, device="cpu")):
        assert bool((ours == theirs).all())


GOLDEN_CONFIGS = [(g, t) for g in ("709", "p3", "2100") for t in ("hlg",
                                                                    "pq")]


@pytest.mark.parametrize("gn,tn", GOLDEN_CONFIGS)
def test_golden_f16_decode_psnr(gn, tn):
    """Reference-binary encodes (restart-less, libjpeg tables) decoded by
    the port against the reference binary's own F16 decodes."""
    blob = open(os.path.join(GOLDENS, f"enc0_{gn}_{tn}.jpegr"), "rb").read()
    boost = 4.926108 if tn == "hlg" else 49.261084
    res = JpegR("cpu").decode(blob, OutputFormat.HDR_LINEAR,
                              max_display_boost=boost)
    ours = res.image.planes["rgba"].view(np.float16)[..., :3].astype(
        np.float64)
    want = np.frombuffer(gzip.open(os.path.join(
        GOLDENS, f"dec0_{gn}_{tn}_f16.raw.gz")).read(), np.uint16) \
        .reshape(720, 1280, 4)[..., :3].view(np.float16).astype(np.float64)
    mse = np.mean((ours - want) ** 2)
    psnr = 99.0 if mse == 0 else 10 * np.log10(1.0 / mse)
    assert psnr >= 55.0, f"{gn}/{tn} F16 PSNR {psnr:.2f} dB"


def test_stable_api_quick_start():
    """The README quick start, with the port's import line."""
    y, uv = synth_p010(64, 96, seed=3)
    hdr = RawImage(fmt=PixelFormat.P010, width=96, height=64,
                   gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                   planes={"y": y, "uv": uv})
    blob = UhdrEncoder("cpu").set_raw_image(hdr, HDR_IMG).encode().data
    dec = UhdrDecoder("cpu")
    dec.set_image(blob)
    img = dec.decode()
    assert img.fmt == PixelFormat.RGBA_F16
    pixels = np.asarray(img.planes["rgba"])
    assert pixels.shape == (64, 96, 4) and pixels.dtype == np.uint16
    assert bool(np.isfinite(pixels.view(np.float16)).all())
    # XMP carries the boost to about six significant digits.
    assert dec.get_gainmap_metadata().max_content_boost == \
        pytest.approx(1000 / 203, rel=1e-5)
    # Batched entry points give the same bytes and pixels.
    blobs = batched.batched_encode_api0(y[None], uv[None], "bt2100", "hlg",
                                        device="cpu")
    assert blobs == [blob]
    out = batched.batched_decode(blobs, "hdr_linear", device="cpu")
    np.testing.assert_array_equal(out[0].numpy().view(np.uint16), pixels)


def test_unported_routes_raise():
    """A 72-row frame (not 16-aligned) now encodes, on the general route,
    to the JAX package's bytes; the 10-bit planar decode, once queued,
    now decodes within 1 code of the JAX package's host route."""
    y, uv = synth_p010(72, 96)
    raw = RawImage(fmt=PixelFormat.P010, width=96, height=72,
                   gamut=ColorGamut.BT2100, planes={"y": y, "uv": uv})
    jraw = JRawImage(fmt=JPixelFormat.P010, width=96, height=72,
                     gamut=JGamut.BT2100, planes={"y": y, "uv": uv})
    assert JpegR("cpu").encode_api0(raw, ColorTransfer.HLG) == \
        jjpegr.JpegR().encode_api0(jraw, JTransfer.HLG)
    _, blob = encode_both(*CONFIGS[0])
    fmt = OutputFormat.HDR_LINEAR_RGB_10BIT
    got = JpegR("cpu").decode(blob, fmt).image.planes["rgba"]
    want = jax_host_decode(blob, fmt.value)[0]
    assert got.shape == want.shape == (3, H, W) and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999


def _dense_p010(h=64, w=128, seed=3):
    """Uniform noise in every P010 sample: at quality 100 its blocks pass
    the JAX encoder's 608-bit buffer."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 1024, (h, w)) << 6).astype(np.uint16),
            (rng.integers(0, 1024, (h // 2, w)) << 6).astype(np.uint16))


def _n_rst(jpegr: bytes) -> int:
    return sum(jpegr.count(bytes([0xFF, 0xD0 + k])) for k in range(8))


def test_dense_api0_restartless_as_jax():
    """Dense content: the JAX package writes API-0 restart-less (its B19
    fallback) with no handoff; so does the port, through B19's plain
    version (ROADMAP Queue C 1: 22,575 bytes, 0 RSTn)."""
    from libultrahdr_dev_tpu.parallel import sharding

    y, uv = _dense_p010()
    h, w = y.shape
    jb = jjpegr.JpegR().encode_api0(
        JRawImage(fmt=JPixelFormat.P010, width=w, height=h,
                  gamut=JGamut.BT2100, planes={"y": y, "uv": uv}),
        JTransfer.HLG, 100)
    tb = JpegR("cpu").encode_api0(
        RawImage(fmt=PixelFormat.P010, width=w, height=h,
                 gamut=ColorGamut.BT2100, planes={"y": y, "uv": uv}),
        ColorTransfer.HLG, 100)
    assert tb == jb and len(tb) == 22575 and _n_rst(tb) == 0
    blobs, handoff = batched.batched_encode_api0(
        y[None], uv[None], "bt2100", "hlg", 100, device="cpu",
        return_handoff=True)
    assert blobs == [jb] and handoff is None
    # One dense frame of two: the whole batch is restart-less, as in JAX;
    # the smooth frame alone keeps its restart markers.
    sy, suv = synth_p010(h, w, seed=1)
    ys, uvs = np.stack([sy, y]), np.stack([suv, uv])
    want = sharding.batched_encode_api0(ys, uvs,
                                        sharding.single_device_mesh(),
                                        "bt2100", "hlg", 100)
    got = batched.batched_encode_api0(ys, uvs, "bt2100", "hlg", 100,
                                      device="cpu")
    assert got == want and got[1] == jb
    assert _n_rst(got[0]) == 0
    alone = batched.batched_encode_api0(sy[None], suv[None], "bt2100", "hlg",
                                        100, device="cpu")[0]
    assert _n_rst(alone) > 0 and alone != got[0]
    assert JpegR("cpu").decode(tb).image.planes["rgba"].shape == (h, w, 4)
