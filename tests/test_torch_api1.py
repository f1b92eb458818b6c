"""The port's API-1 encode (an HDR frame and its SDR rendition; kernel B9
then B2 and B3) on CPU tensors, against the JAX package.

Bars: B9's plain version then B2's give coefficients equal to the JAX
sharding._gainmap_and_coefs for every (SDR, HDR) gamut pair; the JPEG/R
bytes of batched_encode_api1, JpegR.encode_api1 and UhdrEncoder (HDR
and SDR raw intents) are identical to the JAX package's; the stable
API's error codes are the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import api as japi, jpegr as jjpegr
from libultrahdr_dev_tpu.ops import gainmap as jgm
from libultrahdr_dev_tpu.parallel import sharding
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage,
                                       UhdrError as JUhdrError)
from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer,
                                       CompressedImage, JpegR, PixelFormat,
                                       RawImage, UhdrEncoder, UhdrError)
from libultrahdr_dev_tpu_torch.api import BASE_IMG, HDR_IMG, SDR_IMG
from libultrahdr_dev_tpu_torch.jpeg import dct
from libultrahdr_dev_tpu_torch.ops import gainmap as tgm
from libultrahdr_dev_tpu_torch.parallel import batched

from test_torch_jpegr import synth_p010
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 64, 96  # 16-aligned; a 16x24 gain map
# The configurations of the chip run: (SDR gamut, HDR gamut, transfer).
CONFIGS = [("BT709", "BT2100", "HLG"), ("P3", "BT2100", "PQ")]
PAIRS = [(s, h) for s in ("bt709", "p3", "bt2100")
         for h in ("bt709", "p3", "bt2100") if s != h]


def _p010(h, w, seed):
    """Block-smooth narrow-range P010 with noise in the low bits."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 8 + 1, w // 8 + 1))
    y = np.kron(small, np.ones((8, 8), np.int64))[:h, :w]
    y = np.clip(y + rng.integers(0, 30, (h, w)), 64, 940)
    uv = rng.integers(300, 700, (h // 2, w))
    noise = rng.integers(0, 64, (h, w)).astype(np.uint16)
    return ((y.astype(np.uint16) << 6) | noise,
            uv.astype(np.uint16) << 6)


def sdr_from_hdr(y, uv, seed=0):
    """An SDR rendition of P010 planes: their top 8 bits, with a little
    seeded noise so that it is not API-0's tonemap."""
    rng = np.random.default_rng(seed)

    def jitter(a):
        return np.clip(a.astype(np.int64) + rng.integers(-3, 4, a.shape),
                       0, 255).astype(np.uint8)

    return (jitter(y >> 8), jitter(uv[:, 0::2] >> 8),
            jitter(uv[:, 1::2] >> 8))


@pytest.mark.parametrize("tf", ["hlg", "pq"])
@pytest.mark.parametrize("sdr_gamut,hdr_gamut", PAIRS)
def test_b9_plain_matches_jax(sdr_gamut, hdr_gamut, tf):
    y, uv = _p010(H, W, seed=len(sdr_gamut) * 7 + len(hdr_gamut) + len(tf))
    sdr = sdr_from_hdr(y, uv, seed=3)
    want = jax.jit(lambda *a: sharding._gainmap_and_coefs(
        *a, sdr_gamut, hdr_gamut, tf, 95))(*sdr, y, uv)
    front = tgm.encode_front_api1(
        torch.from_numpy(y.view(np.int16))[None],
        torch.from_numpy(uv.view(np.int16))[None],
        *(torch.from_numpy(p)[None] for p in sdr), sdr_gamut, hdr_gamut, tf)
    gmap, yb, ub, vb = front
    ql, qc, qg = (torch.from_numpy(q.reshape(64))
                  for q in batched.quant_tables(95))
    got = [dct.fdct_quant(p, q, recip=True) for p, q in
           ((yb, ql), (ub, qc), (vb, qc), (gmap, qg))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(),
                                      np.asarray(w).reshape(g[0].shape))


@pytest.mark.parametrize("src,dst", PAIRS)
def test_front_end_helpers_bit_exact_with_jax(src, dst):
    """The box mean sums each block in row-major order, as the JAX
    reduce_window does on the CPU at the codec's shapes (at a few small
    widths, 64 among them, XLA adds a 2x2 window's rows as pairs), and
    the YUV re-encode fuses the product that XLA fuses (ops/color.py:
    dot2): both bit-equal to the JAX package."""
    rng = np.random.default_rng(len(src) * 10 + len(dst))
    y, u, v = (rng.integers(0, 256, s).astype(np.uint8)
               for s in ((48, 64), (24, 32), (24, 32)))
    want = jgm.convert_yuv_encoding(y, u, v, src, dst)
    got = tgm.convert_yuv_encoding_plain(
        *(torch.from_numpy(a)[None] for a in (y, u, v)), src, dst)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    x = rng.random((64, 96), dtype=np.float32)
    for factor in (2, 4):
        np.testing.assert_array_equal(
            tgm._box_mean(torch.from_numpy(x)[None], factor)[0].numpy(),
            np.asarray(jax.jit(lambda a: jgm._box_mean(a, factor))(x)))


def _raws(sdr_gamut, hdr_gamut, tf, seed):
    y, uv = synth_p010(H, W, seed=seed)
    sy, su, sv = sdr_from_hdr(y, uv, seed=seed)
    hdr = dict(fmt="P010", width=W, height=H, gamut=hdr_gamut,
               transfer=tf, planes={"y": y, "uv": uv})
    sdr = dict(fmt="YUV420", width=W, height=H, gamut=sdr_gamut,
               planes={"y": sy, "u": su, "v": sv})
    return hdr, sdr


def port_raw(d):
    return RawImage(fmt=PixelFormat[d["fmt"]], width=d["width"],
                    height=d["height"], gamut=ColorGamut[d["gamut"]],
                    transfer=ColorTransfer[d.get("transfer", "UNSPECIFIED")],
                    planes=d["planes"])


def jax_raw(d):
    return JRawImage(fmt=JPixelFormat[d["fmt"]], width=d["width"],
                     height=d["height"], gamut=JGamut[d["gamut"]],
                     transfer=JTransfer[d.get("transfer", "UNSPECIFIED")],
                     planes=d["planes"])


@pytest.mark.parametrize("sdr_gamut,hdr_gamut,tf", CONFIGS)
def test_api1_bytes_identical_to_jax(sdr_gamut, hdr_gamut, tf):
    hdr, sdr = _raws(sdr_gamut, hdr_gamut, tf, seed=len(sdr_gamut))
    planes = [hdr["planes"][k][None] for k in ("y", "uv")] + \
        [sdr["planes"][k][None] for k in ("y", "u", "v")]
    kw = dict(sdr_gamut=sdr_gamut.lower(), hdr_gamut=hdr_gamut.lower(),
              hdr_tf=tf.lower(), quality=95)
    want = sharding.batched_encode_api1(*planes,
                                        sharding.single_device_mesh(), **kw)
    assert batched.batched_encode_api1(*planes, device="cpu", **kw) == want
    jb = jjpegr.JpegR().encode_api1(jax_raw(hdr), jax_raw(sdr),
                                    JTransfer[tf], 95)
    tb = JpegR("cpu").encode_api1(port_raw(hdr), port_raw(sdr),
                                  ColorTransfer[tf], 95)
    assert jb == want[0] and tb == jb


def _encoders(hdr, sdr):
    """(JAX, port) UhdrEncoders fed the same HDR and SDR raw images, with
    qualities set for the base and for the gain map."""
    out = []
    for enc, raw, intents in ((japi.UhdrEncoder(), jax_raw,
                               (japi.HDR_IMG, japi.SDR_IMG, japi.BASE_IMG)),
                              (UhdrEncoder("cpu"), port_raw,
                               (HDR_IMG, SDR_IMG, BASE_IMG))):
        enc.set_raw_image(raw(hdr), intents[0])
        enc.set_raw_image(raw(sdr), intents[1])
        enc.set_quality(70, "gainmap")
        enc.set_quality(95, intents[2])
        out.append(enc)
    return out


def test_uhdr_encoder_api1_equals_encode_api1():
    """HDR + SDR raw intents dispatch to API-1: the bytes equal
    JpegR.encode_api1 and the JAX package's UhdrEncoder's. Setting a
    quality for the gain-map intent (the set_quality repair) raises in
    neither package and changes nothing: the gain map keeps its fixed
    quality 85 in both."""
    hdr, sdr = _raws(*CONFIGS[0], seed=len(CONFIGS[0][0]))
    jenc, tenc = _encoders(hdr, sdr)
    tb = tenc.encode().data
    assert tb == jenc.encode().data
    assert tb == JpegR("cpu").encode_api1(port_raw(hdr), port_raw(sdr),
                                          ColorTransfer.HLG, 95)


def _code(fn):
    with pytest.raises((UhdrError, JUhdrError)) as e:
        fn()
    return e.value.code


def test_uhdr_encoder_api1_error_codes_match_jax():
    hdr, sdr = _raws(*CONFIGS[0], seed=1)
    bad_fmt = dict(sdr, fmt="P010")
    no_gamut = dict(sdr, gamut="UNSPECIFIED")
    small = dict(sdr, width=W // 2, height=H // 2,
                 planes={k: v[:H // 2, :W // 2] for k, v in
                         sdr["planes"].items()})
    for jfn, tfn in (
            (lambda: japi.UhdrEncoder().set_raw_image(jax_raw(bad_fmt),
                                                      japi.SDR_IMG),
             lambda: UhdrEncoder("cpu").set_raw_image(port_raw(bad_fmt),
                                                      SDR_IMG)),
            (lambda: japi.UhdrEncoder().set_raw_image(jax_raw(no_gamut),
                                                      japi.SDR_IMG),
             lambda: UhdrEncoder("cpu").set_raw_image(port_raw(no_gamut),
                                                      SDR_IMG)),
            (lambda: _encoders(hdr, small)[0].encode(),
             lambda: _encoders(hdr, small)[1].encode())):
        assert _code(jfn) == _code(tfn) == "UHDR_CODEC_INVALID_PARAM"


def test_api1_unported_routes_raise():
    """API-1 with EXIF (the general route) gives the JAX package's bytes,
    and a compressed SDR image is stored for the encode, as in the JAX
    package: neither raises now."""
    hdr, sdr = _raws(*CONFIGS[0], seed=2)
    exif = b"Exif\x00\x00"
    tb = JpegR("cpu").encode_api1(port_raw(hdr), port_raw(sdr),
                                  ColorTransfer.HLG, exif=exif)
    assert tb == jjpegr.JpegR().encode_api1(jax_raw(hdr), jax_raw(sdr),
                                            JTransfer.HLG, exif=exif)
    enc = UhdrEncoder("cpu")
    assert enc.set_compressed_image(
        CompressedImage(data=b"\xff\xd8\xff\xd9"), SDR_IMG) is enc


def test_b9_wrapper_runs_plain_on_cpu():
    y, uv = _p010(32, 48, seed=5)
    sdr = sdr_from_hdr(y, uv)
    before = tgm.encode_front_api1.launches
    args = [torch.from_numpy(np.stack([a, a]).view(
        np.int16 if a.dtype == np.uint16 else np.uint8)) for a in (y, uv)]
    args += [torch.from_numpy(np.stack([p, p])) for p in sdr]
    gm, yb, ub, vb = tgm.encode_front_api1(*args, "p3", "bt2100", "pq")
    assert gm.shape == (2, 8, 12) and yb.shape == (2, 32, 48)
    assert ub.shape == vb.shape == (2, 16, 24)
    # A P3 SDR is already BT.601: the base planes are the SDR planes.
    for got, want in zip((yb, ub, vb), sdr):
        np.testing.assert_array_equal(got[1].numpy(), want)
    assert tgm.encode_front_api1.launches == before
    with pytest.raises(ValueError):
        tgm.encode_front_api1(*args[:2], args[2][:, :16], *args[3:], "p3",
                              "bt2100", "pq")


def test_dense_api1_takes_the_general_route_as_jax():
    """Dense content: batched_encode_api1 raises OverflowError in both
    packages, and JpegR.encode_api1 and UhdrEncoder take the general
    route, to the JAX package's bytes (ROADMAP Queue C 1)."""
    rng = np.random.default_rng(3)
    h, w = 64, 128
    hdr = dict(fmt="P010", width=w, height=h, gamut="BT2100",
               transfer="HLG", planes={
                   "y": (rng.integers(0, 1024, (h, w)) << 6).astype(
                       np.uint16),
                   "uv": (rng.integers(0, 1024, (h // 2, w)) << 6).astype(
                       np.uint16)})
    sdr = dict(fmt="YUV420", width=w, height=h, gamut="BT709", planes={
        k: rng.integers(0, 256, s, dtype=np.uint8) for k, s in
        (("y", (h, w)), ("u", (h // 2, w // 2)), ("v", (h // 2, w // 2)))})
    planes = [hdr["planes"][k][None] for k in ("y", "uv")] + \
        [sdr["planes"][k][None] for k in ("y", "u", "v")]
    kw = dict(sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg",
              quality=100)
    with pytest.raises(OverflowError):
        sharding.batched_encode_api1(*planes, sharding.single_device_mesh(),
                                     **kw)
    with pytest.raises(OverflowError):
        batched.batched_encode_api1(*planes, device="cpu", **kw)
    jb = jjpegr.JpegR().encode_api1(jax_raw(hdr), jax_raw(sdr),
                                    JTransfer.HLG, 100)
    tb = JpegR("cpu").encode_api1(port_raw(hdr), port_raw(sdr),
                                  ColorTransfer.HLG, 100)
    assert tb == jb
    assert not any(bytes([0xFF, 0xD0 + k]) in tb for k in range(8))
    enc = UhdrEncoder("cpu").set_raw_image(port_raw(hdr), HDR_IMG)
    enc.set_raw_image(port_raw(sdr), SDR_IMG)
    enc.set_quality(100, BASE_IMG)
    jenc = japi.UhdrEncoder().set_raw_image(jax_raw(hdr), japi.HDR_IMG)
    jenc.set_raw_image(jax_raw(sdr), japi.SDR_IMG)
    jenc.set_quality(100, japi.BASE_IMG)
    assert enc.encode().data == jenc.encode().data == jb
