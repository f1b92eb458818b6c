"""The port's general encode routes (libultrahdr_dev_tpu_torch: kernels
B10a tonemap_p010, B10b generate_gainmap, B10c convert_yuv_encoding,
then jpeg/codec.py:encode_jpeg) on CPU tensors, against the JAX package
on the same numpy inputs.

Bars: the plain B10a/B10b/B10c are bit-exact with the JAX programs at
frame sizes that are not 16-aligned (sizes where XLA's reduce_window
sums each box row-major, as the plain box mean does), for gamut and
transfer mixes, sdr_is_601 and use_luts; the JPEG/R bytes of API-0 and
API-1 with EXIF on frames that are not 16-aligned, API-2, API-3 (a base
with and without ICC), API-4 and API-x are identical to the JAX
package's, through JpegR and through UhdrEncoder (the JAX UhdrEncoder
has no API-x route, so API-x goes through JpegR alone); UhdrEncoder's
error codes are the JAX package's."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import api as japi, jpegr as jjpegr
from libultrahdr_dev_tpu.container import icc as jicc
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.ops import gainmap as jgm
from libultrahdr_dev_tpu.types import (ColorTransfer as JTransfer,
                                       CompressedImage as JCompressed,
                                       UhdrError as JUhdrError)
from libultrahdr_dev_tpu_torch import (ColorTransfer, CompressedImage, JpegR,
                                       UhdrEncoder, UhdrError)
from libultrahdr_dev_tpu_torch.api import BASE_IMG, HDR_IMG, SDR_IMG
from libultrahdr_dev_tpu_torch.container import mux as tmux
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.jpeg import codec as tcodec, headers
from libultrahdr_dev_tpu_torch.ops import gainmap as tgm

from test_torch_api1 import _p010, jax_raw, port_raw, sdr_from_hdr
from test_torch_jpegr import synth_p010
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 72, 104  # neither 16-aligned; an 18x26 gain map
EXIF = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x00"


def _t(a):
    """numpy plane -> (1, ...) CPU tensor (P010 as int16 bits)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                            else a)[None]


def test_b10a_tonemap_plain_matches_jax():
    y, uv = _p010(74, 106, seed=1)
    got = tgm.tonemap_p010(_t(y), _t(uv))
    for g, w in zip(got, jgm.tonemap_p010(y, uv)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert tgm.tonemap_p010.launches == 0


# (h, w, sdr gamut, hdr gamut, transfer, sdr_is_601, use_luts)
B10B_CASES = [
    (72, 104, "bt2100", "bt2100", "hlg", False, False),
    (74, 106, "bt709", "bt2100", "pq", False, False),
    (60, 100, "p3", "bt2100", "hlg", True, False),
    (72, 104, "bt709", "bt2100", "hlg", False, True),
    (74, 106, "p3", "bt709", "pq", False, True),
    (60, 100, "bt2100", "p3", "linear", True, True),
    (120, 200, "bt709", "p3", "pq", True, True),
]


@pytest.mark.parametrize("h,w,sg,hg,tf,is601,luts", B10B_CASES)
def test_b10b_generate_plain_matches_jax(h, w, sg, hg, tf, is601, luts):
    y, uv = _p010(h, w, seed=h + w)
    sdr = sdr_from_hdr(y, uv, seed=w)
    want, want_md = jgm.generate_gainmap(
        *sdr, y, uv, sdr_gamut=sg, hdr_gamut=hg, hdr_tf=tf,
        sdr_is_601=is601, use_luts=luts)
    got, md = tgm.generate_gainmap(
        *(_t(p) for p in sdr), _t(y), _t(uv), sdr_gamut=sg, hdr_gamut=hg,
        hdr_tf=tf, sdr_is_601=is601, use_luts=luts)
    assert got.shape == (1, h // 4, w // 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert md == metadata_from_jax(want_md)


@pytest.mark.parametrize("src,dst", [("bt2100", "p3"), ("bt709", "p3"),
                                     ("p3", "bt2100")])
def test_b10c_convert_plain_matches_jax(src, dst):
    rng = np.random.default_rng(len(src) + len(dst))
    y, u, v = (rng.integers(0, 256, s).astype(np.uint8)
               for s in ((74, 106), (37, 53), (37, 53)))
    got = tgm.convert_yuv_encoding(*(_t(p) for p in (y, u, v)), src, dst)
    for g, w in zip(got, jgm.convert_yuv_encoding(y, u, v, src, dst)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert tgm.convert_yuv_encoding.launches == 0


def _hdr(gamut, tf, seed, h=H, w=W):
    y, uv = synth_p010(h, w, seed=seed)
    return dict(fmt="P010", width=w, height=h, gamut=gamut, transfer=tf,
                planes={"y": y, "uv": uv})


def _sdr(hdr, gamut, seed):
    sy, su, sv = sdr_from_hdr(hdr["planes"]["y"], hdr["planes"]["uv"],
                              seed=seed)
    return dict(fmt="YUV420", width=hdr["width"], height=hdr["height"],
                gamut=gamut, planes={"y": sy, "u": su, "v": sv})


def _encoders(setup):
    """(JAX, port) UhdrEncoders, each configured by setup(encoder, raw,
    compressed image type, intents (HDR, SDR, BASE))."""
    out = []
    for enc, raw, ci, intents in (
            (japi.UhdrEncoder(), jax_raw, JCompressed,
             (japi.HDR_IMG, japi.SDR_IMG, japi.BASE_IMG)),
            (UhdrEncoder("cpu"), port_raw, CompressedImage,
             (HDR_IMG, SDR_IMG, BASE_IMG))):
        setup(enc, raw, ci, intents)
        out.append(enc)
    return out


def _both_encoders(setup):
    jenc, tenc = _encoders(setup)
    jb = jenc.encode().data
    assert tenc.encode().data == jb
    return jb


@pytest.mark.parametrize("gamut,tf", [("BT2100", "HLG"), ("BT709", "PQ")])
def test_api0_general_with_exif_bytes_identical_to_jax(gamut, tf):
    hdr = _hdr(gamut, tf, seed=len(gamut))
    jb = jjpegr.JpegR().encode_api0(jax_raw(hdr), JTransfer[tf], 95,
                                    exif=EXIF)
    calls = tcodec.entropy_encode.calls
    tb = JpegR("cpu").encode_api0(port_raw(hdr), ColorTransfer[tf], 95,
                                  exif=EXIF)
    assert tb == jb
    # JAX's route Huffman-codes the base and the gain map on the host;
    # the port's B19 writes the same bytes, with no host Huffman call.
    assert tcodec.entropy_encode.calls - calls == 0

    def setup(enc, raw, _, intents):
        enc.set_raw_image(raw(hdr), intents[0])
        enc.set_exif_data(EXIF)
    assert _both_encoders(setup) == jb
    assert JpegR("cpu").decode(tb).exif.endswith(EXIF[6:])


def test_api1_general_with_exif_bytes_identical_to_jax():
    hdr = _hdr("BT2100", "HLG", seed=4)
    sdr = _sdr(hdr, "BT709", seed=4)
    jb = jjpegr.JpegR().encode_api1(jax_raw(hdr), jax_raw(sdr),
                                    JTransfer.HLG, 90, exif=EXIF)
    tb = JpegR("cpu").encode_api1(port_raw(hdr), port_raw(sdr),
                                  ColorTransfer.HLG, 90, exif=EXIF)
    assert tb == jb

    def setup(enc, raw, _, intents):
        enc.set_raw_image(raw(hdr), intents[0])
        enc.set_raw_image(raw(sdr), intents[1])
        enc.set_quality(90, intents[2])
        enc.set_exif_data(EXIF)
    assert _both_encoders(setup) == jb


def _scan(jpeg: bytes) -> bytes:
    """A JPEG's entropy-coded data (after its SOS) to the end."""
    return jpeg[headers.read_headers(jpeg).sos_end:]


def _base_jpeg(sdr, gamut=None):
    """A 4:2:0 JPEG of SDR planes by the JAX package's encoder, with the
    ICC of `gamut` (none without)."""
    icc = jicc.write_icc_profile("srgb", gamut) if gamut else None
    return jcodec.encode_jpeg(dict(sdr["planes"]), quality=88, icc=icc)


def test_api2_bytes_identical_to_jax():
    hdr = _hdr("BT2100", "PQ", seed=5)
    sdr = _sdr(hdr, "P3", seed=5)
    base = _base_jpeg(sdr, "p3")
    jb = jjpegr.JpegR().encode_api2(jax_raw(hdr), jax_raw(sdr), base,
                                    JTransfer.PQ)
    tb = JpegR("cpu").encode_api2(port_raw(hdr), port_raw(sdr), base,
                                  ColorTransfer.PQ)
    assert tb == jb
    assert _scan(tmux.extract_primary_and_gainmap(tb)[0]) == _scan(base)

    def setup(enc, raw, ci, intents):
        enc.set_raw_image(raw(hdr), intents[0])
        enc.set_raw_image(raw(sdr), intents[1])
        enc.set_compressed_image(ci(data=base), intents[1])
    assert _both_encoders(setup) == jb


@pytest.mark.parametrize("icc_gamut", ["p3", None])
def test_api3_bytes_identical_to_jax(icc_gamut):
    """The base's ICC names the SDR gamut; without one the HDR's is
    taken. Its planes are decoded on the port's device route (B4, B5)."""
    hdr = _hdr("BT2100", "HLG", seed=6)
    base = _base_jpeg(_sdr(hdr, "P3", seed=6), icc_gamut)
    jb = jjpegr.JpegR().encode_api3(jax_raw(hdr), base, JTransfer.HLG)
    tb = JpegR("cpu").encode_api3(port_raw(hdr), base, ColorTransfer.HLG)
    assert tb == jb
    assert _scan(tmux.extract_primary_and_gainmap(tb)[0]) == _scan(base)

    def setup(enc, raw, ci, intents):
        enc.set_raw_image(raw(hdr), intents[0])
        enc.set_compressed_image(ci(data=base), intents[1])
    assert _both_encoders(setup) == jb


def test_api4_and_apix_bytes_identical_to_jax():
    hdr = _hdr("BT709", "PQ", seed=7)
    sdr = _sdr(hdr, "BT709", seed=7)
    base = _base_jpeg(sdr, "bt709")
    gmap = np.random.default_rng(7).integers(0, 256, (H // 4, W // 4),
                                             dtype=np.uint8)
    gm_jpeg = jcodec.encode_jpeg({"y": gmap}, quality=85)
    jmd = jgm.generate_gainmap(
        *(sdr["planes"][k] for k in ("y", "u", "v")), hdr["planes"]["y"],
        hdr["planes"]["uv"], sdr_gamut="bt709", hdr_gamut="bt709",
        hdr_tf="pq")[1]
    md = metadata_from_jax(jmd)
    jb = jjpegr.JpegR().encode_api4(base, gm_jpeg, jmd, exif=EXIF)
    assert JpegR("cpu").encode_api4(base, gm_jpeg, md, exif=EXIF) == jb

    def setup(enc, raw, ci, intents):
        enc.set_compressed_image(ci(data=base), intents[2])
        enc.set_gainmap_image(ci(data=gm_jpeg),
                              jmd if raw is jax_raw else md)
        enc.set_exif_data(EXIF)
    assert _both_encoders(setup) == jb

    calls = tcodec.entropy_encode.calls
    jx = jjpegr.JpegR().encode_apix(jax_raw(sdr), gmap, jmd, 92, exif=EXIF)
    tx = JpegR("cpu").encode_apix(port_raw(sdr), gmap, md, 92, exif=EXIF)
    assert tx == jx
    assert tcodec.entropy_encode.calls - calls == 0


def _code(fn):
    with pytest.raises((UhdrError, JUhdrError)) as e:
        fn()
    return e.value.code


def test_dispatch_error_codes_match_jax():
    hdr = _hdr("BT2100", "HLG", seed=8)
    sdr = _sdr(hdr, "BT709", seed=8)
    base444 = jcodec.encode_jpeg(
        {"y": sdr["planes"]["y"], "u": sdr["planes"]["y"],
         "v": sdr["planes"]["y"]}, quality=80)
    small = _base_jpeg(_sdr(_hdr("BT2100", "HLG", 9, 64, 96), "P3", 9))
    cases = {
        # API-4 without metadata
        "UHDR_CODEC_INVALID_OPERATION": lambda enc, raw, ci, it: (
            enc.set_compressed_image(ci(data=small), it[2]),
            enc.set_gainmap_image(ci(data=small), None)),
        # API-3 from a 4:4:4 base
        "UHDR_CODEC_INVALID_PARAM": lambda enc, raw, ci, it: (
            enc.set_raw_image(raw(hdr), it[0]),
            enc.set_compressed_image(ci(data=base444), it[1])),
    }
    for code, setup in cases.items():
        jenc, tenc = _encoders(setup)
        assert _code(jenc.encode) == _code(tenc.encode) == code
    # API-3 from a base of another size; nothing to encode.
    for setup, code in (
            (lambda enc, raw, ci, it: (
                enc.set_raw_image(raw(hdr), it[0]),
                enc.set_compressed_image(ci(data=small), it[1])),
             "UHDR_CODEC_INVALID_PARAM"),
            (lambda enc, raw, ci, it: enc.set_compressed_image(
                ci(data=small), it[2]), "UHDR_CODEC_INVALID_OPERATION")):
        jenc, tenc = _encoders(setup)
        assert _code(jenc.encode) == _code(tenc.encode) == code
    for jfn, tfn, code in (
            (lambda: japi.UhdrEncoder().set_exif_data(b""),
             lambda: UhdrEncoder("cpu").set_exif_data(b""),
             "UHDR_CODEC_INVALID_PARAM"),
            (lambda: japi.UhdrEncoder().set_compressed_image(
                JCompressed(data=small), japi.GAIN_MAP_IMG),
             lambda: UhdrEncoder("cpu").set_compressed_image(
                 CompressedImage(data=small), "gainmap"),
             "UHDR_CODEC_INVALID_PARAM"),
            (lambda: japi.UhdrEncoder().set_gainmap_image(
                JCompressed(data=b""), None),
             lambda: UhdrEncoder("cpu").set_gainmap_image(
                 CompressedImage(data=b""), None),
             "UHDR_CODEC_INVALID_PARAM")):
        assert _code(jfn) == _code(tfn) == code


def test_b10_wrappers_check_shapes():
    y, uv = _p010(32, 48, seed=2)
    with pytest.raises(ValueError):
        tgm.tonemap_p010(_t(y), _t(uv[:8]))
    with pytest.raises(ValueError):
        tgm.generate_gainmap(*(_t(p[:8]) for p in sdr_from_hdr(y, uv)),
                             _t(y), _t(uv), sdr_gamut="p3",
                             hdr_gamut="bt2100", hdr_tf="pq")
