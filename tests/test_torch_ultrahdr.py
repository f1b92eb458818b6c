"""The port's UltraHdr converter session (libultrahdr_dev_tpu_torch/
ultrahdr.py: ingest, lazy decode / tone map / gain map, effects through
kernel B13, JPEG / JPEG/R encode, raw outputs through B6 / B7), the
decoded gain-map plane (JpegRDecodeResult.gainmap,
UhdrDecoder.get_gain_map_image) and the 10-bit planar decode, on CPU
tensors, against the JAX package on the same numpy inputs. Mirrors
tests/test_ultrahdr.py's TestSniff, TestFlows and TestRawOutputs (the
cases without HEIF).

Bars: convert("jpeg") and convert("jpeg_r") bytes identical to the JAX
session's, with and without effects, for every ingest the priority chain
distinguishes; YUV420 and RGBA8888 raw outputs and the gain-map plane
bit-exact; F16, RGBA1010102 and 10-bit planar outputs within 1 F16 ULP
/ 1 code with >= 99.9% of channel samples exact; the JAX package's error
codes. Frames are 104x72 (a 26x18 gain map), a size where XLA's
reduce_window sums each box row-major, as the plain box mean does."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import api as japi, jpegr as jjpegr
from libultrahdr_dev_tpu import ultrahdr as ju
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.ops import editor as je, gainmap as jgm
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       OutputFormat as JOutputFormat,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage,
                                       UhdrError as JUhdrError)
from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                       OutputFormat, PixelFormat, RawImage,
                                       UhdrDecoder, UhdrError, UltraHdr,
                                       UltraHdrConfig)
from libultrahdr_dev_tpu_torch import ultrahdr as tu
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.jpeg import codec as tcodec
from libultrahdr_dev_tpu_torch.ops import editor as te
from libultrahdr_dev_tpu_torch.parallel import batched

import test_torch_jax_native  # noqa: F401  (loads the JAX native codec)
from test_torch_api1 import sdr_from_hdr
from test_torch_jpegr import synth_p010
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 72, 104
C, M, R, Z = je.CropEffect, je.MirrorEffect, je.RotateEffect, je.ResizeEffect
# Chains whose gain map keeps an integer 4:1 ratio to the SDR.
CHAINS = {
    "none": [],
    "mirror+rotate": [M("horizontal"), R(90)],
    "crop": [C(0, 48, 0, 32)],
    "crop+rotate+mirror+resize": [C(8, 104, 8, 72), R(270), M("vertical"),
                                  Z(32, 48)],
}


def _port_effects(effects):
    kinds = {C: te.CropEffect, M: te.MirrorEffect, R: te.RotateEffect,
             Z: te.ResizeEffect}
    return [kinds[type(e)](**vars(e)) for e in effects]


def _hdr(seed=1):
    y, uv = synth_p010(H, W, seed=seed)
    kw = dict(width=W, height=H, planes={"y": y, "uv": uv})
    return (JRawImage(fmt=JPixelFormat.P010, gamut=JGamut.BT2100,
                      transfer=JTransfer.HLG, **kw),
            RawImage(fmt=PixelFormat.P010, gamut=ColorGamut.BT2100,
                     transfer=ColorTransfer.HLG, **kw))


def _sdr(seed=1, gamut="BT709"):
    y, uv = synth_p010(H, W, seed=seed)
    py, pu, pv = sdr_from_hdr(y, uv, seed=seed)
    kw = dict(width=W, height=H, planes={"y": py, "u": pu, "v": pv})
    return (JRawImage(fmt=JPixelFormat.YUV420, gamut=JGamut[gamut], **kw),
            RawImage(fmt=PixelFormat.YUV420, gamut=ColorGamut[gamut], **kw))


_BLOBS: dict = {}


def _jpegr():
    """A JPEG/R of the JAX package's general route (104 columns)."""
    if "jpegr" not in _BLOBS:
        _BLOBS["jpegr"] = jjpegr.JpegR().encode_api0(_hdr(3)[0],
                                                     JTransfer.HLG, 95)
    return _BLOBS["jpegr"]


def _jpeg():
    """A plain 4:2:0 JPEG with a Display-P3 ICC."""
    if "jpeg" not in _BLOBS:
        from libultrahdr_dev_tpu.container import icc as jicc
        _BLOBS["jpeg"] = jcodec.encode_jpeg(
            dict(_sdr(4, "P3")[0].planes), quality=90,
            icc=jicc.write_icc_profile("srgb", "p3"))
    return _BLOBS["jpeg"]


def _gainmap_inputs():
    """A raw gain map (B10b's of the BT.709 SDR against the HLG HDR) and
    its metadata, for the API-x ingest."""
    jsdr, jhdr = _sdr(5)[0], _hdr(5)[0]
    gmap, md = jgm.generate_gainmap(
        *(jsdr.planes[k] for k in ("y", "u", "v")), jhdr.planes["y"],
        jhdr.planes["uv"], sdr_gamut="bt709", hdr_gamut="bt2100",
        hdr_tf="hlg")
    return np.array(gmap), md


def _ingest(source):
    """(JAX session, port session) fed the same inputs."""
    js, ts = ju.UltraHdr(), UltraHdr("cpu")
    for part in source.split("+"):
        if part == "jpeg_r":
            js.add_image(_jpegr())
            ts.add_image(_jpegr())
        elif part == "jpeg":
            js.add_image(_jpeg())
            ts.add_image(_jpeg())
        elif part == "p010":
            jr, tr = _hdr(6)
            js.add_raw(jr)
            ts.add_raw(tr)
        elif part == "yuv420":
            jr, tr = _sdr(6)
            js.add_raw(jr)
            ts.add_raw(tr)
        elif part == "gainmap":
            gmap, md = _gainmap_inputs()
            js.add_gainmap(gmap, md)
            ts.add_gainmap(gmap, metadata_from_jax(md))
    return js, ts


def _configs(codec, chain, **kw):
    effects = CHAINS[chain]
    return (ju.UltraHdrConfig(output_codec=codec, effects=effects, **kw),
            UltraHdrConfig(output_codec=codec,
                           effects=_port_effects(effects), **kw))


class TestSniff:
    def test_matches_jax(self):
        blobs = [_jpegr(), _jpeg(), b"\x00\x00\x00\x18ftypheic" + b"\x00" * 8,
                 b"\x00\x00\x00\x18ftypavif" + b"\x00" * 8, b"garbage"]
        got = [tu.sniff_format(b) for b in blobs]
        assert got == [ju.sniff_format(b) for b in blobs]
        assert got == ["jpeg_r", "jpeg", "heic", "avif", "unknown"]


# (ingest, output codec, chain): every arm of the JAX priority chain
# (ultrahdr.py:459-510) and the JPEG output, with and without effects.
FLOWS = [
    ("jpeg_r", "jpeg", "none"),                      # base passthrough
    ("jpeg_r", "jpeg", "crop"),
    ("jpeg_r", "jpeg_r", "none"),                    # API-4 remux
    ("jpeg_r", "jpeg_r", "mirror+rotate"),           # decoded parts
    ("jpeg_r", "jpeg_r", "crop+rotate+mirror+resize"),
    ("p010", "jpeg_r", "none"),                      # API-0
    ("p010", "jpeg_r", "mirror+rotate"),             # tone map + effects
    ("p010", "jpeg", "crop"),
    ("yuv420", "jpeg", "none"),
    ("p010+yuv420", "jpeg_r", "none"),               # API-1
    ("p010+yuv420", "jpeg_r", "crop+rotate+mirror+resize"),
    ("jpeg+p010", "jpeg_r", "none"),                 # API-3
    ("jpeg+p010", "jpeg_r", "crop"),                 # tone map (API-0 arm)
    ("jpeg+p010+yuv420", "jpeg_r", "none"),          # API-2
    ("yuv420+gainmap", "jpeg_r", "mirror+rotate"),   # API-x
]


@pytest.mark.parametrize("source,codec,chain", FLOWS)
def test_convert_bytes_identical_to_jax(source, codec, chain):
    js, ts = _ingest(source)
    jcfg, tcfg = _configs(codec, chain, quality=92)
    want = js.convert(jcfg)
    got = ts.convert(tcfg)
    assert got == want
    assert tu.sniff_format(got) == codec


def test_flow_geometry_with_effects():
    """testFlow3: P010 -> JPEG_R with mirror + rotate swaps the sizes of
    the image and its gain map."""
    _, ts = _ingest("p010")
    out = ts.convert(_configs("jpeg_r", "mirror+rotate")[1])
    info = JpegR("cpu").get_info(out)
    assert (info.width, info.height) == (H, W)
    assert (info.gainmap_width, info.gainmap_height) == (H // 4, W // 4)


def _diff(got, want, fmt):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fmt in (PixelFormat.RGBA1010102,):
        g, w = got.astype(np.int64), want.astype(np.int64)
        return np.stack([np.abs(((g >> s) & 1023) - ((w >> s) & 1023))
                         for s in (0, 10, 20)])
    if fmt == PixelFormat.RGBA_F16:
        got, want = got[..., :3], want[..., :3]
    return np.abs(got.astype(np.int64) - want.astype(np.int64))


# (raw output config, its exactness): YUV420 and RGBA8888 bit-exact; the
# gain-map reconstructions within 1 code / ULP, >= 99.9% exact.
RAW = [
    (dict(output_pixel_format="YUV420"), True),
    (dict(output_format="SDR"), True),
    (dict(output_pixel_format="RGBA8888"), True),
    (dict(output_format="HDR_LINEAR", max_display_boost=4.9), False),
    (dict(output_format="HDR_HLG"), False),
    (dict(output_format="HDR_PQ"), False),
    (dict(output_pixel_format="RGB_10BIT_PLANAR", max_display_boost=4.9),
     False),
]


def _raw_configs(chain, spec):
    kw = {k: v for k, v in spec.items()
          if k not in ("output_pixel_format", "output_format")}
    out = []
    for fmt_t, pix_t, cls in ((JOutputFormat, JPixelFormat, ju.UltraHdrConfig),
                              (OutputFormat, PixelFormat, UltraHdrConfig)):
        c = dict(kw)
        if "output_format" in spec:
            c["output_format"] = fmt_t[spec["output_format"]]
        if "output_pixel_format" in spec:
            c["output_pixel_format"] = pix_t[spec["output_pixel_format"]]
        effects = CHAINS[chain]
        out.append(cls(effects=effects if cls is ju.UltraHdrConfig
                       else _port_effects(effects), **c))
    return out


@pytest.mark.parametrize("source,chain", [
    ("p010", "none"), ("p010", "mirror+rotate"),
    ("jpeg_r", "crop+rotate+mirror+resize")])
@pytest.mark.parametrize("spec,exact", RAW)
def test_raw_outputs_match_jax(source, chain, spec, exact):
    js, ts = _ingest(source)
    jcfg, tcfg = _raw_configs(chain, spec)
    want, got = js.convert_to_raw(jcfg), ts.convert_to_raw(tcfg)
    assert got.fmt.value == want.fmt.value
    assert got.transfer.value == want.transfer.value
    assert (got.width, got.height) == (want.width, want.height)
    assert set(got.planes) == set(want.planes)
    for k in want.planes:
        d = _diff(got.planes[k], want.planes[k], got.fmt)
        if exact:
            assert int(d.max()) == 0
        else:
            assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999


def test_p010_passthrough():
    _, src = _hdr()
    img = UltraHdr("cpu").add_raw(src).convert_to_raw(UltraHdrConfig(
        output_pixel_format=PixelFormat.P010))
    assert img is src


def test_hdr_direct_matches_apply():
    """F16 output equals apply_gainmap_metadata on the session's own
    planes (no compress/decompress round trip)."""
    from libultrahdr_dev_tpu_torch.ops import gainmap as tgm

    _, ts = _ingest("p010")
    img = ts.convert_to_raw(UltraHdrConfig(
        output_format=OutputFormat.HDR_LINEAR, max_display_boost=4.9))
    sdr = ts.sdr_raw.planes
    ref = tgm.apply_gainmap_metadata(sdr["y"], sdr["u"], sdr["v"],
                                     ts.gainmap_raw, ts.metadata,
                                     "hdr_linear", 4.9)
    np.testing.assert_array_equal(img.planes["rgba"],
                                  ref.numpy().view(np.uint16))


def _jax_pixels(blob, fmt):
    return np.asarray(jjpegr.JpegR().decode(blob, JOutputFormat[fmt])
                      .image.planes["rgba"])


def test_rgb10_decode_matches_jax():
    """JpegR.decode to HDR_LINEAR_RGB_10BIT: (3, h, w) uint16 codes,
    linear transfer, against the JAX decode of the same blob."""
    blob = _jpegr()
    res = JpegR("cpu").decode(blob, OutputFormat.HDR_LINEAR_RGB_10BIT, 4.9)
    img = res.image
    assert img.fmt == PixelFormat.RGB_10BIT_PLANAR
    assert img.transfer == ColorTransfer.LINEAR
    want = np.asarray(jjpegr.JpegR().decode(
        blob, JOutputFormat.HDR_LINEAR_RGB_10BIT, 4.9).image.planes["rgba"])
    d = _diff(img.planes["rgba"], want, img.fmt)
    assert img.planes["rgba"].shape == (3, H, W)
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999


@pytest.mark.parametrize("route", ["device", "host"])
def test_gain_map_image_matches_jax(route, monkeypatch):
    """The decoded gain-map plane equals JAX's on both decode routes:
    the device route (B4 + B5 of the gray stream) and the host route
    (host Huffman + B5, taken here by refusing every stream to the
    device decoder)."""
    blob = _jpegr()
    jdec = japi.UhdrDecoder().set_image(blob)
    jdec.decode()
    want = np.asarray(jdec.get_gain_map_image())
    if route == "host":
        monkeypatch.setattr(batched.dd, "parse_device_stream",
                            lambda data: None)
    calls = tcodec.entropy_decode.calls
    dec = UhdrDecoder("cpu").set_image(blob)
    dec.decode()
    got = dec.get_gain_map_image()
    assert tcodec.entropy_decode.calls - calls == (2 if route == "host"
                                                   else 0)
    assert got.dtype == np.uint8 and got.shape == (H // 4, W // 4)
    np.testing.assert_array_equal(got, want)
    # No gain-map plane after an SDR decode, in either package.
    sdr = UhdrDecoder("cpu").set_image(blob)
    sdr.set_out_img_format(PixelFormat.RGBA8888)
    sdr.set_out_color_transfer(ColorTransfer.SRGB)
    sdr.decode()
    assert JpegR("cpu").decode(blob, OutputFormat.SDR).gainmap is None
    with pytest.raises(UhdrError, match="INVALID_OPERATION"):
        sdr.get_gain_map_image()
    with pytest.raises(UhdrError, match="INVALID_OPERATION"):
        UhdrDecoder("cpu").get_gain_map_image()


def test_encode_apix_takes_tensor_planes():
    """encode_apix encodes device-resident planes where they lie (here
    CPU tensors) to the JAX package's bytes for the numpy planes."""
    jsdr, tsdr = _sdr(7)
    gmap, md = _gainmap_inputs()
    want = jjpegr.JpegR().encode_apix(jsdr, gmap, md, 90)
    planes = {k: torch.from_numpy(v.copy()) for k, v in tsdr.planes.items()}
    tens = RawImage(fmt=PixelFormat.YUV420, width=W, height=H,
                    gamut=ColorGamut.BT709, planes=planes)
    got = JpegR("cpu").encode_apix(tens, torch.from_numpy(gmap.copy()),
                                   metadata_from_jax(md), 90)
    assert got == want
    assert JpegR("cpu").encode_apix(tsdr, gmap, metadata_from_jax(md),
                                    90) == want


def _code(fn):
    with pytest.raises((UhdrError, JUhdrError)) as e:
        fn()
    return e.value.code


def test_error_codes_match_jax():
    for source, cfg, code in (
            ("", ("jpeg_r", "none"), "UHDR_CODEC_INVALID_OPERATION"),
            ("", ("jpeg", "none"), "UHDR_CODEC_INVALID_OPERATION"),
            ("p010", ("webp", "none"), "UHDR_CODEC_INVALID_PARAM"),
            ("p010", ("jpeg_r", "crop"), None)):
        js, ts = _ingest(source) if source else (ju.UltraHdr(),
                                                 UltraHdr("cpu"))
        jcfg, tcfg = _configs(*cfg)
        if code is None:
            assert ts.convert(tcfg) == js.convert(jcfg)
            continue
        assert _code(lambda: js.convert(jcfg)) == code
        assert _code(lambda: ts.convert(tcfg)) == code
    jraw = JRawImage(fmt=JPixelFormat.RGBA8888, width=4, height=4)
    traw = RawImage(fmt=PixelFormat.RGBA8888, width=4, height=4)
    assert _code(lambda: ju.UltraHdr().add_raw(jraw)) == \
        _code(lambda: UltraHdr("cpu").add_raw(traw)) == \
        "UHDR_CODEC_INVALID_PARAM"
    assert _code(lambda: ju.UltraHdr().add_image(b"garbage")) == \
        _code(lambda: UltraHdr("cpu").add_image(b"garbage")) == \
        "UHDR_CODEC_INVALID_PARAM"
    # P010 output without a raw HDR input; a bad crop window.
    js, ts = _ingest("jpeg_r")
    jcfg, tcfg = _raw_configs("none", dict(output_pixel_format="P010"))
    assert _code(lambda: js.convert_to_raw(jcfg)) == \
        _code(lambda: ts.convert_to_raw(tcfg)) == \
        "UHDR_CODEC_INVALID_OPERATION"
    bad = [C(0, W + 2, 0, H)]
    assert _code(lambda: js.convert(ju.UltraHdrConfig(effects=bad))) == \
        _code(lambda: ts.convert(UltraHdrConfig(
            effects=_port_effects(bad)))) == "UHDR_CODEC_INVALID_PARAM"


@pytest.mark.parametrize("codec", ["heic", "heic_r", "heic_10bit", "avif",
                                   "avif_r", "avif_10bit"])
def test_heif_requests_raise_unsupported(codec):
    """HEIC / AVIF outputs and inputs are queued (ROADMAP Queue A, "The
    converter's HEIF/AVIF arms")."""
    _, ts = _ingest("p010")
    with pytest.raises(UhdrError,
                       match="UNSUPPORTED_FEATURE.*HEIF/AVIF arms"):
        ts.convert(UltraHdrConfig(output_codec=codec))
    brand = b"avif" if codec.startswith("avif") else b"heic"
    with pytest.raises(UhdrError,
                       match="UNSUPPORTED_FEATURE.*HEIF/AVIF arms"):
        UltraHdr("cpu").add_image(b"\x00\x00\x00\x18ftyp" + brand
                                  + b"\x00" * 64)


def test_planes_stay_on_the_session_device():
    """A JPEG/R ingest keeps its decoded planes as tensors on the
    session's device through effects; the raw outputs are numpy."""
    _, ts = _ingest("jpeg_r")
    ts.convert(_configs("jpeg_r", "crop")[1])
    assert isinstance(ts.gainmap_raw, torch.Tensor)
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for p in ts.sdr_raw.planes.values())
    img = ts.convert_to_raw(UltraHdrConfig(
        output_pixel_format=PixelFormat.YUV420))
    assert all(isinstance(p, np.ndarray) for p in img.planes.values())


def test_caller_planes_read_on_each_convert():
    """A caller's numpy planes edited in place between two converts: the
    JAX session reads them again, and so does the port's (ROADMAP
    Queue C 2: 13,152 bytes, then 13,158)."""
    rng = np.random.default_rng(0)
    planes = {"y": rng.integers(0, 256, (H, W), dtype=np.uint8),
              "u": rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              "v": rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8)}
    js, ts = ju.UltraHdr(), UltraHdr("cpu")
    js.add_raw(JRawImage(fmt=JPixelFormat.YUV420, width=W, height=H,
                         gamut=JGamut.BT709, planes=planes))
    ts.add_raw(RawImage(fmt=PixelFormat.YUV420, width=W, height=H,
                        gamut=ColorGamut.BT709, planes=planes))
    sizes = []
    for _ in range(2):
        want = js.convert(ju.UltraHdrConfig("jpeg"))
        assert ts.convert(UltraHdrConfig("jpeg")) == want
        sizes.append(len(want))
        raw = ts.convert_to_raw(UltraHdrConfig(
            output_pixel_format=PixelFormat.YUV420))
        np.testing.assert_array_equal(raw.planes["y"], planes["y"])
        planes["y"][:] = 255 - planes["y"]
    assert sizes == [13152, 13158]
