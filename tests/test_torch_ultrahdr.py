"""The port's UltraHdr converter session (libultrahdr_dev_tpu_torch/
ultrahdr.py: ingest, lazy decode / tone map / gain map, effects through
kernel B13, JPEG / JPEG/R encode, raw outputs through B6 / B7), the
decoded gain-map plane (JpegRDecodeResult.gainmap,
UhdrDecoder.get_gain_map_image) and the 10-bit planar decode, on CPU
tensors, against the JAX package on the same numpy inputs. Mirrors
tests/test_ultrahdr.py's TestSniff, TestFlows and TestRawOutputs, and
its HEIF flows (TestHeifFlows, the HEIF cases of TestCodecRouting,
TestHeifExif, test_heif10_pq_transfer_reaches_gainmap) with the planes
handed to libheif / libavif and the files held against the JAX
session's.

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
        monkeypatch.setattr(batched.dd, "parse_device_headers",
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



# ---------------------------------------------------------------------------
# HEIC / AVIF (the converter's HeifR arms), as tests/test_ultrahdr.py's
# HEIF tests on its 64x96 P010 frame. Every output is held against the
# JAX session's: the planes handed to the encoders (libheif's
# encode_image and encode_rgb10, libavif's encode_yuv) and the file.
# Inputs the JAX tests read from the reference's fixtures (not mounted)
# are files the JAX session writes here.
# ---------------------------------------------------------------------------

from libultrahdr_dev_tpu.container import (isobmff as jiso,  # noqa: E402
                                           libavif as jla, libheif as jlh)
from libultrahdr_dev_tpu.container import jfif as jjfif  # noqa: E402
from libultrahdr_dev_tpu_torch.container import (  # noqa: E402
    isobmff as iso, libavif as la, libheif as lh)
from libultrahdr_dev_tpu_torch.heifr import heif_available  # noqa: E402

needs_heif = pytest.mark.skipif(not heif_available(),
                                reason="libheif not installed")
HEIF_CODECS = ["heic", "heic_r", "heic_10bit", "avif", "avif_r",
               "avif_10bit"]
EXIF = b"Exif\x00\x00MM\x00*\x00\x00\x00\x08" + bytes(range(64))


def _heif_p010(transfer="HLG"):
    """tests/test_ultrahdr.py's p010(): 64x96 luma noise, neutral
    chroma, as (JAX, port) RawImages."""
    rng = np.random.default_rng(2)
    y = (rng.integers(64, 940, (64, 96)).astype(np.uint16)) << 6
    uv = np.full((32, 96), 512 << 6, np.uint16)
    kw = dict(width=96, height=64, planes={"y": y, "uv": uv})
    return (JRawImage(fmt=JPixelFormat.P010, gamut=JGamut.BT2100,
                      transfer=JTransfer[transfer], **kw),
            RawImage(fmt=PixelFormat.P010, gamut=ColorGamut.BT2100,
                     transfer=ColorTransfer[transfer], **kw))


@pytest.fixture
def encoders(monkeypatch):
    """The arguments each package hands to its image encoders:
    {"port": [...], "jax": [...]}, one (function, planes' shapes and
    bytes, other arguments) a call."""
    calls = {"port": [], "jax": []}
    for key, mods in (("port", (lh, la)), ("jax", (jlh, jla))):
        for mod, names in zip(mods, (("encode_image", "encode_rgb10"),
                                     ("encode_yuv",))):
            for name in names:
                real = getattr(mod, name)

                def record(planes, *a, _real=real, _key=key, _name=name,
                           **kw):
                    calls[_key].append((_name, tuple(
                        (np.asarray(p).shape, np.asarray(p).tobytes())
                        for p in planes), a, tuple(sorted(kw.items()))))
                    return _real(planes, *a, **kw)

                monkeypatch.setattr(mod, name, record)
    return calls


def _heif_sessions(*inputs):
    """(JAX session, port session) fed the same inputs: ("p010", tf),
    ("blob", bytes) or ("exif", bytes)."""
    js, ts = ju.UltraHdr(), UltraHdr("cpu")
    for kind, value in inputs:
        if kind == "p010":
            jr, tr = _heif_p010(value)
            js.add_raw(jr)
            ts.add_raw(tr)
        elif kind == "blob":
            js.add_image(value)
            ts.add_image(value)
        else:
            js.exif = ts.exif = value
    return js, ts


def _same_encodes(calls):
    """The encoder calls of both sessions agree: the same functions and
    arguments, 8-bit planes bitwise; the 10-bit arm's planes (B6's HLG or
    PQ codes, then the host's YUV for AVIF) within B6's bar, 1 code with
    >= 99.9% of samples exact. -> whether every plane is bitwise."""
    assert calls["port"] and len(calls["port"]) == len(calls["jax"])
    exact = True
    for (name, planes, a, kw), (jname, jplanes, ja, jkw) in zip(
            calls["port"], calls["jax"]):
        assert (name, a, kw) == (jname, ja, jkw)
        for (shape, data), (jshape, jdata) in zip(planes, jplanes):
            assert shape == jshape
            if name == "encode_image":
                assert data == jdata
                continue
            d = np.abs(np.frombuffer(data, np.uint16).astype(np.int64)
                       - np.frombuffer(jdata, np.uint16))
            assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
            exact = exact and data == jdata
    return exact


def _convert_as_jax(js, ts, encoders, codec, effects=(), **kw):
    """convert() of both sessions: the port's file, held against the
    JAX session's, as are the planes each handed to the encoders; the
    files are byte-identical where the planes are."""
    want = js.convert(ju.UltraHdrConfig(output_codec=codec,
                                        effects=list(effects), **{
        k: (JTransfer[v.name] if k == "transfer" else v)
        for k, v in kw.items()}))
    got = ts.convert(UltraHdrConfig(output_codec=codec,
                                    effects=_port_effects(effects), **kw))
    if _same_encodes(encoders):
        assert got == want
    encoders["port"].clear()
    encoders["jax"].clear()
    return got


def test_heif_brands():
    assert tu.sniff_format(b"\x00\x00\x00\x18ftypheic"
                           + b"\x00" * 8) == "heic"
    assert tu.sniff_format(b"\x00\x00\x00\x18ftypavif"
                           + b"\x00" * 8) == "avif"
    assert tu.sniff_format(b"garbage") == "unknown"


def test_garbage_heif_rejected():
    blob = b"\x00\x00\x00\x18ftypheic" + b"\x00" * 64
    with pytest.raises(JUhdrError) as want:
        ju.UltraHdr().add_image(blob)
    with pytest.raises(UhdrError) as got:
        UltraHdr("cpu").add_image(blob)
    assert got.value.code == want.value.code


@needs_heif
@pytest.mark.parametrize("codec", HEIF_CODECS)
def test_each_heif_codec_converts(codec, encoders):
    """Each of the six HEIC / AVIF outputs converts, to the JAX
    session's file."""
    js, ts = _heif_sessions(("p010", "HLG"))
    out = _convert_as_jax(js, ts, encoders, codec,
                          transfer=ColorTransfer.HLG, max_display_boost=4.9)
    assert tu.sniff_format(out) == codec[:4]


def test_missing_libheif_raises_unsupported(monkeypatch):
    """Without libheif every HEIF output and a gain-map HEIF input raise
    UHDR_CODEC_UNSUPPORTED_FEATURE (a missing host library, not a device
    fallback)."""
    blob = jheifr_blob("heic")
    monkeypatch.setattr(lh, "available", lambda: False)
    ts = _heif_sessions(("p010", "HLG"))[1]
    for codec in ("heic", "heic_r", "avif_r"):
        with pytest.raises(UhdrError, match="UNSUPPORTED_FEATURE"):
            ts.convert(UltraHdrConfig(output_codec=codec))
    with pytest.raises(UhdrError, match="UNSUPPORTED_FEATURE"):
        UltraHdr("cpu").add_image(blob)


_HEIF_BLOBS: dict = {}


def jheifr_blob(codec: str) -> bytes:
    """A gain-map HEIC / AVIF of the JAX session (p010(), HLG)."""
    if codec not in _HEIF_BLOBS:
        _HEIF_BLOBS[codec] = ju.UltraHdr().add_raw(_heif_p010()[0]).convert(
            ju.UltraHdrConfig(output_codec=codec + "_r",
                              transfer=JTransfer.HLG))
    return _HEIF_BLOBS[codec]


@needs_heif
class TestHeifFlows:
    """HEIC_R/AVIF_R converter flows (ultrahdr.cpp:1049-1287)."""

    def test_flow_p010_to_avifr_and_back(self, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        blob = _convert_as_jax(js, ts, encoders, "avif_r",
                               transfer=ColorTransfer.HLG)
        js2, ts2 = _heif_sessions(("blob", blob))
        assert ts2.gainmap_raw is not None and ts2.metadata is not None
        assert np.array_equal(ts2.gainmap_raw, js2.gainmap_raw)
        assert ts2.metadata == metadata_from_jax(js2.metadata)
        out = ts2.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert out == js2.convert(ju.UltraHdrConfig(output_codec="jpeg_r"))
        assert tu.sniff_format(out) == "jpeg_r"

    def test_flow_heicr_to_jpegr(self):
        """The JAX test reads the reference's sample_heicr.heic; here a
        HEIC_R of the JAX session."""
        js, ts = _heif_sessions(("blob", jheifr_blob("heic")))
        blob = ts.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert blob == js.convert(ju.UltraHdrConfig(output_codec="jpeg_r"))
        res = JpegR("cpu").get_info(blob)
        assert (res.width, res.height) == (96, 64)

    def test_flow_p010_to_10bit_heic(self, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        blob = _convert_as_jax(js, ts, encoders, "heic_10bit",
                               transfer=ColorTransfer.HLG,
                               max_display_boost=4.9)
        assert tu.sniff_format(blob) == "heic"

    def test_flow_avifr_with_effects(self, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        blob = _convert_as_jax(js, ts, encoders, "avif_r",
                               [je.MirrorEffect("vertical")],
                               transfer=ColorTransfer.HLG)
        assert tu.sniff_format(blob) == "avif"

    def test_flow_10bit_avif_to_jpegr(self):
        """10-bit HEIF primary -> hdr_raw P010 -> JPEG/R; the JAX test
        reads the reference's avif_yuv_420_10bit.avif, here the JAX
        session's 10-bit AVIF. The P010 planes and the JPEG/R equal the
        JAX session's. The content puts an exact tie in the base's luma
        (block 58, zigzag 39: -45.5 against q = 7), which the JAX
        program quantises by the reciprocal of its constant table to -7
        (ROADMAP Queue C item 5)."""
        src = ju.UltraHdr().add_raw(_heif_p010()[0]).convert(
            ju.UltraHdrConfig(output_codec="avif_10bit",
                              transfer=JTransfer.HLG, max_display_boost=4.9))
        js, ts = _heif_sessions(("blob", src))
        assert ts.hdr_raw is not None and ts.hdr_raw.fmt == PixelFormat.P010
        assert (ts.hdr_raw.width, ts.hdr_raw.height) == (96, 64)
        for k in ("y", "uv"):
            assert np.array_equal(ts.hdr_raw.planes[k], js.hdr_raw.planes[k])
        blob = ts.convert(UltraHdrConfig(output_codec="jpeg_r",
                                         transfer=ColorTransfer.HLG))
        want = js.convert(ju.UltraHdrConfig(output_codec="jpeg_r",
                                            transfer=JTransfer.HLG))
        assert tu.sniff_format(blob) == "jpeg_r"
        assert blob == want

    def test_flow_heicr_to_avifr(self, encoders):
        """testFlow4 analog: HEIC_R gain-map container in -> re-encoded
        gain-map container out."""
        src = jheifr_blob("heic")
        for calls in encoders.values():  # the source's own encodes
            calls.clear()
        js, ts = _heif_sessions(("blob", src))
        blob = _convert_as_jax(js, ts, encoders, "avif_r")
        assert tu.sniff_format(blob) == "avif"
        ts2 = UltraHdr("cpu").add_image(blob)
        assert ts2.gainmap_raw is not None
        assert ts2.metadata.max_content_boost == pytest.approx(
            ts.metadata.max_content_boost, rel=1e-4)


@needs_heif
def test_heif10_pq_transfer_reaches_gainmap(encoders):
    """_convert_to_heif10 must carry the caller's transfer into
    gain-map generation: PQ input implies a 10000/203 max boost in the
    session metadata, not HLG's 1000/203."""
    js, ts = _heif_sessions(("p010", "PQ"))
    blob = _convert_as_jax(js, ts, encoders, "heic_10bit",
                           transfer=ColorTransfer.PQ, max_display_boost=49.3)
    assert tu.sniff_format(blob) == "heic"
    assert ts.metadata.max_content_boost == pytest.approx(10000 / 203,
                                                          rel=1e-6)


@needs_heif
class TestHeifCodecRouting:
    """The HEIF cases of tests/test_ultrahdr.py's TestCodecRouting."""

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_sdr_heif_is_8bit_no_gainmap(self, codec, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        out = _convert_as_jax(js, ts, encoders, codec,
                              transfer=ColorTransfer.HLG)
        hp = iso.parse_heif(out)
        assert not any(it.item_type == "tmap" for it in hp.items.values())
        planes, depth = lh.decode_primary_depth(out, monochrome=False)
        assert depth == 8
        assert planes[0].shape == (64, 96)

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_10bit_heif_is_10bit(self, codec, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        out = _convert_as_jax(js, ts, encoders, codec + "_10bit",
                              transfer=ColorTransfer.HLG,
                              max_display_boost=4.9)
        _, depth = lh.decode_primary_depth(out, monochrome=False)
        assert depth == 10

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_gainmap_heif_has_tmap(self, codec, encoders):
        js, ts = _heif_sessions(("p010", "HLG"))
        out = _convert_as_jax(js, ts, encoders, codec + "_r",
                              transfer=ColorTransfer.HLG)
        hp = iso.parse_heif(out)
        assert any(it.item_type == "tmap" for it in hp.items.values())
        assert hp.items.keys() == jiso.parse_heif(out).items.keys()


@needs_heif
class TestHeifExif:
    def test_exif_survives_jpegr_heicr_jpegr(self, encoders):
        """EXIF round trip JPEG_R -> HEIC_R -> JPEG_R byte-identically
        (heifr.cpp:266-268 encode; heifr.cpp:324-331 decode)."""
        jr_blob = jjpegr.JpegR().encode_api0(_heif_p010()[0], JTransfer.HLG,
                                             quality=95, exif=EXIF)
        js, ts = _heif_sessions(("blob", jr_blob))
        assert ts.exif == EXIF
        heic_blob = _convert_as_jax(js, ts, encoders, "heic_r")
        js2, ts2 = _heif_sessions(("blob", heic_blob))
        assert ts2.exif == EXIF
        jr_out = ts2.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert jr_out == js2.convert(ju.UltraHdrConfig(output_codec="jpeg_r"))
        assert jjfif.parse_jpeg_info(jr_out).exif == EXIF

    def test_exif_on_sdr_heif_output(self, encoders):
        js, ts = _heif_sessions(("p010", "HLG"), ("exif", EXIF))
        out = _convert_as_jax(js, ts, encoders, "heic")
        assert lh.extract_exif(out) == EXIF

    def test_exif_on_10bit_heif_output(self, encoders):
        js, ts = _heif_sessions(("p010", "HLG"), ("exif", EXIF))
        out = _convert_as_jax(js, ts, encoders, "heic_10bit",
                              transfer=ColorTransfer.HLG,
                              max_display_boost=4.9)
        assert lh.extract_exif(out) == EXIF

    def test_plain_heif_ingest_reads_exif(self):
        rng = np.random.default_rng(5)
        planes = (rng.integers(0, 255, (64, 96), dtype=np.uint8),
                  np.full((32, 48), 128, np.uint8),
                  np.full((32, 48), 128, np.uint8))
        blob = lh.encode_image(planes, "heic", 90, exif=EXIF)
        assert blob == jlh.encode_image(planes, "heic", 90, exif=EXIF)
        js, ts = _heif_sessions(("blob", blob))
        assert ts.exif == EXIF
        assert ts.sdr_raw is not None
        for k in ("y", "u", "v"):
            assert np.array_equal(ts.sdr_raw.planes[k], js.sdr_raw.planes[k])
