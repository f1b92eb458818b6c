"""The port's HeifR (libultrahdr_dev_tpu_torch/heifr.py: gain-map
HEIC/AVIF with its pixel math through B10a, B10b, B6 and B7, here their
plain versions on the CPU) against the JAX package's (heifr.py) on the
same numpy inputs. Mirrors tests/test_heifr.py; its 8192x4320 grid case
runs in chip_smoke.py's HEIF window instead.

Bars: the planes handed to libheif (base Y/U/V and the gain-map plane,
every grid tile) bitwise the JAX package's; the tmap metadata bytes and
the container boxes too; the whole file byte-identical, since libheif's
HEVC and AV1 encoders are deterministic on the same planes
(test_libheif_encodes_are_deterministic holds that premise with the JAX
package alone); pixels decoded from one blob within 1 F16 ULP / 1 code
with >= 99.9% of channel samples exact, SDR within 1."""

import os

import numpy as np
import pytest

from libultrahdr_dev_tpu import heifr as jheifr
from libultrahdr_dev_tpu.container import isobmff as jiso, libheif as jlh
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       GainMapMetadata as JMetadata,
                                       OutputFormat as JOutputFormat,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage)
from libultrahdr_dev_tpu_torch import heifr
from libultrahdr_dev_tpu_torch.container import isobmff as iso, libheif as lh
from libultrahdr_dev_tpu_torch.heifr import HeifR, heif_available
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.types import (ColorGamut, ColorTransfer,
                                             GainMapMetadata, OutputFormat,
                                             PixelFormat, RawImage,
                                             UhdrError)

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)
from test_heifr import SAMPLE  # the reference's fixture, where mounted

needs_heif = pytest.mark.skipif(not heif_available(),
                                reason="libheif not installed")


def p010_pair(y, uv):
    """The same P010 planes as a port RawImage and a JAX RawImage."""
    h, w = y.shape
    return (RawImage(fmt=PixelFormat.P010, width=w, height=h,
                     gamut=ColorGamut.BT2100, planes={"y": y, "uv": uv}),
            JRawImage(fmt=JPixelFormat.P010, width=w, height=h,
                      gamut=JGamut.BT2100, planes={"y": y, "uv": uv}))


def _p010(h, w, seed=0):
    """tests/test_heifr.py's content: 16x16 luma blocks, neutral
    chroma."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(2, 12, (h // 16, w // 16)).astype(np.uint16)
         .repeat(16, 0).repeat(16, 1) * 64 + 64) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    return p010_pair(y, uv)


@pytest.fixture
def handed(monkeypatch):
    """The planes each package hands to libheif's encoder:
    {"port": [...], "jax": [...]}, one entry (codec, quality, planes'
    bytes and shapes) a call."""
    calls = {"port": [], "jax": []}
    for key, mod in (("port", lh), ("jax", jlh)):
        real = mod.encode_image

        def record(planes, codec, quality, *a, _real=real, _key=key, **kw):
            calls[_key].append((codec, quality, tuple(
                (np.asarray(p).shape, np.asarray(p, np.uint8).tobytes())
                for p in planes)))
            return _real(planes, codec, quality, *a, **kw)

        monkeypatch.setattr(mod, "encode_image", record)
    return calls


def same_planes(calls):
    """Both packages handed libheif the same planes (grid tiles encode on
    a thread pool, so as multisets)."""
    assert calls["port"] and sorted(calls["port"]) == sorted(calls["jax"])


def pixel_diff(got, want, fmt: PixelFormat):
    """|got - want| per channel sample: 10-bit codes of RGBA1010102,
    F16 bit patterns of RGB, bytes of RGBA8888."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fmt == PixelFormat.RGBA1010102:
        g, w = got.astype(np.int64), want.astype(np.int64)
        return np.stack([np.abs(((g >> s) & 1023) - ((w >> s) & 1023))
                         for s in (0, 10, 20)])
    if fmt == PixelFormat.RGBA_F16:
        return np.abs(got[..., :3].astype(np.int64)
                      - want[..., :3].astype(np.int64))
    return np.abs(got.view(np.uint8).astype(np.int64)
                  - want.view(np.uint8).astype(np.int64))


def decode_as_jax(codec, blob, fmt: str, boost=float("inf")):
    """Both packages decode one blob: the port's result, and its pixels
    held against JAX's within the parity bar; the gain map, metadata,
    base planes and EXIF equal."""
    res = HeifR(codec, "cpu").decode(blob, OutputFormat[fmt], boost)
    want = jheifr.HeifR(codec).decode(blob, JOutputFormat[fmt], boost)
    d = pixel_diff(res.image.planes["rgba"], want.image.planes["rgba"],
                   res.image.fmt)
    assert int(d.max()) <= 1
    if fmt != "SDR":
        assert float((d == 0).mean()) >= 0.999
    assert res.image.fmt.name == want.image.fmt.name
    assert np.array_equal(res.gainmap, np.asarray(want.gainmap))
    assert res.metadata == metadata_from_jax(want.metadata)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(res.base_yuv, want.base_yuv))
    assert res.exif == want.exif
    return res


@needs_heif
@pytest.mark.parametrize("codec", ["avif", "heic"])
def test_libheif_encodes_are_deterministic(codec):
    """The premise of the byte-identity bar: the JAX package's encode of
    one frame, twice, gives the same file."""
    _, jp = _p010(64, 96, seed=3)
    hr = jheifr.HeifR(codec)
    assert hr.encode_api0(jp, JTransfer.HLG, quality=90) == \
        hr.encode_api0(jp, JTransfer.HLG, quality=90)


@needs_heif
def test_decode_sample_heicr():
    if not os.path.exists(SAMPLE):
        pytest.skip("reference fixture unavailable")
    data = open(SAMPLE, "rb").read()
    res = decode_as_jax("avif", data, "HDR_LINEAR", 10.0)
    assert (res.width, res.height) == (1280, 720)
    assert res.gainmap.shape == (180, 320)
    assert res.metadata.max_content_boost == pytest.approx(10.0)
    assert res.image.planes["rgba"].shape == (720, 1280, 4)
    sdr = decode_as_jax("avif", data, "SDR")
    assert sdr.image.planes["rgba"].shape == (720, 1280)


@needs_heif
@pytest.mark.parametrize("codec", ["avif", "heic"])
def test_encode_decode_roundtrip(codec, handed):
    tp, jp = _p010(96, 128)
    blob = HeifR(codec, "cpu").encode_api0(tp, ColorTransfer.HLG,
                                           quality=90)
    assert blob == jheifr.HeifR(codec).encode_api0(jp, JTransfer.HLG,
                                                   quality=90)
    same_planes(handed)
    # Container structure: tmap + dimg + hidden gain map.
    hp = iso.parse_heif(blob)
    types = sorted(it.item_type for it in hp.items.values())
    assert "tmap" in types
    tmap = [i for i, it in hp.items.items() if it.item_type == "tmap"][0]
    assert len(hp.refs[("dimg", tmap)]) == 2
    res = decode_as_jax(codec, blob, "HDR_LINEAR", 1000 / 203)
    assert (res.width, res.height) == (128, 96)
    assert res.metadata.max_content_boost == pytest.approx(1000 / 203,
                                                           rel=1e-4)
    assert res.gainmap.shape == (24, 32)
    out = res.image.planes["rgba"]
    assert out.shape == (96, 128, 4) and out.any()


@needs_heif
def test_heifr_records_its_stages():
    """HeifR(times=...) records encode_api0's device stage and coded
    encode, and decode's coded decode and device stage, once a call
    (heifr.STAGES); without times nothing is recorded."""
    from libultrahdr_dev_tpu_torch.utils.profiler import StageTimes

    tp, _ = _p010(64, 96)
    hr = HeifR("heic", "cpu", times=StageTimes())
    blob = hr.encode_api0(tp, ColorTransfer.HLG, quality=90)
    hr.decode(blob, OutputFormat.SDR)
    assert list(hr.times.counts) == list(heifr.STAGES)
    assert set(hr.times.counts.values()) == {1}
    assert HeifR("heic", "cpu").times is None


@needs_heif
def test_encode_api1_and_apix(handed):
    tp, jp = _p010(64, 96, seed=1)
    rng = np.random.default_rng(2)
    planes = {"y": rng.integers(16, 235, (64, 96), np.uint8),
              "u": np.full((32, 48), 128, np.uint8),
              "v": np.full((32, 48), 128, np.uint8)}
    sdr = RawImage(fmt=PixelFormat.YUV420, width=96, height=64,
                   gamut=ColorGamut.BT709, planes=planes)
    jsdr = JRawImage(fmt=JPixelFormat.YUV420, width=96, height=64,
                     gamut=JGamut.BT709, planes=planes)
    hr, jhr = HeifR("avif", "cpu"), jheifr.HeifR("avif")
    blob = hr.encode_api1(tp, sdr, ColorTransfer.HLG, quality=90)
    assert blob == jhr.encode_api1(jp, jsdr, JTransfer.HLG, quality=90)
    res = decode_as_jax("avif", blob, "HDR_HLG", 1000 / 203)
    assert res.image.planes["rgba"].shape == (64, 96)

    blob2 = hr.encode_apix(sdr, res.gainmap, res.metadata, quality=85)
    jres = jhr.decode(blob, JOutputFormat.HDR_HLG,
                      max_display_boost=1000 / 203)
    assert blob2 == jhr.encode_apix(jsdr, jres.gainmap, jres.metadata,
                                    quality=85)
    same_planes(handed)
    res2 = decode_as_jax("avif", blob2, "HDR_LINEAR")
    assert res2.gainmap.shape == res.gainmap.shape


def test_no_silent_gainmap_loss(monkeypatch):
    """Without libheif, encode must raise — never emit a gain-map-less
    file — and before any device work."""
    monkeypatch.setattr(lh, "_lib", None)
    monkeypatch.setattr(lh, "_tried", True)
    tp, _ = _p010(32, 32)
    with pytest.raises(UhdrError) as ei:
        HeifR("heic", "cpu").encode_api0(tp, ColorTransfer.HLG)
    assert "UNSUPPORTED" in str(ei.value)


def test_tmap_metadata_roundtrip():
    kw = dict(max_content_boost=4.926108, min_content_boost=1.0,
              gamma=1.0, offset_sdr=0.0, offset_hdr=0.0,
              hdr_capacity_min=1.0, hdr_capacity_max=4.926108)
    enc = iso.encode_tmap_metadata(GainMapMetadata(**kw))
    assert enc == jiso.encode_tmap_metadata(JMetadata(**kw))
    back = iso.decode_tmap_metadata(enc)
    assert back.max_content_boost == pytest.approx(4.926108, abs=1e-6)
    assert back.min_content_boost == 1.0
    assert back.gamma == 1.0
    assert back == metadata_from_jax(jiso.decode_tmap_metadata(enc))


@needs_heif
@pytest.mark.parametrize("codec", ["avif", "heic"])
def test_exif_roundtrip(codec):
    """Exif item written to / parsed from the gain-map container
    (heifr.cpp:266-268, 324-331)."""
    exif = b"Exif\x00\x00MM\x00*\x00\x00\x00\x08" + bytes(range(32))
    tp, jp = _p010(96, 128)
    hr = HeifR(codec, "cpu")
    blob = hr.encode_api0(tp, ColorTransfer.HLG, quality=90, exif=exif)
    assert blob == jheifr.HeifR(codec).encode_api0(
        jp, JTransfer.HLG, quality=90, exif=exif)
    assert decode_as_jax(codec, blob, "SDR").exif == exif
    blob2 = hr.encode_api0(tp, ColorTransfer.HLG, quality=90)
    assert hr.decode(blob2, OutputFormat.SDR).exif is None


@needs_heif
def test_grid_encode_roundtrip(monkeypatch, handed):
    """>limit dimensions split into a HEIF 'grid' of coded tiles;
    decode reassembles them. The shrunken limit exercises 2x3 luma
    tiling + a tiled gain map cheaply; tile placement is proven by a
    spatial gradient."""
    monkeypatch.setattr(heifr, "GRID_TILE_LIMIT", 64)
    monkeypatch.setattr(jheifr, "GRID_TILE_LIMIT", 64)
    h, w = 96, 160  # 2x3 tile lattice at limit 64
    y = np.add.outer(np.linspace(100, 600, h),
                     np.linspace(0, 300, w)).astype(np.uint16) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    tp, jp = p010_pair(y, uv)
    hr = HeifR("heic", "cpu")
    blob = hr.encode_api0(tp, ColorTransfer.HLG, quality=90)
    assert blob == jheifr.HeifR("heic").encode_api0(jp, JTransfer.HLG,
                                                     quality=90)
    same_planes(handed)
    assert len(handed["port"]) == 6 + 1  # base tiles, one gain-map image
    hp = iso.parse_heif(blob)
    grids = [i for i, it in hp.items.items() if it.item_type == "grid"]
    assert grids, "expected a grid root item"
    assert len(hp.refs[("dimg", grids[0])]) == 6
    res = decode_as_jax("heic", blob, "SDR")
    assert (res.width, res.height) == (w, h)
    # The tone-mapped base must track the input gradient tile-free:
    # compare against an un-gridded encode of the same image.
    monkeypatch.setattr(heifr, "GRID_TILE_LIMIT", 4096)
    ref = hr.decode(hr.encode_api0(tp, ColorTransfer.HLG, quality=90),
                    OutputFormat.SDR)
    dy = (res.base_yuv[0].astype(np.int32)
          - ref.base_yuv[0].astype(np.int32))
    assert np.abs(dy).mean() < 4.0
