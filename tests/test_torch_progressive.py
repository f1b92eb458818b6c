"""The port's progressive (SOF2) and multi-scan baseline JPEG decode
(libultrahdr_dev_tpu_torch/jpeg/codec.py: _decode_multiscan over
jpeg/entropy.cpp's uhdr_prog_* scan decoders) on the CPU, against the
JAX package, PIL and the port's own plain specification (jpeg/
huffman.py).

Mirrors tests/test_jpeg.py's TestProgressive, TestMultiScanBaseline,
the fill bytes between segments and TestThreadedProgressiveScans, and
tests/test_huffman_fallback.py against the port's huffman.py (the plain
specification in place of the native scan decoders). Bars of the port's
own cases: coefficient grids identical to the JAX package's for every
progressive and multi-scan file, at 1 scan thread and at the default
count; planes equal to the JAX decode_jpeg's; a JPEG/R with a
progressive primary decoded through the stable API within 1 F16 ULP of
the JAX package's host route (SDR within 1); API-3 with a progressive
SDR JPEG writes the JAX package's bytes, through JpegR, the UltraHdr
converter and the command-line tool; the committed 4000x3000 fixture
(tests/fixtures_torch) decodes to the digest its sidecar records, which
the JAX package's grids give on every run; the device decoder refuses
SOF2 and multi-scan streams; and without the native library the
progressive decode raises, the plain specification never running in
its place."""

import io
import json

import numpy as np
import pytest

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.types import ColorTransfer as JTransfer
from libultrahdr_dev_tpu_torch import (ColorTransfer, JpegR, OutputFormat,
                                       PixelFormat, UhdrDecoder, UhdrError)
from libultrahdr_dev_tpu_torch.jpeg import codec, huffman, tables
from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
from libultrahdr_dev_tpu_torch.jpeg.dct import fdct_quant
from libultrahdr_dev_tpu_torch.types import GainMapMetadata

from fixtures_torch import prog_fixture
from test_torch_api1 import jax_raw, port_raw
from test_torch_general_encode import _hdr
from test_torch_jpegr import channel_diff, jax_host_decode
from test_torch_sdr import jax_host_sdr, rgba_diff
import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

Image = pytest.importorskip("PIL.Image")


def smooth_plane(h, w, seed=0, lo=0, hi=255):
    """Band-limited content (tests/test_jpeg.py's)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(lo, hi, (h // 8 + 1, w // 8 + 1)).astype(np.float32)
    big = np.kron(small, np.ones((8, 8), np.float32))[:h, :w]
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) / 4.0
    return np.clip(big, 0, 255).astype(np.uint8)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def rgb(h, w, seeds):
    return np.dstack([smooth_plane(h, w, seed=s) for s in seeds])


def _grids(res):
    return [c[0] for c in res.comps]


def assert_as_jax(blob):
    """The port's grids and planes equal the JAX package's."""
    ours = codec.decode_jpeg_coefs(blob)
    theirs = jcodec.decode_jpeg_coefs(blob)
    assert len(ours.comps) == len(theirs.comps)
    for a, b in zip(ours.comps, theirs.comps):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    return ours


def planes_equal(a, b):
    assert a.sampling == b.sampling
    for pa, pb in zip(a.planes, b.planes):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


class TestProgressive:
    """Progressive (SOF2) decode: multi-scan orchestration over the
    native per-scan decoders (jpeg/entropy.cpp uhdr_prog_*)."""

    def test_progressive_color(self):
        blob = pil_jpeg(rgb(64, 80, (1, 2, 3)), quality=92, progressive=True)
        dec = codec.decode_jpeg(blob, "cpu")
        want = np.asarray(Image.open(io.BytesIO(blob)).convert("YCbCr"))
        assert dec.ncomp == 3 and dec.sampling[0] == (2, 2)
        assert psnr(dec.planes[0].numpy(), want[:, :, 0]) > 45
        assert_as_jax(blob)

    def test_progressive_gray(self):
        y = smooth_plane(56, 72, seed=4)
        blob = pil_jpeg(y, quality=90, progressive=True)
        dec = codec.decode_jpeg(blob, "cpu")
        want = np.asarray(Image.open(io.BytesIO(blob)).convert("L"))
        assert psnr(dec.planes[0].numpy(), want) > 49
        assert_as_jax(blob)

    def test_progressive_with_restarts(self):
        blob = pil_jpeg(rgb(48, 48, (5, 6, 7)), quality=85,
                        progressive=True, restart_marker_blocks=2)
        assert b"\xff\xdd" in blob
        dec = codec.decode_jpeg(blob, "cpu")
        want = np.asarray(Image.open(io.BytesIO(blob)).convert("YCbCr"))
        assert psnr(dec.planes[0].numpy(), want[:, :, 0]) > 45
        assert_as_jax(blob)

    def test_progressive_matches_baseline_decode(self):
        img = rgb(64, 64, (8, 9, 10))
        d1 = codec.decode_jpeg(pil_jpeg(img, quality=92), "cpu")
        d2 = codec.decode_jpeg(pil_jpeg(img, quality=92, progressive=True),
                               "cpu")
        # same quantized coefficients -> identical planes
        planes_equal(d1, d2)


def build_multiscan(y, u, v, w, h, quality=90):
    """A 3-scan (Y)(Cb)(Cr) non-interleaved baseline JPEG of YUV420
    planes, written with the port's own markers, B2's plain version and
    the host Huffman coder (tests/test_jpeg.py's _build_multiscan)."""
    import torch

    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    out = bytearray(b"\xff\xd8")
    out += codec._jfif_app0()
    out += codec._marker(0xDB, codec._dqt(0, ql))
    out += codec._marker(0xDB, codec._dqt(1, qc))
    out += codec._marker(0xC0, codec._sof0(
        w, h, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]))
    luma = ((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
            (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS))
    chroma = ((tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
              (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
    for tid, (dct_, act_) in enumerate((luma, chroma)):
        out += codec._marker(0xC4, codec._dht(0, tid, *dct_))
        out += codec._marker(0xC4, codec._dht(1, tid, *act_))
    for plane, q, cid, tid, (dct_, act_) in (
            (y, ql, 1, 0, luma), (u, qc, 2, 1, chroma),
            (v, qc, 3, 1, chroma)):
        # Non-interleaved scan: the ceil(dim/8) block grid (B2 pads).
        zz = fdct_quant(torch.from_numpy(np.ascontiguousarray(plane))[None],
                        torch.from_numpy(q.reshape(64).astype(np.int32)))
        zz = zz[0].numpy()
        out += codec._marker(0xDA, bytes([1, cid, (tid << 4) | tid, 0, 63,
                                          0]))
        dc_tabs, ac_tabs = [None] * 4, [None] * 4
        dc_tabs[tid], ac_tabs[tid] = dct_, act_
        out += codec.entropy_encode(zz, np.zeros(zz.shape[0], np.uint8),
                                    [tid], [tid], dc_tabs, ac_tabs, 0, 1)
    out += b"\xff\xd9"
    return bytes(out)


class TestMultiScanBaseline:
    """Multi-scan baseline (several SOS under SOF0, T.81 A.2): decode
    must match the equivalent single-scan file."""

    @pytest.mark.parametrize("w,h", [(24, 20), (64, 48)])
    def test_multiscan_matches_single_scan(self, w, h):
        rng = np.random.default_rng(3)
        y = rng.integers(0, 255, (h, w), np.uint8)
        u = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
        v = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
        single = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=90,
                                   device="cpu")
        multi = build_multiscan(y, u, v, w, h)
        assert multi.count(b"\xff\xda") == 3
        assert dd.parse_device_stream(multi) is None
        got, ref = (codec.decode_jpeg(b, "cpu") for b in (multi, single))
        assert (got.width, got.height) == (ref.width, ref.height)
        planes_equal(got, ref)
        assert_as_jax(multi)
        planes_equal(got, jcodec.decode_jpeg(multi))


def test_progressive_fill_bytes_between_segments():
    """T.81 B.1.1.2 allows 0xFF fill bytes before any marker; the
    progressive scan walk must skip them like the baseline scanner."""
    blob = pil_jpeg(smooth_plane(48, 64, seed=77), progressive=True,
                    quality=90)
    ref = codec.decode_jpeg(blob, "cpu")
    sos = blob.find(b"\xff\xda")
    dht = blob.find(b"\xff\xc4", sos)
    assert dht > 0
    padded = blob[:dht] + b"\xff" + blob[dht:]
    planes_equal(codec.decode_jpeg(padded, "cpu"), ref)
    assert_as_jax(padded)


class TestThreadedProgressiveScans:
    """Cross-scan threading (codec._run_prog_tasks_threaded): the result
    is bitwise the serial decode's at any worker count."""

    @pytest.mark.parametrize("workers", [2, 4])
    def test_threaded_equals_serial(self, workers, monkeypatch):
        blob = pil_jpeg(rgb(96, 128, (11, 12, 13)), quality=92,
                        progressive=True)
        monkeypatch.setenv("UHDR_SCAN_THREADS", "1")
        serial = codec.decode_jpeg(blob, "cpu")
        monkeypatch.setenv("UHDR_SCAN_THREADS", str(workers))
        planes_equal(codec.decode_jpeg(blob, "cpu"), serial)

    def test_threaded_with_restarts_and_redefined_tables(self,
                                                         monkeypatch):
        blob = pil_jpeg(rgb(64, 64, (14, 15, 16)), quality=88,
                        progressive=True, restart_marker_blocks=2)
        monkeypatch.setenv("UHDR_SCAN_THREADS", "1")
        serial = codec.decode_jpeg(blob, "cpu")
        monkeypatch.setenv("UHDR_SCAN_THREADS", "4")
        planes_equal(codec.decode_jpeg(blob, "cpu"), serial)

    def test_threaded_truncated_scan_still_raises(self, monkeypatch):
        blob = bytearray(pil_jpeg(rgb(64, 64, (17, 18, 19)), quality=92,
                                  progressive=True))
        cut = len(blob) * 3 // 4
        bad = bytes(blob[:cut - 40] + blob[cut:])
        monkeypatch.setenv("UHDR_SCAN_THREADS", "4")
        with pytest.raises(UhdrError):
            codec.decode_jpeg(bad, "cpu")


# ---------------------------------------------------------------------------
# The native codec against its plain specification, jpeg/huffman.py
# (tests/test_huffman_fallback.py).
# ---------------------------------------------------------------------------

def _plain_progressive(monkeypatch):
    """huffman.py's progressive scan decoders in place of the native
    ones (same signatures)."""
    for name in ("dc_first", "dc_refine", "ac_first", "ac_refine"):
        monkeypatch.setattr(codec, f"_prog_{name}",
                            getattr(huffman, f"prog_{name}"))


def _yuv_planes(seed=0, w=48, h=40):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 64, (h // 8, w // 8)).astype(np.uint8)
         .repeat(8, 0).repeat(8, 1) + rng.integers(0, 32, (h, w)))
    return {"y": y.astype(np.uint8),
            "u": rng.integers(96, 160, (h // 2, w // 2), np.uint8),
            "v": rng.integers(96, 160, (h // 2, w // 2), np.uint8)}


@pytest.mark.parametrize("restart", [0, 2])
def test_huffman_encode_matches_plain(restart):
    blob = codec.encode_jpeg(_yuv_planes(), quality=90, device="cpu",
                             restart_interval=restart)
    res = codec.decode_jpeg_coefs(blob)
    (yg, *_), (ug, *_), (vg, *_) = res.comps
    mx, my = ug.shape[1], ug.shape[0]
    blocks, comp_ids = codec._interleave_ycbcr(yg, ug, vg, mx, my, 2, 2)
    args = (comp_ids, [0, 1, 1], [0, 1, 1],
            [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
             (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS), None, None],
            [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
             (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS), None, None],
            restart, 6)
    native = codec.entropy_encode(blocks, *args)
    assert native == huffman.huff_encode(blocks.astype(np.int64), *args)
    assert native == blob[blob.index(b"\xff\xda") + 14:-2]
    decoded = huffman.huff_decode(native, blocks.shape[0], *args)
    np.testing.assert_array_equal(decoded, blocks)
    np.testing.assert_array_equal(
        codec.entropy_decode(native, blocks.shape[0], *args), decoded)


@pytest.mark.parametrize("kw", [
    dict(quality=90, subsampling=2), dict(quality=80, subsampling=0),
    dict(quality=85, subsampling=2, restart_marker_blocks=3)],
    ids=["420", "444", "420-restarts"])
def test_progressive_decode_matches_plain(kw, monkeypatch):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (40, 56, 3), np.uint8)
    blob = pil_jpeg(img, progressive=True, **kw)
    native = _grids(codec.decode_jpeg_coefs(blob))
    _plain_progressive(monkeypatch)
    for threads in ("1", "4"):
        monkeypatch.setenv("UHDR_SCAN_THREADS", threads)
        for a, b in zip(_grids(codec.decode_jpeg_coefs(blob)), native):
            np.testing.assert_array_equal(a, b)


def test_gray_progressive_plain_roundtrip(monkeypatch):
    g = smooth_plane(24, 24, seed=3)
    blob = pil_jpeg(g, quality=95, progressive=True)
    native = codec.decode_jpeg(blob, "cpu")
    _plain_progressive(monkeypatch)
    dec = codec.decode_jpeg(blob, "cpu")
    planes_equal(dec, native)
    assert dec.planes[0].shape == (24, 24)
    assert np.abs(dec.planes[0].numpy().astype(int) - g).mean() < 16


# ---------------------------------------------------------------------------
# The port against the JAX package.
# ---------------------------------------------------------------------------

PROG_FILES = {
    "420": lambda: pil_jpeg(rgb(72, 88, (21, 22, 23)), quality=90,
                            progressive=True),
    "444": lambda: pil_jpeg(rgb(40, 56, (24, 25, 26)), quality=80,
                            progressive=True, subsampling=0),
    "422-odd": lambda: pil_jpeg(rgb(37, 51, (27, 28, 29)), quality=85,
                                progressive=True, subsampling=1),
    "gray-restarts": lambda: pil_jpeg(smooth_plane(45, 61, seed=30),
                                      quality=88, progressive=True,
                                      restart_marker_blocks=1),
    "multiscan": lambda: build_multiscan(*(
        smooth_plane(h, w, seed=31 + i)
        for i, (h, w) in enumerate(((33, 47), (17, 24), (17, 24)))),
        47, 33),
}


@pytest.mark.parametrize("threads", ["1", None])
@pytest.mark.parametrize("kind", sorted(PROG_FILES))
def test_grids_identical_to_jax(kind, threads, monkeypatch):
    if threads is None:
        monkeypatch.delenv("UHDR_SCAN_THREADS", raising=False)
    else:
        monkeypatch.setenv("UHDR_SCAN_THREADS", threads)
    blob = PROG_FILES[kind]()
    assert dd.parse_device_stream(blob) is None
    assert_as_jax(blob)


def _prog_jpegr():
    """(port JPEG/R with a progressive primary, the JAX package's)."""
    from libultrahdr_dev_tpu.types import GainMapMetadata as JMeta

    h, w = 48, 64
    base = pil_jpeg(rgb(h, w, (41, 42, 43)), quality=90, progressive=True)
    gmap = codec.encode_jpeg({"y": smooth_plane(h // 4, w // 4, seed=44)},
                             85, device="cpu")
    kw = dict(max_content_boost=4.0, min_content_boost=1.0,
              hdr_capacity_max=4.0)
    return (JpegR("cpu").encode_api4(base, gmap, GainMapMetadata(**kw)),
            jjpegr.JpegR().encode_api4(base, gmap, JMeta(**kw)))


def test_jpegr_progressive_primary_through_api_as_jax():
    """A JPEG/R whose primary is progressive, decoded through the stable
    API (UhdrDecoder) to F16 within 1 ULP of the JAX package's host
    route and to SDR within 1 of its SDR decode."""
    tb, jb = _prog_jpegr()
    assert tb == jb
    dec = UhdrDecoder("cpu")
    dec.set_image(tb)
    got = dec.decode().planes["rgba"]
    want = jax_host_decode(tb, "hdr_linear")[0]
    d = channel_diff(got, want, "hdr_linear")
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
    dec = UhdrDecoder("cpu")
    dec.set_image(tb)
    dec.set_out_img_format(PixelFormat.RGBA8888)
    dec.set_out_color_transfer(ColorTransfer.SRGB)
    d = rgba_diff(dec.decode().planes["rgba"], jax_host_sdr(jb))
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999


def test_api3_progressive_base_bytes_identical_to_jax():
    """API-3 with a camera's progressive SDR JPEG: the base is decoded on
    the host route (entropy.cpp's progressive scans, then B5)."""
    hdr = _hdr("BT2100", "HLG", seed=12)
    h, w = hdr["height"], hdr["width"]
    base = pil_jpeg(rgb(h, w, (45, 46, 47)), quality=88, progressive=True)
    jb = jjpegr.JpegR().encode_api3(jax_raw(hdr), base, JTransfer.HLG)
    tb = JpegR("cpu").encode_api3(port_raw(hdr), base, ColorTransfer.HLG)
    assert tb == jb
    assert JpegR("cpu").decode(tb, OutputFormat.SDR).image.planes[
        "rgba"].shape == (h, w)


@pytest.mark.parametrize("source,codec_,chain", [
    ("jpeg", "jpeg", "crop"), ("jpeg+p010", "jpeg_r", "none")])
def test_converter_progressive_jpeg_as_jax(source, codec_, chain):
    """The UltraHdr converter ingesting a progressive JPEG (decoded on the
    host route, then B5): its JPEG (edited) and its API-3 JPEG/R bytes
    identical to the JAX session's."""
    from libultrahdr_dev_tpu import ultrahdr as ju
    from libultrahdr_dev_tpu_torch import UltraHdr

    import test_torch_ultrahdr as tuhdr

    base = pil_jpeg(rgb(tuhdr.H, tuhdr.W, (51, 52, 53)), quality=90,
                    progressive=True)
    js, ts = ju.UltraHdr(), UltraHdr("cpu")
    js.add_image(base)
    ts.add_image(base)
    if "p010" in source:
        jr, tr = tuhdr._hdr(6)
        js.add_raw(jr)
        ts.add_raw(tr)
    jcfg, tcfg = tuhdr._configs(codec_, chain, quality=92)
    assert ts.convert(tcfg) == js.convert(jcfg)


def test_cli_api3_progressive_base_as_jax(tmp_path):
    """The command-line tool's API-3 encode (-p P010 -i base JPEG) from
    a progressive base: the port's file is the JAX tool's."""
    from libultrahdr_dev_tpu import cli as jcli
    from libultrahdr_dev_tpu_torch import cli as tcli, serving

    h, w = 48, 64
    y, uv = serving.synth_p010(1, h, w, seed=5)
    src, base = str(tmp_path / "in.p010"), str(tmp_path / "base.jpg")
    np.concatenate([y[0].ravel(), uv[0].ravel()]).tofile(src)
    open(base, "wb").write(pil_jpeg(rgb(h, w, (54, 55, 56)), quality=88,
                                    progressive=True))
    out = {}
    for tool, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--cpu"])):
        out[tool] = str(tmp_path / f"{tool}.jpg")
        assert main(["-m", "0", "-p", src, "-i", base, "-w", str(w), "-h",
                     str(h), "-C", "2", "-t", "1", "-z", out[tool]]
                    + extra) == 0
    got, want = (open(out[k], "rb").read() for k in ("port", "jax"))
    assert len(got) > 0 and got == want


def test_fixture_digest_as_jax(monkeypatch):
    """The committed 4000x3000 progressive fixture: the sidecar's digest
    is the JAX package's grids' (recomputed here), and the port's grids
    give it at 1 scan thread and at the default count."""
    data = open(prog_fixture.JPG, "rb").read()
    side = json.load(open(prog_fixture.SIDECAR))
    assert len(data) == side["bytes"] <= 1 << 20
    assert (side["width"], side["height"]) == (4000, 3000)
    assert data.count(b"\xff\xda") > 3 and b"\xff\xc2" in data
    digest, shapes = prog_fixture.jax_digest(data)
    assert (digest, shapes) == (side["sha256"], side["grids"])
    for threads in ("1", None):
        if threads is None:
            monkeypatch.delenv("UHDR_SCAN_THREADS", raising=False)
        else:
            monkeypatch.setenv("UHDR_SCAN_THREADS", threads)
        assert prog_fixture.grids_sha256(
            _grids(codec.decode_jpeg_coefs(data))) == side["sha256"]


def test_device_decoder_refuses_progressive():
    """SOF2 (and multi-scan) streams never reach B4: parse_device_stream
    returns None and decode_jpeg takes the host route."""
    blob = PROG_FILES["420"]()
    assert dd.parse_device_stream(blob) is None
    launches = dd.decode_stream_device.launches
    dec = codec.decode_jpeg(blob, "cpu")
    assert dd.decode_stream_device.launches == launches
    assert dec.sampling == [(2, 2), (1, 1), (1, 1)]


def test_missing_native_library_raises(monkeypatch):
    """No fallback: when jpeg/entropy.cpp cannot be loaded, the
    progressive decode raises and huffman.py never runs."""
    blob = PROG_FILES["444"]()

    def unavailable():
        raise RuntimeError("building entropy.cpp failed")

    calls = []
    monkeypatch.setattr(codec, "get_lib", unavailable)
    for name in ("prog_dc_first", "prog_dc_refine", "prog_ac_first",
                 "prog_ac_refine", "huff_decode"):
        real = getattr(huffman, name)
        monkeypatch.setattr(huffman, name,
                            lambda *a, _r=real, _n=name: calls.append(_n)
                            or _r(*a))
    for threads in ("1", "4"):
        monkeypatch.setenv("UHDR_SCAN_THREADS", threads)
        with pytest.raises(RuntimeError, match="entropy.cpp"):
            codec.decode_jpeg_coefs(blob)
    assert calls == []
