"""The port's one JPEG header reader (libultrahdr_dev_tpu_torch/jpeg/
headers.py read_headers) and every route that reads its record, held
against the JAX package over one corpus of JPEGs that the port writes
(at most 128x96): baseline 4:2:0 with and without restarts, gray, 4:2:2,
4:4:4, progressive (SOF2, written here from the port's Huffman
specification), arithmetic (SOF9), multi-scan baseline, two ICC chunks,
EXIF, a non-canonical DHT, a frame header cut short, a file cut short
and bitflipped copies. For each input: the metadata view
(parse_jpeg_info), the device decoder's route and stream
(parse_device_stream), the host decoder's grids (decode_jpeg_coefs) and
the JPEG/R split (extract_primary_and_gainmap) give the JAX package's
result or its error. And the walks: on the batched device route each
image's markers are walked once and its EOI searched once, its entropy
segment reaches the destuffing as a view into the blob, and no other
route splits a blob twice or reads an image's headers twice."""

import dataclasses

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.container import jfif as jjfif, mux as jmux
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.jpeg import device_decode as jdd
from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                       PixelFormat, RawImage, UhdrError)
from libultrahdr_dev_tpu_torch.container import jfif, mux
from libultrahdr_dev_tpu_torch.jpeg import codec, headers, huffman, tables
from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
from libultrahdr_dev_tpu_torch.jpeg.dct import fdct_quant
from libultrahdr_dev_tpu_torch.parallel import batched
from libultrahdr_dev_tpu_torch.ultrahdr import UltraHdr

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

W, H = 128, 96


def _plane(h, w, seed):
    """Smooth content with some noise, so every band has coefficients."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    p = 128 + 80 * np.sin(xx / 9.0 + seed) * np.cos(yy / 7.0)
    return np.clip(p + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _encode(sampling=(2, 2), **kw):
    hs, vs = sampling
    planes = {"y": _plane(H, W, 1), "u": _plane(H // vs, W // hs, 2),
              "v": _plane(H // vs, W // hs, 3)}
    return codec.encode_jpeg(planes, 90, sampling=sampling, device="cpu",
                             **kw)


def _gray(**kw):
    return codec.encode_jpeg({"y": _plane(H, W, 4)}, 90, device="cpu", **kw)


_segment = codec._marker


def _after_soi(jpeg, *segments):
    return jpeg[:2] + b"".join(segments) + jpeg[2:]


def _zz(plane, q):
    z = fdct_quant(torch.from_numpy(np.ascontiguousarray(plane))[None],
                   torch.from_numpy(q.reshape(64).astype(np.int32)))
    return z[0].numpy().astype(np.int64)


def _progressive_gray():
    """SOF2 gray: a DC scan, then AC bands 1-5 and 6-63, each block's
    band run/size coded and ended by EOB0 (the Annex K tables), written
    with huffman.py's bit writer."""
    q = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 90)
    zz = _zz(_plane(H, W, 5), q)
    dc = huffman._build_codes(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)
    ac = huffman._build_codes(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)

    def put(bw, codes, sym, v, s):
        bw.put(*codes[sym])
        bw.put(v if v >= 0 else v + (1 << s) - 1, s)

    def scan(ss, se):
        bw = huffman._BitWriter()
        pred = 0
        for blk in zz:
            if ss == 0:
                s = huffman._csize(blk[0] - pred)
                put(bw, dc, s, int(blk[0] - pred), s)
                pred = blk[0]
                continue
            run = 0
            for v in blk[ss:se + 1]:
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bw.put(*ac[0xF0])
                    run -= 16
                s = huffman._csize(v)
                put(bw, ac, (run << 4) | s, int(v), s)
                run = 0
            if run:
                bw.put(*ac[0x00])
        bw.flush()
        return _segment(0xDA, bytes([1, 1, 0, ss, se, 0])) + bytes(bw.out)

    out = b"\xff\xd8" + _segment(0xDB, codec._dqt(0, q))
    out += _segment(0xC2, codec._sof0(W, H, [(1, 1, 1, 0)]))
    out += _segment(0xC4, codec._dht(0, 0, tables.DC_LUMA_BITS,
                                     tables.DC_LUMA_VALS))
    out += _segment(0xC4, codec._dht(1, 0, tables.AC_LUMA_BITS,
                                     tables.AC_LUMA_VALS))
    return out + scan(0, 0) + scan(1, 5) + scan(6, 63) + b"\xff\xd9"


def _multiscan():
    """SOF0 4:2:0 in three scans, (Y), (Cb), (Cr)."""
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 90)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, 90)
    out = b"\xff\xd8" + _segment(0xDB, codec._dqt(0, ql))
    out += _segment(0xDB, codec._dqt(1, qc))
    out += _segment(0xC0, codec._sof0(
        W, H, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]))
    specs = (((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
              (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)),
             ((tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
              (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)))
    for tid, (d, a) in enumerate(specs):
        out += _segment(0xC4, codec._dht(0, tid, *d))
        out += _segment(0xC4, codec._dht(1, tid, *a))
    for cid, (plane, q, tid) in enumerate(
            ((_plane(H, W, 6), ql, 0), (_plane(H // 2, W // 2, 7), qc, 1),
             (_plane(H // 2, W // 2, 8), qc, 1)), 1):
        zz = _zz(plane, q).astype(np.int16)
        tabs = [[None] * 4, [None] * 4]
        tabs[0][tid], tabs[1][tid] = specs[tid]
        out += _segment(0xDA, bytes([1, cid, tid * 17, 0, 63, 0]))
        out += codec.entropy_encode(zz, np.zeros(len(zz), np.uint8), [tid],
                                    [tid], *tabs, 0, 1)
    return out + b"\xff\xd9"


def _short_sof(jpeg):
    """The frame header's component list cut to 2 of its 3 bytes."""
    i = jpeg.find(b"\xff\xc0")
    n = int.from_bytes(jpeg[i + 2:i + 4], "big")
    return jpeg[:i] + _segment(0xC0, jpeg[i + 4:i + 12]) + jpeg[i + 2 + n:]


def _bitflips(jpeg, seed, stop=None):
    """1-3 bits flipped in jpeg[2:stop]."""
    rng = np.random.default_rng(seed)
    out = bytearray(jpeg)
    for pos in rng.integers(2, stop or len(out), int(rng.integers(1, 4))):
        out[pos] ^= 1 << int(rng.integers(0, 8))
    return bytes(out)


ICC = headers.ICC_SIG
EXIF = headers.EXIF_SIG + b"MM\x00\x2a\x00\x00\x00\x08\x00\x00"
NON_CANONICAL = _segment(0xC4, bytes([0x12]) + bytes([3] + [0] * 15)
                         + bytes([0, 1, 2]))
TOO_MANY_CODES = _segment(0xC4, bytes([0x13]) + bytes([0] * 8 + [255] * 8))
SHORT_DQT = _segment(0xDB, bytes([0x05]) + bytes(10))


def _corpus():
    rst = _encode(restart_interval=4)
    return {
        "420": _encode(),
        "420_rst": rst,
        "gray": _gray(),
        "422": _encode((2, 1)),
        "444": _encode((1, 1)),
        "progressive": _progressive_gray(),
        "sof9": _gray(arithmetic=True),
        "multiscan": _multiscan(),
        "two_icc": _after_soi(rst, _segment(0xE2, ICC + b"\x01\x02" + b"a"
                                            * 40),
                              _segment(0xE2, ICC + b"\x02\x02" + b"b" * 9)),
        "exif": _after_soi(rst, _segment(0xE1, EXIF)),
        "non_canonical_dht": _after_soi(rst, NON_CANONICAL),
        "too_many_codes": _after_soi(rst, TOO_MANY_CODES),
        "short_dqt": _after_soi(rst, SHORT_DQT),
        "short_sof": _short_sof(rst),
        "cut": rst[:len(rst) * 3 // 5],
        **{f"bitflips_{s}": _bitflips(rst, s) for s in range(4)},
        **{f"header_bitflips_{s}": _bitflips(
            rst, s, headers.read_headers(rst).sos_end) for s in range(8)},
    }


CORPUS = _corpus()


def _value(x):
    """Comparable form: dataclasses, slotted objects, arrays, lists."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_value(v) for v in x)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if dataclasses.is_dataclass(x):
        return tuple(_value(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    return x


def _outcome(fn, *args, fields=None):
    try:
        r = fn(*args)
    except Exception as e:  # noqa: BLE001  (the error is the result)
        return type(e).__name__, getattr(e, "code", None)
    if r is None or fields is None:
        return "ok", _value(r)
    return "ok", tuple(_value(getattr(r, f)) for f in fields)


INFO = ("width", "height", "num_components", "exif", "exif_offset", "xmp",
        "icc")
STREAM = ("width", "height", "gray", "restart_interval", "dest",
          "starts_byte", "win_len", "qtables", "mcus_x", "mcus_y",
          "start_bits", "sampling")


def _coefs(fn, data):
    r = fn(data)
    return (r.width, r.height, r.ncomp, _value(r.comps), r.icc, r.exif,
            r.xmp)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_routes_as_jax(name):
    data = CORPUS[name]
    got = (_outcome(jfif.parse_jpeg_info, data, fields=INFO),
           _outcome(dd.parse_device_stream, data, fields=STREAM),
           _outcome(_coefs, codec.decode_jpeg_coefs, data))
    want = (_outcome(jjfif.parse_jpeg_info, data, fields=INFO),
            _outcome(jdd.parse_device_stream, data, fields=STREAM),
            _outcome(_coefs, jcodec.decode_jpeg_coefs, data))
    assert got == want
    segs = [(s.marker, s.offset, bytes(s.payload))
            for s in jjfif.parse_jpeg_info(data).segments] \
        if got[0][0] == "ok" else None
    if segs is not None:
        assert [(s.marker, s.offset, bytes(s.payload)) for s in
                jfif.parse_jpeg_info(data).segments] == segs


EXPECTED_ROUTE = {"420": "device", "420_rst": "device", "gray": "device",
                  "422": "device", "444": "device", "progressive": "host",
                  "sof9": "host", "multiscan": "host", "two_icc": "device",
                  "exif": "device", "non_canonical_dht": "device",
                  "short_sof": "none", "too_many_codes": "none",
                  "cut": "host"}


@pytest.mark.parametrize("name", sorted(EXPECTED_ROUTE))
def test_corpus_reaches_each_route(name):
    """The corpus does what its names say: the device decoder takes the
    baseline files (a non-canonical table it never selects included),
    the host decoder the rest, and it raises for the frame header cut
    short and the bad tables."""
    data = CORPUS[name]
    on_device = dd.parse_device_stream(data) is not None
    assert on_device == (EXPECTED_ROUTE[name] == "device")
    if name in ("short_sof", "non_canonical_dht", "too_many_codes"):
        with pytest.raises(UhdrError, match="SOF|DHT code counts"):
            codec.decode_jpeg_coefs(data)
    elif name != "cut":
        assert codec.decode_jpeg_coefs(data).ncomp in (1, 3)


def test_record_fields():
    """The record of the two-ICC file: offsets, tables, frame, scan and
    both ICC forms."""
    data = CORPUS["two_icc"]
    hdr = headers.read_headers(data)
    assert hdr.start == 0 and hdr.end == len(data)
    assert hdr.eoi == len(data) - 2 and data[hdr.eoi:] == b"\xff\xd9"
    assert bytes(hdr.entropy) == data[hdr.sos_end:hdr.eoi]
    assert sorted(hdr.qtables) == [0, 1]
    assert [sorted(t) for t in hdr.huffman] == [[0, 1], [0, 1]]
    f, = hdr.frames
    assert (f.marker, f.width, f.height, f.ncomp) == (0xC0, W, H, 3)
    assert (hdr.width, hdr.height, hdr.num_components) == (W, H, 3)
    assert [c[:3] for c in f.comps] == [(1, 2, 2), (2, 1, 1), (3, 1, 1)]
    assert hdr.restart_interval == 4 and len(hdr.scan) == 3
    assert hdr.icc_chunk.endswith(b"a" * 40)
    assert hdr.icc == hdr.icc_chunk + b"b" * 9
    assert hdr.faults == []
    kinds = [f.kind for f in headers.read_headers(
        CORPUS["non_canonical_dht"]).faults]
    assert kinds == ["dht"]


def _raw(seed):
    rng = np.random.default_rng(seed)
    y = (rng.integers(64, 940, (H, W)).astype(np.uint16)) << 6
    uv = (rng.integers(64, 960, (H // 2, W)).astype(np.uint16)) << 6
    return RawImage(fmt=PixelFormat.P010, width=W, height=H,
                    gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                    planes={"y": y, "uv": uv})


JPEGR = JpegR("cpu").encode_api0(_raw(0), ColorTransfer.HLG)
BLOBS = {"jpegr": JPEGR, "trailing": JPEGR + b"\x00\xff\xd9junk",
         "one_image": CORPUS["420_rst"], "cut": JPEGR[:len(JPEGR) - 40],
         **{f"bitflips_{s}": _bitflips(JPEGR, 100 + s) for s in range(4)}}


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_split_as_jax(name):
    blob = BLOBS[name]
    assert _outcome(mux.extract_primary_and_gainmap, blob) == _outcome(
        jmux.extract_primary_and_gainmap, blob)
    assert jfif.find_image_ranges(blob) == jjfif.find_image_ranges(blob)
    assert mux.is_uhdr_image(blob) == jmux.is_uhdr_image(blob)


class _Count:
    """Counts the calls of headers.walk_segments and find_eoi_marker."""

    def __init__(self, monkeypatch):
        self.walks = self.searches = 0
        walk, search = headers.walk_segments, headers.find_eoi_marker

        def counted_walk(*a):
            self.walks += 1
            return walk(*a)

        def counted_search(*a):
            self.searches += 1
            return search(*a)

        monkeypatch.setattr(headers, "walk_segments", counted_walk)
        monkeypatch.setattr(headers, "find_eoi_marker", counted_search)


def test_device_route_walks_each_image_once(monkeypatch):
    blobs = [JpegR("cpu").encode_api0(_raw(s), ColorTransfer.HLG)
             for s in (1, 2)]
    seen = []
    destuff = dd.destuff_device_stream

    def spy(hdr):
        seen.append(hdr.entropy)
        return destuff(hdr)

    monkeypatch.setattr(dd, "destuff_device_stream", spy)
    count = _Count(monkeypatch)
    frames = batched.decode_host_stage(blobs, "hdr_hlg")
    assert all(f.streams is not None for f in frames)
    assert (count.walks, count.searches) == (4, 4)
    assert len(seen) == 4
    for k, ent in enumerate(seen):
        assert isinstance(ent, memoryview) and ent.obj is blobs[k // 2]


def _arith_jpegr():
    base = codec.encode_jpeg({"y": _plane(H, W, 1), "u": _plane(
        H // 2, W // 2, 2), "v": _plane(H // 2, W // 2, 3)}, 90,
        arithmetic=True, device="cpu")
    _, gmap = mux.extract_primary_and_gainmap(JPEGR)
    return mux.append_gainmap(base, gmap, batched.api0_metadata("hlg"))


ONE_READ = {
    "host_route": (lambda b: batched.decode_host_stage([b], "hdr_hlg"), 2),
    "decode_jpeg": (lambda b: codec.decode_jpeg(
        mux.extract_primary_and_gainmap(b)[0], "cpu"), 3),
    "get_info": (lambda b: JpegR("cpu").get_info(b), 2),
    "is_uhdr_image": (mux.is_uhdr_image, 2),
    "add_image": (lambda b: UltraHdr("cpu").add_image(b), 2),
}


@pytest.mark.parametrize("name", sorted(ONE_READ))
def test_each_route_reads_each_image_once(name, monkeypatch):
    """Walks of each route: the split's one of each image and no more
    (decode_jpeg: the split's two, then its own JPEG's one, for its
    route and its decode)."""
    blob = _arith_jpegr() if name == "host_route" else JPEGR
    fn, walks = ONE_READ[name]
    count = _Count(monkeypatch)
    fn(blob)
    assert (count.walks, count.searches) == (walks, walks)
