"""One reader of JPEG headers: ``read_headers`` walks an image's marker
segments once, SOI through first SOS, finds the EOI that ends that scan
and reads each segment with the one reader of its kind. It decides
nothing for a route: what a strict reader refuses goes to ``faults``, in
file order, and each route applies its own rule to the record
(device_decode.parse_device_headers, codec.decode_jpeg_coefs,
container/jfif.py parse_jpeg_info). The JPEG/R split hands its records
on, so no route walks an image twice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..types import err
from . import tables
from .native import get_lib

SOI, EOI, SOS, DQT, DHT, DRI, APP1, APP2 = (0xD8, 0xD9, 0xDA, 0xDB, 0xC4,
                                             0xDD, 0xE1, 0xE2)
EXIF_SIG = b"Exif\x00\x00"
XMP_SIG = b"http://ns.adobe.com/xap/1.0/\x00"
ICC_SIG = b"ICC_PROFILE\x00"
SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {DHT, 0xC8, 0xCC}
# Frame types the host decoder reads: SOF0-2, SOF9-10.
HOST_FRAMES = (0xC0, 0xC1, 0xC2, 0xC9, 0xCA)
STANDALONE = frozenset(range(0xD0, 0xD8)) | {0x01, SOI, EOI}  # RSTn, TEM


class JpegSegment(NamedTuple):
    marker: int
    offset: int          # of the 0xFF byte, from the image's SOI
    payload: bytes       # segment body without the 2-byte length


class Frame(NamedTuple):
    """A SOFn segment; components (id, h, v, quant table). Size and
    count are None below 6 bytes, comps where the list is cut short."""
    marker: int
    width: int | None
    height: int | None
    ncomp: int | None
    comps: list | None


class Fault(NamedTuple):
    """What a strict reader refuses in a segment: kind "dqt" (a table
    cut short), "dht" (a bad class, slot or length; non-canonical
    counts), "dht_stop" (over 256 codes or values cut short, where a
    lenient reader stops too), "sof_short" or "sof_unsupported"."""
    kind: str
    marker: int
    error: Exception


@dataclass
class JpegHeaders:
    """One image's headers. Offsets count from its SOI, at `start` in
    `data`. Tables: the last definition of a slot wins. width, height,
    num_components, exif, exif_offset, xmp, icc (all chunks joined, as
    the reference's getICCPtr) and segments are the metadata the API
    reports (container/jfif.py parse_jpeg_info)."""

    data: object
    start: int
    sos_end: int      # past the first SOS (else past an EOI, or data end)
    eoi: int          # the FF D9 that ends the first scan; -1: none
    end: int          # past it in a JPEG/R; the data's end read alone
    segments: list
    qtables: dict = field(default_factory=dict)   # slot: (8, 8) natural
    huffman: tuple = field(default_factory=lambda: ({}, {}))  # DC, AC
    frames: list = field(default_factory=list)    # every SOFn, in order
    restart_interval: int = 0
    sos: bytes | None = None    # the first SOS's payload
    scan: list | None = None    # its (id, DC, AC) selectors; None: short
    exif: bytes | None = None
    exif_offset: int = -1       # of the EXIF payload
    xmp: bytes | None = None
    icc: bytes | None = None
    icc_chunk: bytes | None = None   # the first ICC chunk alone
    width: int = 0              # of the last frame header with a size
    height: int = 0
    num_components: int = 0
    faults: list = field(default_factory=list)

    @property
    def image(self) -> memoryview:
        """The image's bytes, a view into `data`."""
        return memoryview(self.data)[self.start:self.start + self.end]

    @property
    def entropy(self) -> memoryview:
        """The first scan's stuffed entropy segment, a view: from the
        end of SOS to the EOI (to the image's end without one)."""
        return self.image[self.sos_end:self.eoi if self.eoi >= 0
                          else self.end]


def find_eoi_marker(data, start: int = 0) -> int:
    """data.find(b"\\xff\\xd9", start) for a `start` >= 0, on any buffer
    without a copy: one native pass (jpeg/entropy.cpp uhdr_find_eoi).
    After an SOS the first FF D9 is the scan's EOI, by the JPEG grammar
    (no FF in entropy-coded data is followed by D9 but a marker's)."""
    arr = np.frombuffer(data, np.uint8)  # held through the call
    return get_lib().uhdr_find_eoi(arr.ctypes.data, arr.size, start)


def read_segment(data, pos: int, n: int):
    """(marker, payload, next offset) of the marker whose FF is at `pos`
    of data[:n]; no payload for a fill byte or SOI, EOI, RSTn, TEM. The
    length field is the caller's to check. Raises UHDR_CODEC_ERROR where
    pos holds no FF or the length field is cut off."""
    if data[pos] != 0xFF:
        raise err("UHDR_CODEC_ERROR", f"marker sync lost at {pos}")
    marker = data[pos + 1]
    if marker == 0xFF or marker in STANDALONE:
        return marker, None, pos + (1 if marker == 0xFF else 2)
    if pos + 4 > n:
        raise err("UHDR_CODEC_ERROR", "truncated segment header")
    nxt = pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])
    return marker, data[pos + 4:nxt], nxt


def walk_segments(data, start: int = 0):
    """(segments, offset where the walk stopped) of the image whose SOI
    is at `start`, through its first SOS, an EOI or the data's end.
    Raises UHDR_CODEC_ERROR without an SOI there, on a marker out of
    sync or a segment running past the data."""
    n = len(data)
    if start + 2 > n or data[start] != 0xFF or data[start + 1] != SOI:
        raise err("UHDR_CODEC_ERROR", "no SOI at image start")
    segments = [JpegSegment(SOI, 0, b"")]
    pos = start + 2
    while pos + 2 <= n:
        marker, payload, nxt = read_segment(data, pos, n)
        if payload is not None and (nxt < pos + 4 or nxt > n):
            raise err("UHDR_CODEC_ERROR", "invalid segment length")
        if marker != 0xFF:
            segments.append(JpegSegment(marker, pos - start,
                                        b"" if payload is None else payload))
        pos = nxt
        if marker in (SOS, EOI):
            break
    return segments, pos


def read_dqt(p) -> list:
    """[(slot, natural-order (8, 8) int32 table)] of a DQT payload.
    Raises ValueError where a table is cut short."""
    out, pos = [], 0
    while pos < len(p):
        size = 64 if p[pos] >> 4 == 0 else 128
        zz = np.frombuffer(p[pos + 1:pos + 1 + size],
                           np.uint8 if size == 64 else ">u2")
        nat = np.zeros(64, np.int32)
        nat[tables.ZIGZAG] = zz
        out.append((p[pos] & 15, nat.reshape(8, 8)))
        pos += 1 + size
    return out


def read_dht(p):
    """A DHT payload: ([(class, slot, bits, vals)] as far as a lenient
    reader gets, the first error of a strict one or None, whether the
    lenient one stopped). Strict (the host decoder's native table
    builder trusts it): class <= 1, slot <= 3, no table cut short, <= 256
    codes, canonical counts. Lenient (the device's tables suit any DHT):
    each table of 17 bytes or more, to over 256 codes or values cut
    short."""
    out, error, stopped = [], None, False
    pos = 0
    while pos < len(p):
        tc, th = p[pos] >> 4, p[pos] & 15
        if pos + 17 > len(p) or tc > 1 or th > 3:
            error = error or err("UHDR_CODEC_ERROR", "bad DHT header")
            if pos + 17 > len(p):
                break
        bits = list(p[pos + 1:pos + 17])
        nvals = sum(bits)
        pos += 17
        if nvals > 256 or pos + nvals > len(p):
            error = error or err("UHDR_CODEC_ERROR", "bad DHT code counts")
            stopped = True
            break
        code = 0
        for length, count in enumerate(bits, 1):
            code += count
            if code > (1 << length):
                error = error or err("UHDR_CODEC_ERROR",
                                     "non-canonical DHT code counts")
            code <<= 1
        out.append((tc, th, bits, list(p[pos:pos + nvals])))
        pos += nvals
    return out, error, stopped


def read_sof(marker: int, p) -> Frame:
    if len(p) < 6:
        return Frame(marker, None, None, None, None)
    comps = None
    if len(p) >= 6 + p[5] * 3:
        comps = [(p[6 + i * 3], p[7 + i * 3] >> 4, p[7 + i * 3] & 15,
                  p[8 + i * 3]) for i in range(p[5])]
    return Frame(marker, (p[3] << 8) | p[4], (p[1] << 8) | p[2], p[5],
                 comps)


def read_app(hdr: JpegHeaders, seg: JpegSegment):
    """An APP1 or APP2 segment into `hdr`: the first EXIF, with the
    offset of its payload (JpegDecoderHelper::getEXIFPos), the first
    XMP, the ICC chunks (every one after the first without its
    identifier and two chunk bytes in `icc`)."""
    p = seg.payload
    if seg.marker == APP1:
        if p.startswith(EXIF_SIG) and hdr.exif is None:
            hdr.exif, hdr.exif_offset = p, seg.offset + 4
        elif p.startswith(XMP_SIG) and hdr.xmp is None:
            hdr.xmp = p
    elif p.startswith(ICC_SIG):
        if hdr.icc is None:
            hdr.icc = hdr.icc_chunk = p
        else:
            hdr.icc = b"".join((hdr.icc, p[len(ICC_SIG) + 2:]))


def read_headers(data, start: int = 0) -> JpegHeaders:
    """The headers of the image whose SOI is at `start` of `data` (any
    buffer), read once. Raises UHDR_CODEC_ERROR where the walk fails."""
    segments, stop = walk_segments(data, start)
    eoi = find_eoi_marker(data, stop)
    hdr = JpegHeaders(data, start, stop - start,
                      eoi - start if eoi >= 0 else -1, len(data) - start,
                      segments)
    for seg in segments:
        m, p = seg.marker, seg.payload
        if m == DQT:
            try:
                hdr.qtables.update(read_dqt(p))
            except ValueError as e:
                hdr.faults.append(Fault("dqt", m, e))
        elif m == DHT:
            tabs, error, stopped = read_dht(p)
            for tc, th, bits, vals in tabs:
                if tc <= 1:  # no rule reads another class
                    hdr.huffman[tc][th] = (bits, vals)
            if error is not None:
                hdr.faults.append(Fault("dht_stop" if stopped else "dht", m,
                                        error))
        elif m in SOF_MARKERS:
            f = read_sof(m, p)
            hdr.frames.append(f)
            if f.width is not None:
                hdr.width, hdr.height, hdr.num_components = f[1:4]
            if m not in HOST_FRAMES:
                hdr.faults.append(Fault("sof_unsupported", m, err(
                    "UHDR_CODEC_UNSUPPORTED_FEATURE",
                    f"SOF marker {m:#x} not supported")))
            elif f.comps is None:
                hdr.faults.append(Fault("sof_short", m, err(
                    "UHDR_CODEC_ERROR", "truncated SOF header")))
        elif m == DRI:
            hdr.restart_interval = int.from_bytes(p[:2], "big")
        elif m == SOS:
            hdr.sos = p
            if p and len(p) >= 1 + p[0] * 2:
                hdr.scan = [(p[1 + i * 2], p[2 + i * 2] >> 4,
                             p[2 + i * 2] & 15) for i in range(p[0])]
        elif m in (APP1, APP2):
            read_app(hdr, seg)
    return hdr


def of(data) -> JpegHeaders:
    """`data` when it is a JpegHeaders already, else read_headers(data)."""
    return data if isinstance(data, JpegHeaders) else read_headers(data)
