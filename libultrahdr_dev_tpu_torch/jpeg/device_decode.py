"""Parallel restart-interval Huffman decode on the device: kernels B4
and B22.

The port of libultrahdr_dev_tpu/jpeg/device_decode.py. Streams this
codec writes carry a restart marker every few MCUs, so each interval
(a "lane") decodes on its own; a restart-less baseline stream is cut
into lanes by a lengths-only host scan (``scan_foreign_stream``) that
records each lane's start bit, and the lanes' DC sums are carried
across them after the decode (``dc_carry``).

Host side: ``parse_device_stream`` applies the device decoder's rule to
an image's headers (jpeg/headers.py read_headers; the rule is
``parse_device_headers``), destuffs the entropy segment and finds the
lane starts (``destuff_device_stream``); ``pack_streams`` lays one or
more parsed streams out as the kernel's inputs (one byte buffer plus
small int32 descriptor arrays), so a batch goes to the device in one
copy. Device side: ``decode_rst_chunks`` decodes every lane of the
batch in one call and writes the coefficients straight into the
per-plane zigzag grids that B5 reads; the MCU de-interleave (the JAX
deinterleave_yuv420_device) is index arithmetic inside it.

Emission, as JAX's ``emit_mode``: "dense" (B4, the default) keeps each
lane's current block and writes it out whole; "log" (B22, JAX's
body_log) appends only the coefficients a lane emits to a compact
(zigzag index, value) log, notes where each block's entries start, and
rebuilds the dense grids from it in a second, parallel pass. The two
give the same grids bit for bit on any input. The default is read from
``UHDR_DECODE_EMIT`` at import; any value but "log" means dense. JAX's
``UHDR_DECODE_UNITS`` (units decoded per loop step) has no counterpart:
the port decodes one unit a step, and the result does not depend on
it.

Huffman tables are data: each frame's decode tables are built from its
own DHT definitions, so frames that differ in Huffman or quant tables
share one launch. Every table of a ``pack_streams`` call is built in
one native pass (``build_tables``: jpeg/entropy.cpp uhdr_decode_tables,
span "decode.tables", counter "decode_table_sets"; ``decode_tables`` is
the same call for one stream, ``decode_tables_plain`` its Python
model), with no state kept between calls. A table is the JAX select
chain's sorted (boundary, symbol << 5 | length) entries; a unit decodes
to the last entry whose boundary is <= the next 16 stream bits, which
equals the chain for any DHT, canonical or not. The kernels stage a
frame's tables in shared memory with a 9-bit fast table
(``fast_lookup_table`` is its plain model): a prefix whose lowest and
highest peeks find one entry maps to it, any other goes to the binary
search, so the two agree on every peek. Each lane reads its window
through a register bit buffer refilled by aligned 4-byte loads, bytes
outside the window read as zero; ``pack_streams`` pads the buffer so no
such load leaves it. The JAX path's TPU workarounds (select-chain
reads, the nibble window table, units per step) have no counterpart
here.

The wrapper runs its plain PyTorch version for CPU tensors and the CUDA
kernels (kernels/csrc/huff_decode.cu: a CTA per 64 lanes of one frame;
the DC carry as a per-frame scan of the lanes' DC sums and an add pass
of a thread per block) for CUDA tensors, and counts B4's launches in
``.launches`` and B22's in ``.log_launches``. The kernels'
handoff mode is the same launch over the encoder's own chunk buffer (B3
writes JPEG byte order, so its word-aligned chunks are read in place;
parallel/batched.py). ``decode_jpeg_device`` decodes a plain JPEG
(gray, 4:2:0, 4:2:2 or 4:4:4, with restarts or without) to planes as
B4 (or B22) then B5: the device route of jpeg/codec.py:decode_jpeg.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import upload
from ..kernels import build
from ..types import UhdrError
from ..utils import counters
from ..utils.profiler import span
from . import headers, tables
from .device_entropy import _build_code_table
from .native import get_lib

# Emission of the decode (default; an explicit emit_mode wins): "log"
# runs B22, anything else B4. Read once, at import, as in JAX.
_DEFAULT_EMIT = os.environ.get("UHDR_DECODE_EMIT", "dense")

# ---------------------------------------------------------------------------
# Decode tables.
# ---------------------------------------------------------------------------

TABLE_WORDS = 1 + 2 * 256   # [entry count, boundaries[256], packed[256]]


def _chain_consts(bits, vals):
    """Per-symbol (boundary, packed) arrays, ascending by boundary:
    boundary = the symbol's code left-aligned to 16 bits, packed =
    (symbol << 5) | code length. The next 16 stream bits decode to the
    LAST entry whose boundary is <= them (canonical codes partition the
    code space in ascending order)."""
    code, size = _build_code_table(bits, vals)
    entries = sorted((int(code[s]) << (16 - int(size[s])),
                      (s << 5) | int(size[s]))
                     for s in range(256) if size[s])
    return (np.asarray([e[0] for e in entries], np.int64),
            np.asarray([e[1] for e in entries], np.int64))


def _four(specs):
    """[DC luma, AC luma, DC chroma, AC chroma] of a stream's specs; a
    gray stream's None chroma pair repeats the luma one."""
    dc_l, ac_l, dc_c, ac_c = specs
    return dc_l, ac_l, dc_c or dc_l, ac_c or ac_l


def decode_tables_plain(specs) -> np.ndarray:
    """The Python model of decode_tables: the same (4, TABLE_WORDS)
    int32 tables, one _chain_consts a table. No route calls it."""
    out = np.zeros((4, TABLE_WORDS), np.int32)
    for i, spec in enumerate(_four(specs)):
        bnd, pck = _chain_consts(*spec)
        out[i, 0] = len(bnd)
        out[i, 1:1 + len(bnd)] = bnd
        out[i, 257:257 + len(pck)] = pck
    return out


def build_tables(spec_sets) -> np.ndarray:
    """(n, 4, TABLE_WORDS) int32 decode tables of n streams' specs (each
    as decode_tables takes them; bits and vals sequences of ints 0-255)
    in one native pass (jpeg/entropy.cpp uhdr_decode_tables), byte for
    byte decode_tables_plain's for any DHT headers.read_dht passes, in
    span "decode.tables"; counts the n sets in "decode_table_sets"."""
    with span("decode.tables"):
        flat = [spec for specs in spec_sets for spec in _four(specs)]
        bits = b"".join([bytes(b) for b, _ in flat])
        vals = b"".join([bytes(v).ljust(256, b"\0") for _, v in flat])
        if len(bits) != 16 * len(flat) or len(vals) != 256 * len(flat):
            raise ValueError("a DHT has 16 code counts and at most 256 "
                             "symbols")
        out = np.empty((len(spec_sets), 4, TABLE_WORDS), np.int32)
        if get_lib().uhdr_decode_tables(bits, vals, out.ctypes.data,
                                        len(flat)) < 0:
            raise ValueError("a DHT counts more than 256 codes")
    counters.bump("decode_table_sets", len(spec_sets))
    return out


def decode_tables(specs) -> np.ndarray:
    """(4, TABLE_WORDS) int32 decode tables of [DC luma, AC luma,
    DC chroma, AC chroma] from (bits, vals) definitions; a gray stream
    passes None for the chroma pair, which then repeats the luma one.
    build_tables for one stream."""
    return build_tables([specs])[0]


FAST_BITS = 9                # the kernels' fast lookup: top 9 peek bits
FAST_SEARCH = 0xFFFF         # its marker: binary-search this peek


def _search(tab: np.ndarray, peeks: np.ndarray) -> np.ndarray:
    """The kernels' binary search: per peek, the index of the last
    entry whose boundary <= it (entries 1.. searched, 0 when none is)."""
    cnt = int(tab[0])
    idx = np.zeros(peeks.shape, np.int64)
    for step in (128, 64, 32, 16, 8, 4, 2, 1):
        j = idx + step
        ok = j < cnt
        bnd = tab[1 + np.minimum(j, 255)].astype(np.int64) & 0xFFFFFFFF
        idx = np.where(ok & (bnd <= peeks), j, idx)
    return idx


def fast_lookup_table(tabs) -> np.ndarray:
    """Plain model of the fast table each decode CTA builds in shared
    memory (kernels/csrc/huff_decode.cu stage_tables): for (T,
    TABLE_WORDS) decode tables, (T, 512) uint16, entry p the packed
    (symbol << 5 | length) that every peek with top 9 bits p decodes to
    when the search lands on one entry for the prefix's lowest and
    highest peeks (the search's index never falls as the peek rises, so
    then every peek of the prefix lands there), else FAST_SEARCH; also
    FAST_SEARCH for a packed entry of 16 bits or more (none from a
    DHT)."""
    tabs = np.asarray(tabs).reshape(-1, TABLE_WORDS)
    low = np.arange(1 << FAST_BITS, dtype=np.int64) << (16 - FAST_BITS)
    out = np.empty((tabs.shape[0], 1 << FAST_BITS), np.uint16)
    for t, tab in enumerate(tabs):
        a = _search(tab, low)
        b = _search(tab, low | ((1 << (16 - FAST_BITS)) - 1))
        pk = tab[257 + a].astype(np.int64) & 0xFFFFFFFF
        out[t] = np.where((a == b) & (pk < FAST_SEARCH), pk, FAST_SEARCH)
    return out


def min_code_bits(specs) -> int:
    """Shortest codeword length across the tables (2 for Annex K;
    optimized tables may carry 1-bit codes)."""
    m = 16
    for spec in specs:
        if spec is None:
            continue
        nz = [i for i, c in enumerate(spec[0], 1) if c]
        if nz:
            m = min(m, nz[0])
    return max(m, 1)


ANNEX_K_COLOR = ((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
                 (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
                 (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
                 (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
ANNEX_K_GRAY = ANNEX_K_COLOR[:2] + (None, None)


# ---------------------------------------------------------------------------
# Host prep: destuff and find lane starts.
# ---------------------------------------------------------------------------

_LEN_BUCKETS = (48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536,
                2048, 3072, 4096, 6144, 8192)


def bucket_len(n: int) -> int:
    """Window length of a lane holding n bytes: the JAX package buckets
    it for compile reuse, and the window bounds what a lane may read,
    so the port keeps the same buckets."""
    for b in _LEN_BUCKETS:
        if n <= b:
            return b
    return -(-n // 8192) * 8192


def split_rst_stream(entropy: bytes, n_chunks: int):
    """Destuff an entropy-coded segment with RSTn markers and find its
    intervals: (destuffed bytes, (n_chunks,) int32 start offsets,
    window length). One native pass (entropy.cpp uhdr_destuff_rst)
    drops each stuffed zero and each RSTn, keeps every other byte, and
    notes where each interval starts. Raises ValueError when the marker
    count is not n_chunks - 1."""
    arr = np.frombuffer(entropy, np.uint8)
    if arr.size == 0:
        raise ValueError("empty entropy segment")
    out = np.empty(arr.size, np.uint8)
    # starts[0] stays 0; the pass writes the RSTn offsets after it, and
    # never more than the buffer holds, whatever the segment carries.
    starts = np.zeros(n_chunks + 1, np.int64)
    n_rst = ctypes.c_long()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = get_lib().uhdr_destuff_rst(
        arr.ctypes.data_as(u8p), arr.size, out.ctypes.data_as(u8p),
        starts[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_chunks, ctypes.byref(n_rst))
    if n_rst.value + 1 != n_chunks:
        raise ValueError(f"expected {n_chunks} restart intervals, found "
                         f"{n_rst.value + 1}")
    starts[n_chunks] = n
    win = bucket_len(int(np.diff(starts).max()))
    if n + win >= 2**31:
        raise ValueError("entropy segment too large")
    return out[:n], starts[:n_chunks].astype(np.int32), win


def scan_foreign_stream(entropy: bytes, n_mcus: int, gray: bool, specs,
                        r_mcus: int, sampling=(2, 2)):
    """Lanes for a RESTART-LESS baseline stream: the native
    lengths-only scan (entropy.cpp uhdr_huff_scan_offsets) walks every
    codeword once and records the bit offset of each r_mcus-aligned MCU
    boundary. Returns (destuffed bytes, (nl,) int32 start bytes, (nl,)
    int32 start bits, window length), or None when the scan fails
    (corrupt stream, restart markers)."""
    lib = get_lib()

    def u8p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    dcb = np.zeros((4, 17), np.uint8)
    dcv = np.zeros((4, 256), np.uint8)
    acb = np.zeros((4, 17), np.uint8)
    acv = np.zeros((4, 256), np.uint8)
    dcb[0], dcv[0] = tables.pack_huff_table(*specs[0])
    acb[0], acv[0] = tables.pack_huff_table(*specs[1])
    if gray:
        pattern = np.zeros(1, np.uint8)
        sel = np.zeros(1, np.uint8)
    else:
        dcb[1], dcv[1] = tables.pack_huff_table(*specs[2])
        acb[1], acv[1] = tables.pack_huff_table(*specs[3])
        pattern = np.array([0] * (sampling[0] * sampling[1]) + [1, 2],
                           np.uint8)
        sel = np.array([0, 1, 1], np.uint8)
    data = np.frombuffer(entropy, np.uint8)
    dest = np.empty(data.size + 1024, np.uint8)
    n_segs = -(-n_mcus // r_mcus)
    offs = np.zeros(n_segs + 1, np.int64)
    rc = lib.uhdr_huff_scan_offsets(
        u8p(data), data.size, n_mcus, u8p(pattern), len(pattern),
        u8p(sel), u8p(sel), u8p(dcb.reshape(-1)), u8p(dcv.reshape(-1)),
        u8p(acb.reshape(-1)), u8p(acv.reshape(-1)), r_mcus, u8p(dest),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc <= 0:
        return None
    dlen = int(rc)
    offs = offs[:n_segs]
    ends = np.append(offs[1:], dlen * 8)
    starts_byte = offs // 8
    lens = (ends + 7) // 8 - starts_byte
    # +8: the lane may read a few bytes of lookahead past its last bit.
    win = bucket_len(int(lens.max()) + 8)
    if dlen + win >= 2**31:
        return None
    return (dest[:dlen].copy(), starts_byte.astype(np.int32),
            (offs % 8).astype(np.int32), win)


@dataclass
class DeviceStream:
    """Host-parsed description of a device-decodable baseline JPEG: the
    destuffed entropy bytes (`dest`), each lane's start byte and bit,
    the lane window length, and what the markers said. start_bits is
    None for real restart-interval streams; for restart-less ones it
    holds each synthesized lane's first bit, and the decode carries DC
    across lanes."""

    width: int
    height: int
    gray: bool
    restart_interval: int
    dest: np.ndarray
    starts_byte: np.ndarray
    win_len: int
    qtables: list
    specs: tuple
    mcus_x: int
    mcus_y: int
    start_bits: np.ndarray | None = None
    sampling: tuple = (2, 2)

    @property
    def n_lanes(self) -> int:
        return int(self.starts_byte.shape[0])


@dataclass
class StreamHeaders:
    """What the markers of a device-decodable JPEG say, and its
    entropy-coded segment as it stands in the file (still stuffed)."""

    width: int
    height: int
    gray: bool
    restart_interval: int
    qtables: list
    specs: tuple
    mcus_x: int
    mcus_y: int
    sampling: tuple
    entropy: memoryview


def parse_device_stream(data) -> DeviceStream | None:
    """A JPEG (bytes, or its JpegHeaders) as a DeviceStream when its
    headers and entropy segment suit the device decoder (baseline, one
    scan, 4:2:0, 4:2:2 or 4:4:4 YCbCr with U and V sharing tables, or
    grayscale); None otherwise, and the caller decodes on the host."""
    try:
        hdr = headers.of(data)
    except UhdrError:
        return None
    sh = parse_device_headers(hdr)
    return None if sh is None else destuff_device_stream(sh)


def parse_device_headers(hdr: headers.JpegHeaders) -> StreamHeaders | None:
    """The device decoder's rule on an image's headers (parse_device_
    stream's up to the entropy segment): its stream headers, else None.
    In file order, a DQT cut short raises; a DHT stopping a lenient
    reader, or a baseline frame header cut short, refuses. Non-canonical
    DHTs are taken: the decode tables suit any DHT."""
    for f in hdr.faults:
        if f.kind == "dqt":
            raise f.error
        if f.kind == "dht_stop" or (f.kind == "sof_short"
                                    and f.marker in (0xC0, 0xC1)):
            return None
    if hdr.sos is not None and not hdr.sos:
        raise IndexError("SOS segment without a component count")
    frames = [f for f in hdr.frames if f.marker in (0xC0, 0xC1)]
    if (hdr.sos is None or not frames or not frames[-1].comps
            or any(f.marker == 0xC2 for f in hdr.frames)):
        return None
    _, w, h, _, comps = frames[-1]
    if w == 0 or h == 0:
        return None
    if len(comps) == 1:
        gray, (hs, vs) = True, (1, 1)
        if comps[0][1:3] != (1, 1):
            return None
        mcus_x, mcus_y = -(-w // 8), -(-h // 8)
    elif len(comps) == 3:
        gray = False
        samp = [c[1:3] for c in comps]
        if samp[1:] != [(1, 1), (1, 1)]:
            return None
        hs, vs = samp[0]
        if (hs, vs) not in ((2, 2), (2, 1), (1, 1)):
            return None
        mcus_x, mcus_y = -(-w // (8 * hs)), -(-h // (8 * vs))
    else:
        return None
    if any(c[3] not in hdr.qtables for c in comps):
        return None
    scan_sel = {cid: (dc, ac) for cid, dc, ac in hdr.scan or ()}
    try:
        sel = [scan_sel[c[0]] for c in comps]
    except KeyError:
        return None
    if not gray and sel[1] != sel[2]:
        return None
    dc, ac = hdr.huffman
    specs = (dc.get(sel[0][0]), ac.get(sel[0][1]),
             *((None, None) if gray else (dc.get(sel[1][0]),
                                          ac.get(sel[1][1]))))
    if specs[0] is None or specs[1] is None or (
            not gray and (specs[2] is None or specs[3] is None)):
        return None
    # A zero-codeword table decodes nothing; the host decoder raises
    # its proper error for it.
    if any(s is not None and sum(s[0]) == 0 for s in specs):
        return None
    return StreamHeaders(
        width=w, height=h, gray=gray, restart_interval=hdr.restart_interval,
        qtables=[hdr.qtables[c[3]] for c in comps], specs=specs,
        mcus_x=mcus_x, mcus_y=mcus_y, sampling=(hs, vs),
        entropy=hdr.entropy)


def destuff_device_stream(hdr: StreamHeaders) -> DeviceStream | None:
    """The rest of parse_device_stream: destuff the entropy segment and
    find its lanes (split_rst_stream, or scan_foreign_stream for a
    restart-less stream); None where that fails."""
    entropy, restart, gray = hdr.entropy, hdr.restart_interval, hdr.gray
    n_mcus = hdr.mcus_x * hdr.mcus_y
    start_bits = None
    if restart > 0:
        try:
            dest, starts_byte, win_len = split_rst_stream(
                entropy, -(-n_mcus // restart))
        except ValueError:
            return None
    else:
        # Restart-less: one lane per `restart` MCUs, sized for about the
        # lane count of this codec's own restart intervals.
        restart = max(1, -(-n_mcus // 12288))
        scanned = scan_foreign_stream(entropy, n_mcus, gray, hdr.specs,
                                      restart, sampling=hdr.sampling)
        if scanned is None:
            return None
        dest, starts_byte, start_bits, win_len = scanned
    return DeviceStream(
        width=hdr.width, height=hdr.height, gray=gray,
        restart_interval=restart, dest=dest, starts_byte=starts_byte,
        win_len=win_len, qtables=hdr.qtables, specs=hdr.specs,
        mcus_x=hdr.mcus_x, mcus_y=hdr.mcus_y, start_bits=start_bits,
        sampling=hdr.sampling)


# ---------------------------------------------------------------------------
# Kernel inputs.
# ---------------------------------------------------------------------------

# Per-frame descriptor fields (int32).
F_OFF, F_LEN, F_WIN, F_R, F_LANE0, F_NLANES, F_CARRY, F_MAXU = range(8)
FRAME_FIELDS = 8


@dataclass
class Lanes:
    """Host arrays of one B4 launch over a batch of same-geometry
    streams: `src` the streams' bytes back to back; `frames` (n,
    FRAME_FIELDS) int32 per-frame descriptors (byte offset and length
    of the stream in src, lane window length, MCUs per lane, first lane
    and lane count, DC carry flag, unit cap); `lanes` (nl, 2) int32
    (start byte within the stream, start bit); `tables` (n, 4,
    TABLE_WORDS) int32 per-frame decode tables."""

    src: np.ndarray
    frames: np.ndarray
    lanes: np.ndarray
    tables: np.ndarray
    gray: bool
    sampling: tuple
    mcus_x: int
    mcus_y: int


def frame_row(off: int, length: int, win: int, r: int, lane0: int,
              nl: int, carry: bool, mcb: int) -> list[int]:
    """One frame's descriptor. A lane decodes at most win*8 // mcb + 1
    units: each unit costs at least mcb bits, so with a true mcb the
    lane has passed its window's end by then (the JAX loop's step cap,
    which never binds on a correct min_code_bits)."""
    if off + length + win >= 2**31:
        raise ValueError("stream exceeds the int32 index range")
    return [off, length, win, r, lane0, nl, int(carry),
            win * 8 // mcb + 1]


def pack_streams(streams: list[DeviceStream]) -> Lanes:
    """Lay parsed streams of one geometry out for one B4 launch. `src`
    ends in zero bytes up to a multiple of 16 and 16 more, so that no
    aligned load of the kernels' bit reader leaves it (the descriptors'
    stream lengths, not the padding, bound what a lane reads). Every
    stream's decode tables come from one build_tables call."""
    s0 = streams[0]
    geom = (s0.gray, s0.sampling, s0.mcus_x, s0.mcus_y)
    rows, lanes, srcs = [], [], []
    off = lane0 = 0
    for s in streams:
        if (s.gray, s.sampling, s.mcus_x, s.mcus_y) != geom:
            raise ValueError("a B4 launch needs streams of one geometry")
        carry = s.start_bits is not None
        rows.append(frame_row(off, s.dest.size, s.win_len,
                              s.restart_interval, lane0, s.n_lanes, carry,
                              min_code_bits(s.specs)))
        lanes.append(np.stack([
            s.starts_byte, s.start_bits if carry
            else np.zeros(s.n_lanes, np.int32)], axis=1))
        srcs.append(s.dest)
        off += s.dest.size
        lane0 += s.n_lanes
    srcs.append(np.zeros(-off % 16 + 16, np.uint8))
    return Lanes(np.concatenate(srcs), np.asarray(rows, np.int32),
                 np.concatenate(lanes).astype(np.int32),
                 build_tables([s.specs for s in streams]), *geom)


def plane_shapes(gray: bool, sampling, mcus_x: int, mcus_y: int):
    """Block-grid dims (bh, bw) of each output plane."""
    if gray:
        return [(mcus_y, mcus_x)]
    hs, vs = sampling
    return [(mcus_y * vs, mcus_x * hs), (mcus_y, mcus_x), (mcus_y, mcus_x)]


# ---------------------------------------------------------------------------
# Plain version.
# ---------------------------------------------------------------------------

def _wrap32(x):
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _wrap16(x):
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def _lut(tabs: torch.Tensor) -> torch.Tensor:
    """(T, 65536) int64: the packed entry each 16-bit peek decodes to
    in each table (the last entry whose boundary <= peek, else the
    first)."""
    peeks = torch.arange(65536, dtype=torch.int64, device=tabs.device)
    out = []
    for t in tabs.reshape(-1, TABLE_WORDS).to(torch.int64):
        n = int(t[0])
        i = torch.searchsorted(t[1:1 + n].contiguous(), peeks, right=True)
        out.append(t[257:257 + n][torch.clamp(i - 1, min=0)])
    return torch.stack(out)


def _log_caps(cb, maxu):
    """B22's per-lane unit cap and log width, as JAX sizes them with one
    unit a step: a lane reaches its target within cb*65 units on any
    input (a DC unit, then AC units that each raise k or end the block),
    so the step cap is min(bit cap, cb*65 + 2), and the log holds the
    step cap + 1 units, rounded up to a power of two (at least 32).
    Neither cap binds before the lane's own termination."""
    cap = torch.minimum(maxu, cb * 65 + 3)
    width = 1 << max(5, (int(cap.max()) - 1).bit_length())
    return cap, width


def decode_rst_chunks_plain(src, frames, lanes, tabs, gray: bool,
                            sampling, mcus_x: int, mcus_y: int,
                            emit_mode: str | None = None):
    """Decode every lane of a packed batch (see Lanes) -> the per-plane
    int16 zigzag grids, each (n, bh*bw, 64): (y, u, v), or (g,) for
    gray. Per lane, one unit (a codeword and its extra bits) at a time,
    as the JAX decode_rst_chunks: a unit is decoded and emitted, then
    the lane is done once its block count reaches its target or its bit
    position passes its window. Coefficients never emitted are 0.

    emit_mode "log" (None: the module's _DEFAULT_EMIT) is B22's plain
    version in JAX's formulation: each unit appends the key dest*2 + 1
    to its lane's int32 key row when it emits and repeats the lane's
    last key when it does not, beside an int16 value row; the grid is
    then rebuilt per output column by a lower bound of c*2 + 1 in the
    lane's monotone key row. Any other value is B4's dense emission."""
    log_emit = (emit_mode or _DEFAULT_EMIT) == "log"
    dev = src.device
    n = frames.shape[0]
    nl = lanes.shape[0]
    hs, vs = (1, 1) if gray else sampling
    ypm = hs * vs
    bpm = 1 if gray else ypm + 2
    n_mcus = mcus_x * mcus_y
    fr = frames.to(torch.int64)
    lane_f = torch.repeat_interleave(torch.arange(n, device=dev),
                                     fr[:, F_NLANES])
    f = fr[lane_f]
    idx = torch.arange(nl, device=dev) - f[:, F_LANE0]
    r = f[:, F_R]
    cb = bpm * r
    target = torch.where(idx < f[:, F_NLANES] - 1, cb,
                         bpm * (n_mcus - r * (f[:, F_NLANES] - 1)))
    win = f[:, F_WIN]
    max_bits = win * 8
    start = lanes[:, 0].to(torch.int64)
    base = f[:, F_OFF] + start
    avail = torch.minimum(win, f[:, F_LEN] - start)
    srcp = torch.cat([src.to(torch.int64),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    lut = _lut(tabs)
    tset = lane_f * 4

    bit = lanes[:, 1].to(torch.int64)
    blk = torch.zeros(nl, dtype=torch.int64, device=dev)
    k = torch.zeros_like(blk)
    units = torch.zeros_like(blk)
    dcp = torch.zeros((nl, 3), dtype=torch.int64, device=dev)
    done = torch.zeros(nl, dtype=torch.bool, device=dev)
    cbmax = int(cb.max())
    rows = torch.arange(nl, device=dev)
    if log_emit:
        max_units, log_cap = _log_caps(cb, f[:, F_MAXU])
        keys = torch.full((nl, log_cap), 2**31 - 1, dtype=torch.int32,
                          device=dev)
        vals = torch.zeros((nl, log_cap), dtype=torch.int16, device=dev)
        lastk = torch.zeros(nl, dtype=torch.int32, device=dev)
    else:
        max_units = f[:, F_MAXU]
        out = torch.zeros((nl, cbmax * 64), dtype=torch.int64, device=dev)
    while not bool(done.all()):
        live = ~done
        byte = bit >> 3
        w40 = torch.zeros_like(bit)
        for i in range(5):
            j = byte + i
            ok = (j < avail) & live
            w40 = (w40 << 8) | torch.where(
                ok, srcp[torch.where(ok, base + j, -1)], 0)
        wv = (w40 >> (8 - (bit & 7))) & 0xFFFFFFFF
        slot = blk % bpm
        luma = torch.ones_like(done) if gray else slot < ypm
        is_dc = k == 0
        t = tset + torch.where(is_dc, 0, 1) + torch.where(luma, 0, 2)
        pk = lut[t, wv >> 16]
        sym, clen = pk >> 5, pk & 31
        nextra = torch.where(is_dc, sym, sym & 15)
        extra = torch.where(
            nextra > 0, ((wv << clen) & 0xFFFFFFFF)
            >> ((32 - nextra) & 31), 0)
        half = torch.where(nextra > 0, _wrap32(
            1 << torch.clamp(nextra - 1, 0, 31)), 1)
        full = _wrap32((1 << torch.clamp(nextra, 0, 31)) - 1)
        e = _wrap32(extra)
        val = torch.where(nextra > 0,
                          torch.where(e < half, _wrap32(e - full), e), 0)
        comp = (torch.zeros_like(blk) if gray
                else torch.where(slot < ypm, 0, slot - (ypm - 1)))
        new_dc = _wrap32(dcp[rows, comp] + val)
        is_eob, is_zrl = sym == 0, sym == 0xF0
        kk = torch.clamp(k + (sym >> 4), max=63)
        emit = live & (is_dc | ~(is_eob | is_zrl))
        dest = blk * 64 + torch.where(is_dc, 0, kk)
        value = _wrap16(torch.where(is_dc, new_dc, val))
        if log_emit:
            lastk = torch.where(emit, (dest * 2 + 1).to(torch.int32), lastk)
            keys[rows[live], units[live]] = lastk[live]
            vals[rows[emit], units[emit]] = value[emit].to(torch.int16)
        else:
            out[rows[emit], dest[emit]] = value[emit]
        ends = is_eob | (kk >= 63)
        blk_n = torch.where(is_dc, blk, torch.where(ends, blk + 1, blk))
        k_n = torch.where(is_dc, 1, torch.where(
            ends, 0, torch.where(is_zrl, k + 16, kk + 1)))
        upd = live & is_dc
        dcp[rows[upd], comp[upd]] = new_dc[upd]
        bit = torch.where(live, bit + clen + nextra, bit)
        blk = torch.where(live, blk_n, blk)
        k = torch.where(live, k_n, k)
        units = units + live.to(torch.int64)
        done = done | (blk >= target) | (bit > max_bits) | (
            units >= max_units)

    if log_emit:
        # Dense rebuild: the first key >= c*2 + 1 in the lane's row is
        # c's emission when it equals it; otherwise c was never emitted.
        targ = (torch.arange(cbmax * 64, dtype=torch.int32, device=dev)
                * 2 + 1).expand(nl, cbmax * 64).contiguous()
        pos = torch.searchsorted(keys, targ).clamp_(max=log_cap - 1)
        out = torch.where(torch.gather(keys, 1, pos) == targ,
                          torch.gather(vals, 1, pos).to(torch.int64), 0)
    out = out.reshape(nl, cbmax, 64)
    # DC carry for restart-less streams: each lane's DC sums (its
    # final predictors) summed over the frame's earlier lanes.
    carry_lane = f[:, F_CARRY] > 0
    if bool(carry_lane.any()):
        csum = torch.cumsum(dcp, 0) - dcp
        first = csum[f[:, F_LANE0]]
        carry = _wrap32(csum - first)
        pattern = (torch.zeros(cbmax, dtype=torch.int64, device=dev) if gray
                   else torch.tensor([0] * ypm + [1, 2], device=dev).repeat(
                       -(-cbmax // bpm))[:cbmax])
        add = torch.gather(carry, 1, pattern[None, :].expand(nl, cbmax))
        out[..., 0] = torch.where(carry_lane[:, None],
                                  _wrap16(out[..., 0] + _wrap16(add)),
                                  out[..., 0])

    # De-interleave: lane block b -> MCU idx*r + b // bpm, slot b % bpm.
    b = torch.arange(cbmax, device=dev)[None, :]
    m = idx[:, None] * r[:, None] + b // bpm
    ok = (b < cb[:, None]) & (m < n_mcus)
    slot = (b % bpm).expand(nl, cbmax)
    fr_b = lane_f[:, None].expand(nl, cbmax)
    grids = []
    for p, (bh, bw) in enumerate(plane_shapes(gray, sampling, mcus_x,
                                              mcus_y)):
        g = torch.zeros((n, bh * bw, 64), dtype=torch.int16, device=dev)
        if p == 0 and not gray:
            sel = ok & (slot < ypm)
            my, mx = m // mcus_x, m % mcus_x
            pos = ((my * vs + slot // hs) * bw + mx * hs + slot % hs)
        else:
            sel = ok & (slot == (0 if gray else ypm + p - 1))
            pos = m
        g[fr_b[sel], pos[sel]] = out[sel].to(torch.int16)
        grids.append(g)
    return tuple(grids)


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------

def decode_rst_chunks(src, frames, lanes, tabs, gray: bool, sampling,
                      mcus_x: int, mcus_y: int,
                      emit_mode: str | None = None):
    """B4 / B22 wrapper: the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors. Same signature and result as
    decode_rst_chunks_plain: src uint8, frames (n, FRAME_FIELDS), lanes
    (nl, 2) and tabs (n, 4, TABLE_WORDS) int32, all on one device.
    emit_mode "log" (None: the module's _DEFAULT_EMIT) launches B22 and
    counts it in ``.log_launches``; any other value launches B4 and
    counts it in ``.launches``."""
    if not src.is_cuda:
        return decode_rst_chunks_plain(src, frames, lanes, tabs, gray,
                                       sampling, mcus_x, mcus_y, emit_mode)
    if (emit_mode or _DEFAULT_EMIT) == "log":
        return _decode_rst_chunks_log(src, frames, lanes, tabs, gray,
                                     sampling, mcus_x, mcus_y)[0]
    grids, lookups, y, u, v, dcsum, args = _launch_args(
        src, frames, lanes, tabs, gray, sampling, mcus_x, mcus_y)
    decode_rst_chunks.launches += 1
    build.launch(src, "uhdr_huff_decode", src.data_ptr(), frames.data_ptr(),
                 lanes.data_ptr(), tabs.data_ptr(), lookups.data_ptr(),
                 y.data_ptr(), u.data_ptr(), v.data_ptr(), dcsum.data_ptr(),
                 *args)
    return tuple(grids)


def _launch_args(src, frames, lanes, tabs, gray, sampling, mcus_x,
                 mcus_y):
    """Checked inputs and fresh outputs of a B4 or B22 launch: the
    grids, the per-frame lookup-table scratch, the y, u, v pointers'
    tensors (gray: the one grid three times), the (nl, 3) DC-sum scratch
    and the integer arguments."""
    n, nl = frames.shape[0], lanes.shape[0]
    build.require(src, "src", torch.uint8)
    build.require(frames, "frames", torch.int32, (n, FRAME_FIELDS))
    build.require(lanes, "lanes", torch.int32, (nl, 2))
    build.require(tabs, "tabs", torch.int32, (n, 4, TABLE_WORDS))
    hs, vs = (1, 1) if gray else sampling
    dev = src.device
    grids = [torch.empty((n, bh * bw, 64), dtype=torch.int16, device=dev)
             for bh, bw in plane_shapes(gray, sampling, mcus_x, mcus_y)]
    y, u, v = grids if not gray else grids * 3
    dcsum = torch.empty((nl, 3), dtype=torch.int32, device=dev)
    lookups = torch.empty(n * build.host_call("uhdr_huff_lookup_bytes"),
                          dtype=torch.uint8, device=dev)
    return (grids, lookups, y, u, v, dcsum,
            (n, nl, int(gray), hs, vs, mcus_x, mcus_y))


def _decode_rst_chunks_log(src, frames, lanes, tabs, gray: bool, sampling,
                          mcus_x: int, mcus_y: int):
    """B22 on CUDA tensors: (the grids, the (nl,) int32 count of
    coefficients each lane emitted). Pass 1 decodes each lane into its
    segment of a log sized for every coefficient of the batch (n *
    blocks * 64 int32 entries, zigzag index << 16 | value) and writes
    each block's first log index (n * blocks int32); pass 2 rebuilds the
    grids from them. Counts ``decode_rst_chunks.log_launches``; raises
    on a build or launch failure."""
    grids, lookups, y, u, v, dcsum, args = _launch_args(
        src, frames, lanes, tabs, gray, sampling, mcus_x, mcus_y)
    blocks = sum(g.shape[0] * g.shape[1] for g in grids)
    dev = src.device
    ent = torch.empty(blocks * 64, dtype=torch.int32, device=dev)
    start = torch.empty(blocks, dtype=torch.int32, device=dev)
    cnt = torch.empty(lanes.shape[0], dtype=torch.int32, device=dev)
    decode_rst_chunks.log_launches += 1
    build.launch(src, "uhdr_huff_decode_log", src.data_ptr(),
                 frames.data_ptr(), lanes.data_ptr(), tabs.data_ptr(),
                 lookups.data_ptr(), ent.data_ptr(), start.data_ptr(),
                 cnt.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(),
                 dcsum.data_ptr(), *args)
    return tuple(grids), cnt


decode_rst_chunks.launches = 0
decode_rst_chunks.log_launches = 0


# ---------------------------------------------------------------------------
# Plain-JPEG decode on the device (B12's decode half).
# ---------------------------------------------------------------------------

def decode_stream_device(ds: DeviceStream, device) -> list:
    """Decode a parsed stream on `device`: one upload of its destuffed
    bytes, lane and decode tables and its per-component quant tables,
    then B4 or B22 (decode_rst_chunks) and B5 (dct.dequant_idct) per
    plane. Returns uint8 planes (1, bh*8, bw*8), uncropped: the gray
    plane, or Y, U, V. The port of libultrahdr_dev_tpu/jpeg/device_decode.py:
    _decode_to_planes_kernel, in the module's emission mode; counts its
    calls on a CUDA device, each one B4 (or B22) and B5 launches, in
    ``.launches``."""
    from .dct import dequant_idct

    ln = pack_streams([ds])
    q = np.stack([t.reshape(64) for t in ds.qtables]).astype(np.int32)
    src, frames, lanes, tabs, qd = upload(
        [ln.src, ln.frames, ln.lanes, ln.tables, q], device)
    if src.is_cuda:
        decode_stream_device.launches += 1
    grids = decode_rst_chunks(src, frames, lanes, tabs, ds.gray, ds.sampling,
                              ds.mcus_x, ds.mcus_y)
    shapes = plane_shapes(ds.gray, ds.sampling, ds.mcus_x, ds.mcus_y)
    return [dequant_idct(g, qd[k:k + 1], bh, bw)
            for k, (g, (bh, bw)) in enumerate(zip(grids, shapes))]


decode_stream_device.launches = 0


def decode_jpeg_device(data, device):
    """(DeviceStream, decode_stream_device's planes) of a JPEG (bytes,
    or its JpegHeaders) whose headers suit the device decoder, else None
    (the JAX device_decode.py:decode_jpeg_device)."""
    ds = parse_device_stream(data)
    if ds is None:
        return None
    return ds, decode_stream_device(ds, device)
