"""Arithmetic-coded JPEG entropy codec (ITU-T T.81 Annexes D/F/G).

The reference reaches arithmetic-coded JPEGs through libjpeg-turbo's
jdarith decoder (the wrapper, lib/src/jpegdecoderhelper.cpp:422, calls
the full jpeg_read_* API, so SOF9/SOF10 streams decode transparently
there). A copy of the JAX package's jpeg/arith.py for the port:

- The scan-level entry points (``decode_seq_scan``, ``encode_seq_scan``,
  ``prog_dc_first``, ``prog_dc_refine``, ``prog_ac_first``,
  ``prog_ac_refine``) run the native QM codec, jpeg/arith.cpp
  (jpeg/native.py:get_arith), on the host, decoding into the same zigzag
  coefficient grids the Huffman path produces, so B5's dequant/IDCT on
  the device is shared. If the library cannot be built the first call
  raises: there is no fallback.
- The pure-Python QM coder below (``Decoder``, ``Encoder``, the DC/AC
  statistical models, ``_resync``) and the ``*_plain`` scan loops are
  the plain specification the native codec is held to bit for bit in
  tests/test_torch_arith.py. No encode or decode path calls them.

All constants below are ITU-T T.81 spec values (Table D.3 probability
estimation state machine; section F.1.4.4.1.2 conditioning bounds) —
the same tables any conforming codec carries.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .native import get_arith

# ITU-T T.81 Table D.3 — Qe value and probability estimation state
# machine: (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS). Index 113
# is the fixed (non-adapting) equiprobable state used for AC sign
# decisions (F.1.4.3.1).
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080B, 4, 18, 0), (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0),
    (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 16, 36, 0), (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0),
    (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0CEF, 21, 43, 0),
    (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01B1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0),
    (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0),
    (0x2EF1, 40, 67, 0), (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0),
    (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0),
    (0x04DE, 52, 50, 0), (0x040F, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0), (0x01F8, 57, 54, 0),
    (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0),
    (0x008F, 32, 61, 0), (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0),
    (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0), (0x2FE8, 69, 83, 0),
    (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119C, 76, 74, 0), (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0),
    (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0),
    (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0),
    (0x3C3D, 100, 104, 0), (0x375E, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0), (0x415E, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
)

FIXED_STATE = 113            # equiprobable, non-adapting (AC signs)
DC_STAT_BINS = 64            # 5 contexts x 4 + X1..X15 + M bins
AC_STAT_BINS = 256           # 63 x (SE,S0,X1) + two category banks

# Default conditioning when no DAC marker appears (T.81 F.1.4.4.1.2 /
# F.1.4.3.1): DC (L, U) = (0, 1); AC Kx = 5.
DEFAULT_DC_COND = (0, 1)
DEFAULT_AC_COND = 5


class ArithError(ValueError):
    """Raised on malformed arithmetic-coded streams; jpeg/codec.py maps
    it to UHDR_CODEC_ERROR as the Huffman decoders' errors are."""


# ---------------------------------------------------------------------------
# QM decoder (T.81 D.2). Register convention: `a` is the current
# interval (renormalized into [0x8000, 0x10000)); `c` holds the code
# window with `ct` fed-but-unconsumed low bits, so the 16-bit compare
# window is c >> ct. The byte feed collapses FF00 stuffing to a data
# FF and switches to an endless zero feed when a marker is reached
# (D.2.7) — exactly how a conforming decoder coasts to the end of a
# terminated scan.
# ---------------------------------------------------------------------------

class Decoder:
    __slots__ = ("data", "pos", "end", "a", "c", "ct", "marker")

    def __init__(self, data, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end
        self.marker = None
        self.a = 0x10000
        self.c = (self._byte() << 8) | self._byte()
        self.ct = 0

    def _byte(self) -> int:
        if self.marker is not None:
            return 0
        pos, data, end = self.pos, self.data, self.end
        if pos >= end:
            self.marker = 0xD9
            return 0
        b = data[pos]
        pos += 1
        if b != 0xFF:
            self.pos = pos
            return b
        # FF: collapse fill bytes, then stuffing zero vs marker
        while pos < end and data[pos] == 0xFF:
            pos += 1
        if pos < end and data[pos] == 0x00:
            self.pos = pos + 1
            return 0xFF
        self.marker = data[pos] if pos < end else 0xD9
        self.pos = pos          # left AT the marker code byte
        return 0

    def decode(self, stats: bytearray, i: int) -> int:
        st = stats[i]
        mps = st >> 7
        qe, nmps, nlps, sw = QE_TABLE[st & 0x7F]
        a = self.a - qe
        if self.c < (a << self.ct):
            if a >= 0x8000:
                self.a = a
                return mps
            # bottom subinterval with renorm: conditional exchange
            if a < qe:
                d = mps ^ 1
                if sw:
                    mps ^= 1
                stats[i] = (mps << 7) | nlps
            else:
                d = mps
                stats[i] = (mps << 7) | nmps
        else:
            self.c -= a << self.ct
            if a < qe:
                d = mps
                stats[i] = (mps << 7) | nmps
            else:
                d = mps ^ 1
                if sw:
                    mps ^= 1
                stats[i] = (mps << 7) | nlps
            a = qe
        while a < 0x8000:
            if self.ct == 0:
                self.c = (self.c << 8) | self._byte()
                self.ct = 8
            a <<= 1
            self.ct -= 1
        self.a = a
        return d


# ---------------------------------------------------------------------------
# QM encoder (T.81 D.1): byte output with carry propagation over
# stacked FF bytes and 0x00 stuffing after emitted FFs (D.1.6).
# ---------------------------------------------------------------------------

class Encoder:
    __slots__ = ("a", "c", "ct", "buffer", "sc", "out")

    def __init__(self):
        self.a = 0x10000
        self.c = 0
        self.ct = 11
        self.buffer = -1     # pending byte (carry target); -1 = none
        self.sc = 0          # count of stacked 0xFF bytes
        self.out = bytearray()

    def encode(self, stats: bytearray, i: int, bit: int):
        st = stats[i]
        mps = st >> 7
        qe, nmps, nlps, sw = QE_TABLE[st & 0x7F]
        a = self.a - qe
        if bit == mps:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:       # conditional exchange: MPS takes the top
                self.c += a
                a = qe
            stats[i] = (mps << 7) | nmps
        else:
            if a >= qe:      # LPS takes the top subinterval
                self.c += a
                a = qe
            if sw:
                mps ^= 1
            stats[i] = (mps << 7) | nlps
        while True:
            a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
            if a >= 0x8000:
                break
        self.a = a

    def _byte_out(self):
        temp = self.c >> 19
        if temp > 0xFF:
            # carry ripples into the pending byte; stacked FFs -> 00
            if self.buffer >= 0:
                self._emit(self.buffer + 1)
            while self.sc > 0:
                self._emit(0x00)
                self.sc -= 1
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer >= 0:
                self._emit(self.buffer)
            while self.sc > 0:
                self._emit(0xFF)
                self.sc -= 1
            self.buffer = temp
        self.c &= 0x7FFFF
        self.ct = 8

    def _emit(self, b: int):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0x00)   # stuffing (B.1.1.5)

    def flush(self) -> bytes:
        """Terminate (D.1.8): pick the codestream value in the final
        interval with the most trailing zero bits, then drain."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit(self.buffer + 1)
            while self.sc > 0:
                self._emit(0x00)
                self.sc -= 1
        else:
            if self.buffer >= 0:
                self._emit(self.buffer)
            while self.sc > 0:
                self._emit(0xFF)
                self.sc -= 1
        self._emit((self.c >> 19) & 0xFF)
        self._emit((self.c >> 11) & 0xFF)
        # trailing zeros may be discarded (D.1.8 note); keep them —
        # any conforming decoder feeds zeros past the data anyway.
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Statistical models. Blocks are zigzag-ordered int16[64] rows, the
# same layout the Huffman path uses, so k indexes zigzag directly.
# ---------------------------------------------------------------------------


def _w16(v: int) -> int:
    """Truncate to int16 exactly like the C (JCOEF) cast in the
    reference's libjpeg — reachable only on corrupt streams, where
    jdarith stores the truncated garbage rather than failing."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _dc_decode(dec, stats, ctx, cond):
    """Decode one DC difference (F.2.4.1). `ctx` is the conditioning
    context base (0/4/8/12/16); returns (diff, new_ctx)."""
    low, up = cond
    if dec.decode(stats, ctx) == 0:
        return 0, 0
    sign = dec.decode(stats, ctx + 1)
    m = dec.decode(stats, ctx + 2 + sign)
    if m:
        st = 20                       # X1 (Table F.4)
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ArithError("DC magnitude overflow")
            st += 1
    else:
        st = ctx + 2 + sign
    if m < (1 << low) >> 1:
        new_ctx = 0
    elif m > (1 << up) >> 1:
        new_ctx = 12 + sign * 4
    else:
        new_ctx = 4 + sign * 4
    v = m
    st += 14                          # magnitude bits bin (F.2.4.1)
    mm = m
    while mm := mm >> 1:
        if dec.decode(stats, st):
            v |= mm
    v += 1
    return (-v if sign else v), new_ctx


def _dc_encode(enc, stats, ctx, cond, diff):
    low, up = cond
    if diff == 0:
        enc.encode(stats, ctx, 0)
        return 0
    enc.encode(stats, ctx, 1)
    sign = 1 if diff < 0 else 0
    enc.encode(stats, ctx + 1, sign)
    sz = (-diff if sign else diff) - 1
    if sz:
        enc.encode(stats, ctx + 2 + sign, 1)
        m = 1
        st = 20
        while sz >= (m << 1):
            enc.encode(stats, st, 1)
            m <<= 1
            if m == 0x8000:
                raise ArithError("DC diff out of range")
            st += 1
        enc.encode(stats, st, 0)
    else:
        enc.encode(stats, ctx + 2 + sign, 0)
        m = 0
        st = ctx + 2 + sign
    if m < (1 << low) >> 1:
        new_ctx = 0
    elif m > (1 << up) >> 1:
        new_ctx = 12 + sign * 4
    else:
        new_ctx = 4 + sign * 4
    st += 14
    mm = m
    while mm := mm >> 1:
        enc.encode(stats, st, 1 if sz & mm else 0)
    return new_ctx


def _ac_decode_block(dec, stats, fixed, kx, block, ss=1, se=63, al=0):
    """Decode AC coefficients k in [ss, se] of one block (F.2.4.2;
    with al != 0 this is the progressive AC-first model, G.2.3)."""
    k = ss
    while k <= se:
        if dec.decode(stats, 3 * (k - 1)):      # SE: end of block
            return
        while dec.decode(stats, 3 * (k - 1) + 1) == 0:
            k += 1
            if k > se:
                raise ArithError("AC zero run past Se")
        sign = dec.decode(fixed, 0)
        st = 3 * (k - 1) + 2
        m = dec.decode(stats, st)
        if m and dec.decode(stats, st):         # X2 shares X1's bin
            m = 2
            st = 189 if k <= kx else 217
            while dec.decode(stats, st):
                m <<= 1
                if m == 0x8000:
                    raise ArithError("AC magnitude overflow")
                st += 1
        v = m
        st += 14
        mm = m
        while mm := mm >> 1:
            if dec.decode(stats, st):
                v |= mm
        v += 1
        block[k] = _w16((-v if sign else v) << al)
        k += 1


def _pt(v, al):
    """Point transform (T.81 G.1.2.1): sign-magnitude shift, NOT an
    arithmetic shift — e.g. -1 >> 1 must give 0, not -1."""
    v = int(v)
    return -((-v) >> al) if v < 0 else v >> al


def _ac_encode_block(enc, stats, fixed, kx, block, ss=1, se=63, al=0):
    k = ss
    while True:
        nz = 0
        for j in range(k, se + 1):
            if _pt(block[j], al) if al else block[j]:
                nz = j
                break
        if nz == 0:
            if k <= se:
                enc.encode(stats, 3 * (k - 1), 1)   # EOB
            return
        enc.encode(stats, 3 * (k - 1), 0)
        for j in range(k, nz):
            enc.encode(stats, 3 * (j - 1) + 1, 0)
        enc.encode(stats, 3 * (nz - 1) + 1, 1)
        v = _pt(block[nz], al) if al else int(block[nz])
        sign = 1 if v < 0 else 0
        enc.encode(fixed, 0, sign)
        sz = (-v if sign else v) - 1
        st = 3 * (nz - 1) + 2
        if sz == 0:
            enc.encode(stats, st, 0)
            m = 0
        elif sz == 1:
            enc.encode(stats, st, 1)
            enc.encode(stats, st, 0)
            m = 1
        else:
            enc.encode(stats, st, 1)
            enc.encode(stats, st, 1)
            m = 2
            st = 189 if nz <= kx else 217
            while sz >= (m << 1):
                enc.encode(stats, st, 1)
                m <<= 1
                if m == 0x8000:
                    raise ArithError("AC coefficient out of range")
                st += 1
            enc.encode(stats, st, 0)
        st += 14
        mm = m
        while mm := mm >> 1:
            enc.encode(stats, st, 1 if sz & mm else 0)
        k = nz + 1
        if k > se:
            return


def _resync(dec):
    """Find the next restart marker from the decoder's position;
    returns (pos_after_marker, marker_index) (T.81 D.2.8: the decoder
    discards bytes up to the terminating marker). When the decoder
    already coasted into the marker, its pos sits AT the marker code
    byte; otherwise scan forward (data FFs are always followed by a
    stuffed 00, so FF Dn is unambiguous)."""
    if dec.marker is not None:
        if 0xD0 <= dec.marker <= 0xD7:
            return dec.pos + 1, dec.marker & 7
        raise ArithError(f"unexpected marker {dec.marker:#x} "
                         "in entropy data")
    data, pos, end = dec.data, dec.pos, dec.end
    while pos + 1 < end:
        if data[pos] == 0xFF and 0xD0 <= data[pos + 1] <= 0xD7:
            return pos + 2, data[pos + 1] & 7
        pos += 1
    raise ArithError("missing restart marker")


# ---------------------------------------------------------------------------
# Scan-level entry points, mirroring the Huffman path's interfaces: each
# runs the native codec (jpeg/arith.cpp) and mutates `blocks` in place.
# ---------------------------------------------------------------------------

_ERR_STREAM = -1000000001
_ERR_RESTART = -1000000002


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _cond_arrays(dc_sel, ac_sel, dc_cond, ac_cond):
    """Per-slot conditioning as uint8[4] arrays for the C ABI."""
    dc_low = np.zeros(4, np.uint8)
    dc_up = np.ones(4, np.uint8)
    ac_kx = np.full(4, DEFAULT_AC_COND, np.uint8)
    for s in set(int(x) for x in dc_sel):
        low, up = dc_cond.get(s, DEFAULT_DC_COND)
        dc_low[s & 3], dc_up[s & 3] = low, up
    for s in set(int(x) for x in ac_sel):
        ac_kx[s & 3] = ac_cond.get(s, DEFAULT_AC_COND)
    return dc_low, dc_up, ac_kx


def _raise_rc(rc):
    if rc == _ERR_RESTART:
        raise ArithError("restart marker missing or out of order")
    raise ArithError("malformed arithmetic-coded stream")


def _writeback(rc, out, blocks):
    if rc != 0:
        _raise_rc(rc)
    if out is not blocks:  # callers rely on in-place mutation
        blocks[...] = out


def decode_seq_scan(entropy, blocks, comp_ids, dc_sel, ac_sel,
                    dc_cond, ac_cond, restart, mcu_blocks):
    """Sequential full scan (DC+AC, Ss=0..63) into `blocks`
    ((nblocks, 64) int16, zigzag). comp_ids maps each block to its
    scan-component index; dc_sel/ac_sel map scan components to
    conditioning-table slots."""
    lib = get_arith()
    buf = np.frombuffer(entropy, np.uint8)
    cids = np.ascontiguousarray(comp_ids, np.uint8)
    dsel = np.asarray([s & 3 for s in dc_sel], np.uint8)
    asel = np.asarray([s & 3 for s in ac_sel], np.uint8)
    dc_low, dc_up, ac_kx = _cond_arrays(dc_sel, ac_sel, dc_cond, ac_cond)
    out = np.ascontiguousarray(blocks)
    rc = lib.uhdr_arith_decode_seq(
        _u8p(buf), len(buf), out.shape[0], _u8p(cids), len(dsel),
        _u8p(dsel), _u8p(asel), _u8p(dc_low), _u8p(dc_up), _u8p(ac_kx),
        restart, mcu_blocks, _i16p(out))
    _writeback(rc, out, blocks)
    return blocks


def encode_seq_scan(blocks, comp_ids, dc_sel, ac_sel, dc_cond,
                    ac_cond, restart, mcu_blocks) -> bytes:
    """Sequential arithmetic encode of zigzag blocks; emits restart
    markers every `restart` MCUs like the Huffman entropy_encode."""
    lib = get_arith()
    blk = np.ascontiguousarray(blocks, np.int16)
    cids = np.ascontiguousarray(comp_ids, np.uint8)
    dsel = np.asarray([s & 3 for s in dc_sel], np.uint8)
    asel = np.asarray([s & 3 for s in ac_sel], np.uint8)
    dc_low, dc_up, ac_kx = _cond_arrays(dc_sel, ac_sel, dc_cond, ac_cond)
    cap = blk.shape[0] * 64 * 6 + 65536
    out = np.empty(cap, np.uint8)
    n = lib.uhdr_arith_encode_seq(
        _i16p(blk), blk.shape[0], _u8p(cids), len(dsel), _u8p(dsel),
        _u8p(asel), _u8p(dc_low), _u8p(dc_up), _u8p(ac_kx), restart,
        mcu_blocks, _u8p(out), cap)
    if n < 0:
        raise ArithError("arithmetic encode overflow or coefficient "
                         "out of range")
    return out[:n].tobytes()


def prog_dc_first(entropy, blocks, comp_ids, dc_sel, dc_cond, al,
                  restart, mcu_blocks):
    """Progressive DC first scan (G.2.3: sequential DC model, result
    scaled by 2^Al)."""
    lib = get_arith()
    buf = np.frombuffer(entropy, np.uint8)
    cids = np.ascontiguousarray(comp_ids, np.uint8)
    dsel = np.asarray([s & 3 for s in dc_sel], np.uint8)
    dc_low, dc_up, _ = _cond_arrays(dc_sel, [], dc_cond, {})
    out = np.ascontiguousarray(blocks)
    rc = lib.uhdr_arith_prog_dc_first(
        _u8p(buf), len(buf), out.shape[0], _u8p(cids), len(dsel),
        _u8p(dsel), _u8p(dc_low), _u8p(dc_up), al, restart, mcu_blocks,
        _i16p(out))
    _writeback(rc, out, blocks)
    return 0


def prog_dc_refine(entropy, blocks, al, restart, mcu_blocks):
    """Progressive DC refinement: one fixed-probability bit per block
    (G.2.3 successive approximation)."""
    lib = get_arith()
    buf = np.frombuffer(entropy, np.uint8)
    out = np.ascontiguousarray(blocks)
    rc = lib.uhdr_arith_prog_dc_refine(
        _u8p(buf), len(buf), out.shape[0], al, restart, mcu_blocks,
        _i16p(out))
    _writeback(rc, out, blocks)
    return 0


def prog_ac_first(entropy, blocks, ac_cond_kx, ss, se, al, restart):
    """Progressive AC first scan over a single component's blocks."""
    lib = get_arith()
    buf = np.frombuffer(entropy, np.uint8)
    out = np.ascontiguousarray(blocks)
    rc = lib.uhdr_arith_prog_ac_first(
        _u8p(buf), len(buf), out.shape[0], int(ac_cond_kx), ss, se, al,
        restart, _i16p(out))
    _writeback(rc, out, blocks)
    return 0


def prog_ac_refine(entropy, blocks, ss, se, al, restart):
    """Progressive AC refinement (G.2.3 / the correction-bit model)."""
    lib = get_arith()
    buf = np.frombuffer(entropy, np.uint8)
    out = np.ascontiguousarray(blocks)
    rc = lib.uhdr_arith_prog_ac_refine(
        _u8p(buf), len(buf), out.shape[0], ss, se, al, restart,
        _i16p(out))
    _writeback(rc, out, blocks)
    return 0


# ---------------------------------------------------------------------------
# The plain specification's scan loops (the JAX package's pure-Python
# route, jpeg/arith.py:508-791): the same signatures as the entry points
# above, run on the QM coder above. Used only by the tests.
# ---------------------------------------------------------------------------


def decode_seq_scan_plain(entropy, blocks, comp_ids, dc_sel, ac_sel,
                          dc_cond, ac_cond, restart, mcu_blocks):
    """Plain specification of ``decode_seq_scan``."""
    nblocks = blocks.shape[0]
    ncomp = len(dc_sel)
    dc_stats = {s: bytearray(DC_STAT_BINS) for s in set(dc_sel)}
    ac_stats = {s: bytearray(AC_STAT_BINS) for s in set(ac_sel)}
    fixed = bytearray([FIXED_STATE])
    last_dc = [0] * ncomp
    dc_ctx = [0] * ncomp
    dec = Decoder(entropy)
    rst_idx = 0
    for b in range(nblocks):
        if restart and b and b % (restart * mcu_blocks) == 0:
            pos, got = _resync(dec)
            if got != rst_idx & 7:
                raise ArithError(f"restart marker out of order: "
                                 f"RST{got} != RST{rst_idx & 7}")
            rst_idx += 1
            for s in dc_stats.values():
                s[:] = bytes(len(s))
            for s in ac_stats.values():
                s[:] = bytes(len(s))
            fixed[0] = FIXED_STATE
            last_dc = [0] * ncomp
            dc_ctx = [0] * ncomp
            dec = Decoder(entropy, pos)
        si = comp_ids[b]
        ds, As = dc_sel[si], ac_sel[si]
        diff, dc_ctx[si] = _dc_decode(dec, dc_stats[ds], dc_ctx[si],
                                      dc_cond[ds])
        last_dc[si] += diff
        row = blocks[b]
        row[0] = _w16(last_dc[si])
        _ac_decode_block(dec, ac_stats[As], fixed, ac_cond[As], row)
    return blocks


def encode_seq_scan_plain(blocks, comp_ids, dc_sel, ac_sel, dc_cond,
                          ac_cond, restart, mcu_blocks) -> bytes:
    """Plain specification of ``encode_seq_scan``."""
    nblocks = blocks.shape[0]
    ncomp = len(dc_sel)
    out = bytearray()
    rst_idx = 0

    def fresh():
        return ({s: bytearray(DC_STAT_BINS) for s in set(dc_sel)},
                {s: bytearray(AC_STAT_BINS) for s in set(ac_sel)},
                bytearray([FIXED_STATE]), [0] * ncomp, [0] * ncomp,
                Encoder())

    dc_stats, ac_stats, fixed, last_dc, dc_ctx, enc = fresh()
    for b in range(nblocks):
        if restart and b and b % (restart * mcu_blocks) == 0:
            out += enc.flush()
            out += bytes((0xFF, 0xD0 + (rst_idx & 7)))
            rst_idx += 1
            dc_stats, ac_stats, fixed, last_dc, dc_ctx, enc = fresh()
        si = comp_ids[b]
        ds, As = dc_sel[si], ac_sel[si]
        row = blocks[b]
        diff = int(row[0]) - last_dc[si]
        last_dc[si] = int(row[0])
        dc_ctx[si] = _dc_encode(enc, dc_stats[ds], dc_ctx[si],
                                dc_cond[ds], diff)
        _ac_encode_block(enc, ac_stats[As], fixed, ac_cond[As], row)
    out += enc.flush()
    return bytes(out)


def prog_dc_first_plain(entropy, blocks, comp_ids, dc_sel, dc_cond, al,
                        restart, mcu_blocks):
    """Plain specification of ``prog_dc_first``."""
    nblocks = blocks.shape[0]
    ncomp = len(dc_sel) if hasattr(dc_sel, "__len__") else 1
    dc_stats = {s: bytearray(DC_STAT_BINS) for s in set(dc_sel)}
    last_dc = [0] * ncomp
    dc_ctx = [0] * ncomp
    dec = Decoder(entropy)
    rst_idx = 0
    for b in range(nblocks):
        if restart and b and b % (restart * mcu_blocks) == 0:
            pos, got = _resync(dec)
            if got != rst_idx & 7:
                raise ArithError("restart marker out of order")
            rst_idx += 1
            for s in dc_stats.values():
                s[:] = bytes(len(s))
            last_dc = [0] * ncomp
            dc_ctx = [0] * ncomp
            dec = Decoder(entropy, pos)
        si = comp_ids[b]
        ds = dc_sel[si]
        diff, dc_ctx[si] = _dc_decode(dec, dc_stats[ds], dc_ctx[si],
                                      dc_cond[ds])
        last_dc[si] += diff
        blocks[b, 0] = _w16(last_dc[si] << al)
    return 0


def prog_dc_refine_plain(entropy, blocks, al, restart, mcu_blocks):
    """Plain specification of ``prog_dc_refine``."""
    nblocks = blocks.shape[0]
    fixed = bytearray([FIXED_STATE])
    dec = Decoder(entropy)
    rst_idx = 0
    p1 = 1 << al
    for b in range(nblocks):
        if restart and b and b % (restart * mcu_blocks) == 0:
            pos, got = _resync(dec)
            if got != rst_idx & 7:
                raise ArithError("restart marker out of order")
            rst_idx += 1
            fixed[0] = FIXED_STATE
            dec = Decoder(entropy, pos)
        if dec.decode(fixed, 0):
            blocks[b, 0] = int(blocks[b, 0]) | p1
    return 0


def prog_ac_first_plain(entropy, blocks, ac_cond_kx, ss, se, al, restart):
    """Plain specification of ``prog_ac_first``."""
    nblocks = blocks.shape[0]
    ac_stats = bytearray(AC_STAT_BINS)
    fixed = bytearray([FIXED_STATE])
    dec = Decoder(entropy)
    rst_idx = 0
    for b in range(nblocks):
        if restart and b and b % restart == 0:
            pos, got = _resync(dec)
            if got != rst_idx & 7:
                raise ArithError("restart marker out of order")
            rst_idx += 1
            ac_stats[:] = bytes(AC_STAT_BINS)
            fixed[0] = FIXED_STATE
            dec = Decoder(entropy, pos)
        _ac_decode_block(dec, ac_stats, fixed, ac_cond_kx, blocks[b],
                         ss, se, al)
    return 0


def prog_ac_refine_plain(entropy, blocks, ss, se, al, restart):
    """Plain specification of ``prog_ac_refine``."""
    nblocks = blocks.shape[0]
    ac_stats = bytearray(AC_STAT_BINS)
    fixed = bytearray([FIXED_STATE])
    dec = Decoder(entropy)
    rst_idx = 0
    p1 = 1 << al
    m1 = -1 << al
    for b in range(nblocks):
        if restart and b and b % restart == 0:
            pos, got = _resync(dec)
            if got != rst_idx & 7:
                raise ArithError("restart marker out of order")
            rst_idx += 1
            ac_stats[:] = bytes(AC_STAT_BINS)
            fixed[0] = FIXED_STATE
            dec = Decoder(entropy, pos)
        block = blocks[b]
        kex = 0
        for j in range(se, ss - 1, -1):
            if block[j]:
                kex = j
                break
        k = ss
        while k <= se:
            st = 3 * (k - 1)
            if k > kex and dec.decode(ac_stats, st):
                break                      # EOB
            while True:
                coef = int(block[k])
                if coef:
                    if dec.decode(ac_stats, st + 2):
                        block[k] = coef + (m1 if coef < 0 else p1)
                    break
                if dec.decode(ac_stats, st + 1):
                    block[k] = m1 if dec.decode(fixed, 0) else p1
                    break
                st += 3
                k += 1
                if k > se:
                    raise ArithError("AC refine run past Se")
            k += 1
    return 0
