"""Pure-Python host Huffman entropy codec: the plain specification of
jpeg/entropy.cpp (a copy of the JAX package's jpeg/huffman.py).

It implements the same six entry points as the native codec, with
identical bitstream semantics (T.81 Annex C/F/G): the baseline
``huff_encode`` / ``huff_decode`` and the four progressive scan
decoders (``prog_dc_first``, ``prog_dc_refine``, ``prog_ac_first``,
``prog_ac_refine``). tests/test_torch_progressive.py holds the native
codec to it bit for bit. No encode or decode path of the port calls it:
without the native library the first call of the codec raises.
"""

from __future__ import annotations

import numpy as np


def _build_codes(bits, vals):
    """symbol -> (code, size) dicts from a (bits[16], vals) spec."""
    code = {}
    c = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]] = (c, length)
            c += 1
            k += 1
        c <<= 1
    return code


def _build_decode(bits, vals):
    """(mincode, maxcode, valptr, vals) per length for canonical
    decode (T.81 F.2.2.3)."""
    mincode = [0] * 17
    maxcode = [-1] * 17
    valptr = [0] * 17
    c = 0
    k = 0
    for length in range(1, 17):
        if bits[length - 1]:
            valptr[length] = k
            mincode[length] = c
            c += bits[length - 1]
            k += bits[length - 1]
            maxcode[length] = c - 1
        c <<= 1
    return mincode, maxcode, valptr, list(vals)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, nbits):
        if nbits <= 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)  # 1-pad to the byte boundary

    def restart(self, idx):
        self.flush()
        self.out.append(0xFF)
        self.out.append(0xD0 + (idx & 7))


class _BitReader:
    def __init__(self, data):
        self.d = bytes(data)
        self.pos = 0
        self.acc = 0
        self.n = 0

    def _fill(self):
        while self.n <= 24:
            if self.pos >= len(self.d):
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.n += 8
                continue
            b = self.d[self.pos]
            if b == 0xFF:
                nxt = self.d[self.pos + 1] if self.pos + 1 < len(self.d) \
                    else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                    self.acc = ((self.acc << 8) | 0xFF) & 0xFFFFFFFF
                    self.n += 8
                    continue
                # real marker: stop feeding, pad with zeros
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.n += 8
                continue
            self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.n += 8

    def get(self, nbits):
        if nbits == 0:
            return 0
        self._fill()
        self.n -= nbits
        v = (self.acc >> self.n) & ((1 << nbits) - 1)
        return v

    def sync_restart(self):
        """Byte-align and consume one RSTn (0xFF fill bytes allowed
        before it, T.81 B.1.1.2)."""
        self.acc = 0
        self.n = 0
        while (self.pos + 1 < len(self.d) and self.d[self.pos] == 0xFF
               and self.d[self.pos + 1] == 0xFF):
            self.pos += 1
        if (self.pos + 1 < len(self.d) and self.d[self.pos] == 0xFF
                and 0xD0 <= self.d[self.pos + 1] <= 0xD7):
            self.pos += 2
            return True
        return False

    def decode_sym(self, dec):
        mincode, maxcode, valptr, vals = dec
        self._fill()
        code = 0
        for length in range(1, 17):
            code = (code << 1) | ((self.acc >> (self.n - length)) & 1)
            if maxcode[length] >= 0 and code <= maxcode[length]:
                self.n -= length
                return vals[valptr[length] + code - mincode[length]]
        raise ValueError("invalid huffman code")


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _csize(v):
    a = abs(int(v))
    s = 0
    while a:
        s += 1
        a >>= 1
    return s


def _tables_list(tabs):
    """codec.py passes a 4-slot list of (bits, vals) or None."""
    return [None if t is None else t for t in tabs]


def huff_encode(blocks, comp_ids, dc_sel, ac_sel, dc_tables, ac_tables,
                restart_interval, mcu_blocks) -> bytes:
    """Baseline entropy encode; mirrors uhdr_huff_encode."""
    dc_codes = [None if t is None else _build_codes(*t)
                for t in _tables_list(dc_tables)]
    ac_codes = [None if t is None else _build_codes(*t)
                for t in _tables_list(ac_tables)]
    bw = _BitWriter()
    ncomp = len(dc_sel)
    pred = [0] * ncomp
    mcu = 0
    rst = 0
    blocks = np.asarray(blocks)
    for b in range(blocks.shape[0]):
        if (restart_interval and mcu_blocks and b % mcu_blocks == 0
                and mcu and mcu % restart_interval == 0):
            bw.restart(rst)
            rst += 1
            pred = [0] * ncomp
        ci = int(comp_ids[b])
        dct = dc_codes[int(dc_sel[ci])]
        act = ac_codes[int(ac_sel[ci])]
        blk = blocks[b]
        diff = int(blk[0]) - pred[ci]
        pred[ci] = int(blk[0])
        s = _csize(diff)
        c, ln = dct[s]
        bw.put(c, ln)
        if s:
            bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c, ln = act[0xF0]
                bw.put(c, ln)
                run -= 16
            s = _csize(v)
            c, ln = act[(run << 4) | s]
            bw.put(c, ln)
            bw.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            c, ln = act[0x00]
            bw.put(c, ln)
        if b % mcu_blocks == mcu_blocks - 1:
            mcu += 1
    bw.flush()
    return bytes(bw.out)


def huff_decode(data, nblocks, comp_ids, dc_sel, ac_sel, dc_tables,
                ac_tables, restart_interval, mcu_blocks) -> np.ndarray:
    """Baseline entropy decode; mirrors uhdr_huff_decode."""
    dc_dec = [None if t is None else _build_decode(*t)
              for t in _tables_list(dc_tables)]
    ac_dec = [None if t is None else _build_decode(*t)
              for t in _tables_list(ac_tables)]
    br = _BitReader(data)
    ncomp = len(dc_sel)
    pred = [0] * ncomp
    out = np.zeros((nblocks, 64), np.int16)
    mcu = 0
    for b in range(nblocks):
        if (restart_interval and mcu_blocks and b % mcu_blocks == 0
                and mcu and mcu % restart_interval == 0):
            br.sync_restart()
            pred = [0] * ncomp
        ci = int(comp_ids[b])
        s = br.decode_sym(dc_dec[int(dc_sel[ci])])
        diff = _extend(br.get(s), s)
        pred[ci] += diff
        out[b, 0] = pred[ci]
        act = ac_dec[int(ac_sel[ci])]
        k = 1
        while k < 64:
            sym = br.decode_sym(act)
            if sym == 0:
                break
            if sym == 0xF0:
                k += 16
                continue
            k += sym >> 4
            if k > 63:
                break
            s = sym & 15
            out[b, k] = _extend(br.get(s), s)
            k += 1
        if b % mcu_blocks == mcu_blocks - 1:
            mcu += 1
    return out


# ---------------------------------------------------------------------------
# Progressive scans (T.81 Annex G.2): four per-scan decoders operating
# on the caller's coefficient buffers, exactly like the native ones.
# ---------------------------------------------------------------------------


def prog_dc_first(data, buf, comp_ids, dc_sel, dc_tables, al,
                  restart_interval, mcu_blocks):
    """DC first scan: buf[b, 0] = (pred + diff) << al."""
    dc_dec = [None if t is None else _build_decode(*t)
              for t in _tables_list(dc_tables)]
    br = _BitReader(data)
    ncomp = len(dc_sel)
    pred = [0] * ncomp
    mcu = 0
    for b in range(buf.shape[0]):
        if (restart_interval and mcu_blocks and b % mcu_blocks == 0
                and mcu and mcu % restart_interval == 0):
            br.sync_restart()
            pred = [0] * ncomp
        ci = int(comp_ids[b])
        s = br.decode_sym(dc_dec[int(dc_sel[ci])])
        diff = _extend(br.get(s), s)
        pred[ci] += diff
        buf[b, 0] = pred[ci] << al
        if b % mcu_blocks == mcu_blocks - 1:
            mcu += 1
    return 0


def prog_dc_refine(data, buf, al, restart_interval, mcu_blocks):
    """DC refinement: one correction bit per block."""
    br = _BitReader(data)
    mcu = 0
    for b in range(buf.shape[0]):
        if (restart_interval and mcu_blocks and b % mcu_blocks == 0
                and mcu and mcu % restart_interval == 0):
            br.sync_restart()
        if br.get(1):
            buf[b, 0] = int(buf[b, 0]) | (1 << al)
        if b % mcu_blocks == mcu_blocks - 1:
            mcu += 1
    return 0


def prog_ac_first(data, buf, ac_table, ss, se, al, restart_interval):
    """AC first scan for one component (G.1.2.2): EOBRUN bands."""
    dec = _build_decode(*ac_table)
    br = _BitReader(data)
    eobrun = 0
    for b in range(buf.shape[0]):
        if restart_interval and b and b % restart_interval == 0:
            br.sync_restart()
            eobrun = 0
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            sym = br.decode_sym(dec)
            r, s = sym >> 4, sym & 15
            if s == 0:
                if r == 15:
                    k += 16
                    continue
                eobrun = (1 << r) - 1
                if r:
                    eobrun += br.get(r)
                break
            k += r
            if k > se:
                break
            buf[b, k] = _extend(br.get(s), s) << al
            k += 1
    return 0


def prog_ac_refine(data, buf, ac_table, ss, se, al, restart_interval):
    """AC refinement scan (G.1.2.3)."""
    dec = _build_decode(*ac_table)
    br = _BitReader(data)
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al

    def refine_nonzero(b, k):
        if br.get(1):
            v = int(buf[b, k])
            if v > 0 and not (v & p1):
                buf[b, k] = v + p1
            elif v < 0 and not (v & p1):
                buf[b, k] = v + m1

    for b in range(buf.shape[0]):
        if restart_interval and b and b % restart_interval == 0:
            br.sync_restart()
            eobrun = 0
        k = ss
        if eobrun == 0:
            while k <= se:
                sym = br.decode_sym(dec)
                r, s = sym >> 4, sym & 15
                newval = 0
                if s == 0:
                    if r != 15:
                        # EOB run: the CURRENT block's remaining
                        # nonzero-history coefficients are refined by
                        # the eobrun clause below, then one run unit is
                        # consumed (libjpeg decode_mcu_AC_refine).
                        eobrun = 1 << r
                        if r:
                            eobrun += br.get(r)
                        break
                else:
                    newval = p1 if br.get(1) else m1
                # advance over r zero-history coefficients, refining
                # nonzero ones along the way
                while k <= se:
                    if int(buf[b, k]) != 0:
                        refine_nonzero(b, k)
                    else:
                        if r == 0:
                            if newval:
                                buf[b, k] = newval
                            k += 1
                            break
                        r -= 1
                    k += 1
        if eobrun > 0:
            while k <= se:
                if int(buf[b, k]) != 0:
                    refine_nonzero(b, k)
                k += 1
            eobrun -= 1
    return 0
