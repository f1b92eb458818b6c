"""Plain JPEG/R reader: container, markers and baseline Huffman decode.

An independent reader of what the timed path writes and of the files
the decode cells read. It imports nothing of the program under test:
numpy alone.

- ``split_jpegr`` walks the primary image's segments, reads the MPF
  index (CIPA DC-007) and returns the primary and gain-map JPEGs with
  the primary's XMP, ICC and MPF facts and the gain map's XMP.
- ``parse_jpeg`` reads a baseline JPEG's markers: SOF0, DQT, DHT, DRI,
  SOS and the entropy-coded segment up to EOI.
- ``decode_coefficients`` Huffman-decodes the scan (ITU-T T.81 F.2.2)
  to quantized coefficients in zigzag order. The scan must carry
  restart markers: each restart interval starts with its DC predictors
  reset and on a byte boundary, so every interval is an independent
  lane, and numpy decodes all lanes in lockstep, one symbol a step.

Every check that fails is recorded as a fault (a short string) rather
than raised, so that the judge can count them.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

XMP_NS = b"http://ns.adobe.com/xap/1.0/\x00"
ICC_SIG = b"ICC_PROFILE\x00"
MPF_SIG = b"MPF\x00"


@dataclass
class Jpeg:
    """One baseline JPEG's headers and its entropy-coded segment."""

    width: int = 0
    height: int = 0
    comps: list = field(default_factory=list)   # (id, h, v, tq)
    qt: dict = field(default_factory=dict)      # tq -> (64,) natural order
    huff: dict = field(default_factory=dict)    # (class, id) -> (bits, vals)
    scan: list = field(default_factory=list)    # (comp index, td, ta)
    restart: int = 0
    app: list = field(default_factory=list)     # (marker, payload)
    data: bytes = b""
    faults: list = field(default_factory=list)


def _segments(buf: bytes, start: int, faults: list):
    """(marker, payload, payload start) of each segment from `start`
    (just past SOI) up to and including SOS; the entropy-coded data
    begins after the last one."""
    pos = start
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            faults.append(f"no marker at byte {pos}")
            return
        marker = buf[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        yield marker, buf[pos + 4:pos + 2 + length], pos + 4
        pos += 2 + length
        if marker == 0xDA:
            return
    faults.append("segments run past the end")


def parse_jpeg(buf: bytes) -> Jpeg:
    """The headers and entropy data of one baseline JPEG (SOI to EOI)."""
    j = Jpeg()
    if buf[:2] != b"\xff\xd8":
        j.faults.append("no SOI")
        return j
    end = 2
    for marker, p, at in _segments(buf, 2, j.faults):
        end = at + len(p)
        if 0xE0 <= marker <= 0xEF:
            j.app.append((marker, p))
        elif marker == 0xDB:
            i = 0
            while i < len(p):
                pq, tq = p[i] >> 4, p[i] & 15
                if pq:
                    j.faults.append("16-bit quant table")
                    return j
                q = np.zeros(64, np.int32)
                q[ZIGZAG] = np.frombuffer(p[i + 1:i + 65], np.uint8)
                j.qt[tq] = q
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(p):
                tc, th = p[i] >> 4, p[i] & 15
                bits = list(p[i + 1:i + 17])
                n = sum(bits)
                j.huff[(tc, th)] = (bits, list(p[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", p[:6])
            j.height, j.width = h, w
            j.comps = [(p[6 + 3 * k], p[7 + 3 * k] >> 4, p[7 + 3 * k] & 15,
                        p[8 + 3 * k]) for k in range(nc)]
        elif marker in (0xC1, 0xC2, 0xC3) or 0xC5 <= marker <= 0xCF \
                and marker != 0xCC:
            j.faults.append(f"not baseline: SOF {marker:#x}")
            return j
        elif marker == 0xDD:
            j.restart = struct.unpack(">H", p[:2])[0]
        elif marker == 0xDA:
            ns = p[0]
            ids = [c[0] for c in j.comps]
            for k in range(ns):
                cid, t = p[1 + 2 * k], p[2 + 2 * k]
                if cid not in ids:
                    j.faults.append(f"scan names unknown component {cid}")
                    return j
                j.scan.append((ids.index(cid), t >> 4, t & 15))
            ss, se, a = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                j.faults.append("not a sequential scan")
    if buf[-2:] != b"\xff\xd9":
        j.faults.append("no EOI")
    j.data = buf[end:len(buf) - 2]
    return j


def _lookup(bits, vals):
    """(65536,) code length and symbol for every 16-bit window whose
    leading bits are a code of this table (canonical codes, T.81 C.2);
    length 0 marks a window that starts with no code."""
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return length, symbol


def _intervals(data: bytes, faults: list):
    """The scan's bytes with stuffing and markers removed, and the byte
    span of each restart interval in them. Checks that every marker is
    the next RSTn in order (T.81 B.2.1)."""
    a = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(a[:-1] == 0xFF)
    nxt = a[ff + 1]
    stuffed = ff[nxt == 0x00]
    markers = ff[nxt != 0x00]
    codes = a[markers + 1]
    if markers.size:
        want = 0xD0 + (np.arange(markers.size) % 8)
        bad = int(np.count_nonzero(codes != want))
        if bad:
            faults.append(f"{bad} restart markers out of order")
    if a.size and a[-1] == 0xFF:
        faults.append("scan ends in a bare 0xFF")
    keep = np.ones(a.size, bool)
    keep[stuffed + 1] = False
    keep[markers] = False
    keep[markers + 1] = False
    out = a[keep]
    kept_before = np.concatenate([[0], np.cumsum(keep)])
    cuts = kept_before[markers]
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [out.size]])
    return out, starts, ends


def _extend(v, s):
    """T.81 F.2.2.1 EXTEND: the signed value of s magnitude bits v."""
    neg = (s > 0) & (v < (np.int64(1) << np.maximum(s - 1, 0)))
    return np.where(neg, v - (np.int64(1) << s) + 1, v)


def decode_coefficients(j: Jpeg):
    """Quantized coefficients of every component of `j`, each a
    (blocks high, blocks wide, 64) int16 array in zigzag order, or None
    where the scan cannot be read (a fault says why)."""
    if j.faults:
        return None
    if not j.restart:
        j.faults.append("no restart interval")
        return None
    hmax = max(c[1] for c in j.comps)
    vmax = max(c[2] for c in j.comps)
    if len(j.scan) == 1:
        hs = vs = [1]
        comp_of_block = [0]
        c = j.comps[j.scan[0][0]]
        mx = -(-j.width * c[1] // hmax // 8)
        my = -(-j.height * c[2] // vmax // 8)
        grids = [(my, mx)]
    else:
        hs = [j.comps[ci][1] for ci, _, _ in j.scan]
        vs = [j.comps[ci][2] for ci, _, _ in j.scan]
        comp_of_block = [k for k in range(len(j.scan))
                         for _ in range(hs[k] * vs[k])]
        mx = -(-j.width // (8 * hmax))
        my = -(-j.height // (8 * vmax))
        grids = [(my * vs[k], mx * hs[k]) for k in range(len(j.scan))]
    bpm = len(comp_of_block)
    n_mcu = mx * my
    data, starts, ends = _intervals(j.data, j.faults)
    n_lanes = -(-n_mcu // j.restart)
    if starts.size != n_lanes:
        j.faults.append(f"{starts.size} restart intervals, {n_lanes} due")
        return None
    tables = {}
    for key in {(0, td) for _, td, _ in j.scan} | {(1, ta)
                                                   for _, _, ta in j.scan}:
        if key not in j.huff:
            j.faults.append(f"Huffman table {key} missing")
            return None
        tables[key] = _lookup(*j.huff[key])
    keys = sorted(tables)
    t_len = np.stack([tables[k][0] for k in keys])
    t_sym = np.stack([tables[k][1] for k in keys])
    dc_sel = np.array([keys.index((0, td)) for _, td, _ in j.scan])
    ac_sel = np.array([keys.index((1, ta)) for _, _, ta in j.scan])
    blk_comp = np.array(comp_of_block)

    buf = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.uint64)
    lane_mcus = np.minimum(j.restart, n_mcu - np.arange(n_lanes) * j.restart)
    nblk = lane_mcus * bpm
    out = np.zeros((n_lanes, j.restart * bpm, 64), np.int16)
    pos = starts.astype(np.int64) * 8
    end_bits = ends.astype(np.int64) * 8
    blk = np.zeros(n_lanes, np.int64)
    k = np.zeros(n_lanes, np.int64)
    pred = np.zeros((n_lanes, len(j.scan)), np.int64)
    lane = np.arange(n_lanes)
    bad = np.zeros(n_lanes, bool)
    while lane.size:
        p = pos[lane]
        b = p >> 3
        word = ((buf[b] << np.uint64(32)) | (buf[b + 1] << np.uint64(24))
                | (buf[b + 2] << np.uint64(16)) | (buf[b + 3] << np.uint64(8))
                | buf[b + 4])
        peek = ((word << (p & 7).astype(np.uint64)) >> np.uint64(8)
                ).astype(np.int64) & 0xFFFFFFFF
        kk = k[lane]
        comp = blk_comp[blk[lane] % bpm]
        dc = kk == 0
        sel = np.where(dc, dc_sel[comp], ac_sel[comp])
        idx = peek >> 16
        n = t_len[sel, idx]
        sym = t_sym[sel, idx]
        s = np.where(dc, sym, sym & 15)
        run = np.where(dc, 0, sym >> 4)
        v = (peek >> np.maximum(32 - n - s, 0)) & ((np.int64(1) << s) - 1)
        v = _extend(v, s)
        bad[lane[n == 0]] = True
        # DC: the predictor of the block's component moves by v.
        d = np.flatnonzero(dc)
        if d.size:
            ld = lane[d]
            pred[ld, comp[d]] += v[d]
            out[ld, blk[ld], 0] = pred[ld, comp[d]]
        # AC: EOB ends the block, ZRL skips 16 zeros, else a run and a
        # value.
        a = np.flatnonzero(~dc)
        ka = kk[a] + run[a]
        eob = (sym[a] == 0)
        zrl = (sym[a] == 0xF0)
        val = ~eob & ~zrl
        over = val & (ka > 63)
        bad[lane[a[over]]] = True
        put = a[val & ~over]
        out[lane[put], blk[lane[put]], kk[put] + run[put]] = v[put]
        newk = np.where(dc, 1, 0)
        newk[a] = np.where(eob, 64, np.where(zrl, kk[a] + 16, ka + 1))
        k[lane] = newk
        pos[lane] = p + n + s
        done_blk = lane[k[lane] >= 64]
        blk[done_blk] += 1
        k[done_blk] = 0
        finished = (blk[lane] >= nblk[lane]) | bad[lane] | (
            pos[lane] > end_bits[lane])
        lane = lane[~finished]
    overrun = pos > end_bits
    short = (end_bits - pos) >= 8
    if bad.any():
        j.faults.append(f"{int(bad.sum())} intervals hold an invalid code")
    if overrun.any():
        j.faults.append(f"{int(overrun.sum())} intervals overrun their bytes")
    if short.any():
        j.faults.append(f"{int(short.sum())} intervals leave bytes unread")
    if j.faults:
        return None
    mcus = out.reshape(n_lanes * j.restart, bpm, 64)[:n_mcu]
    result = []
    first = 0
    for c in range(len(j.scan)):
        h, v = hs[c], vs[c]
        m = mcus[:, first:first + h * v].reshape(my, mx, v, h, 64)
        result.append(np.ascontiguousarray(
            m.transpose(0, 2, 1, 3, 4).reshape(grids[c][0], grids[c][1], 64)))
        first += h * v
    return result


@dataclass
class JpegR:
    """A JPEG/R file split by its MPF index."""

    primary: bytes
    gainmap: bytes
    primary_xmp: bytes | None
    gainmap_xmp: bytes | None
    icc: bytes | None
    faults: list


def _app_payloads(buf: bytes, faults: list):
    """APPn payloads of a JPEG's header, each with its absolute offset."""
    out = []
    if buf[:2] != b"\xff\xd8":
        faults.append("no SOI")
        return out
    for marker, p, at in _segments(buf, 2, faults):
        if 0xE0 <= marker <= 0xEF:
            out.append((marker, p, at))
    return out


def _mpf_entries(p: bytes, faults: list):
    """(attribute, size, offset) of each MP entry of an MPF payload."""
    tiff = p[4:]
    bo = {b"MM": ">", b"II": "<"}.get(tiff[:2])
    if bo is None:
        faults.append("MPF has no byte order")
        return []
    ifd = struct.unpack(bo + "I", tiff[4:8])[0]
    count = struct.unpack(bo + "H", tiff[ifd:ifd + 2])[0]
    entries = []
    for e in range(count):
        tag, typ, n, val = struct.unpack(
            bo + "HHII", tiff[ifd + 2 + 12 * e:ifd + 14 + 12 * e])
        if tag == 0xB002:
            for i in range(n // 16):
                entries.append(struct.unpack(
                    bo + "III", tiff[val + 16 * i:val + 16 * i + 12]))
    if not entries:
        faults.append("MPF has no MP entries")
    return entries


def split_jpegr(blob: bytes) -> JpegR:
    """Primary and gain-map JPEGs of a JPEG/R, found through the MPF
    index, with the primary's XMP and ICC and the gain map's XMP."""
    faults: list = []
    apps = _app_payloads(blob, faults)
    pxmp = icc = None
    mpf_at = entries = None
    for marker, p, at in apps:
        if marker == 0xE1 and p.startswith(XMP_NS):
            pxmp = p[len(XMP_NS):]
        elif marker == 0xE2 and p.startswith(ICC_SIG):
            icc = p[len(ICC_SIG) + 2:]
        elif marker == 0xE2 and p.startswith(MPF_SIG):
            mpf_at, entries = at + 4, _mpf_entries(p, faults)
    if mpf_at is None or len(entries or []) < 2:
        faults.append("no MPF index of two images")
        return JpegR(blob, b"", pxmp, None, icc, faults)
    (_, psize, _), (_, gsize, goff) = entries[0], entries[1]
    gstart = mpf_at + goff
    if blob[gstart:gstart + 2] != b"\xff\xd8":
        faults.append("MPF offset does not point at the gain map's SOI")
    if psize != gstart:
        faults.append(f"MPF primary size {psize}, gain map at {gstart}")
    if gstart + gsize != len(blob):
        faults.append(f"MPF gain map size {gsize} ends at {gstart + gsize}"
                      f", file at {len(blob)}")
    primary, gainmap = blob[:gstart], blob[gstart:gstart + gsize]
    gxmp = None
    for marker, p, _ in _app_payloads(gainmap, faults):
        if marker == 0xE1 and p.startswith(XMP_NS):
            gxmp = p[len(XMP_NS):]
    return JpegR(primary, gainmap, pxmp, gxmp, icc, faults)


_ATTR = re.compile(rb'([A-Za-z][\w]*:[A-Za-z][\w]*)\s*=\s*"([^"]*)"')


def xmp_attributes(xmp: bytes | None) -> dict:
    """Every prefixed attribute of an XMP packet, name -> text."""
    if not xmp:
        return {}
    out = {}
    for k, v in _ATTR.findall(xmp):
        out.setdefault(k.decode(), v.decode())
    return out


def icc_colorants(icc: bytes | None):
    """The (3, 3) XYZ of the rXYZ, gXYZ and bXYZ tags of an ICC profile
    (s15Fixed16Number), or None where the profile lacks them."""
    if not icc or len(icc) < 132 or icc[36:40] != b"acsp":
        return None
    n = struct.unpack(">I", icc[128:132])[0]
    tags = {}
    for t in range(n):
        sig, off, size = struct.unpack(">4sII", icc[132 + 12 * t:144 + 12 * t])
        tags[sig] = icc[off:off + size]
    rows = []
    for sig in (b"rXYZ", b"gXYZ", b"bXYZ"):
        if sig not in tags or tags[sig][:4] != b"XYZ ":
            return None
        rows.append([v / 65536.0 for v in
                     struct.unpack(">iii", tags[sig][8:20])])
    return np.asarray(rows, np.float64)
