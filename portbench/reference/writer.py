"""Plain JPEG/R writer: the decode cells' input files, made from the seed.

An Ultra HDR API-0 JPEG/R of one P010 frame, written by the reference
alone, so that what a decode cell reads does not follow the encoder of
the program under test:

- the SDR base and the gain map of ``codec.encode_front``, transformed
  and quantized by ``codec.fdct_quant`` at the configuration's quality;
- baseline Huffman coding with the typical tables of ITU-T T.81 Annex
  K.3, a restart marker every ``RESTART_MCUS`` MCUs, byte stuffing;
- the JPEG/R container (libultrahdr's jpegr.cpp appendGainMap): the
  primary's XMP (hdrgm version and container directory), an ICC profile
  with the gamut's colorants, the MPF index of both images (CIPA
  DC-007), and the gain map's XMP metadata.

The entropy coder is vectorized in PyTorch on the coefficients' device:
every block's symbols at once, each symbol with its zero-run codes and
magnitude bits one token of at most 59 bits, tokens placed by a prefix
sum of their lengths into 32-bit words, each restart interval padded
with 1-bits to a whole byte.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import codec

RESTART_MCUS = 4  # MCUs a restart interval, as the program's own files

# ITU-T T.81 Annex K.3: (code counts of lengths 1..16, symbols).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])

XMP_NS = b"http://ns.adobe.com/xap/1.0/\x00"
GAINMAP_NS = "http://ns.adobe.com/hdr-gain-map/1.0/"
D50 = (0.9642, 1.0, 0.8249)  # the ICC profile connection white
# Primaries of each gamut (CIE 1931 xy) and D65, for the ICC colorants.
PRIMARIES = {"bt709": ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06)),
             "p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
             "bt2100": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046))}
D65 = (0.3127, 0.3290)
BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                     [-0.7502, 1.7135, 0.0367],
                     [0.0389, -0.0685, 1.0296]])


def canonical_codes(bits, vals) -> tuple[np.ndarray, np.ndarray]:
    """(256,) code and code length of each symbol of a table (T.81
    C.2); length 0 for a symbol the table lacks."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            code[vals[k]], length[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


class _Tables:
    """One DC and one AC table on a device, with AC's zero-run codes
    repeated 0 to 3 times."""

    def __init__(self, dc, ac, device):
        dcc, dcl = canonical_codes(*dc)
        acc, acl = canonical_codes(*ac)
        zc, zl = int(acc[0xF0]), int(acl[0xF0])
        rep = [0, zc, (zc << zl) | zc, (zc << 2 * zl) | (zc << zl) | zc]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.dc_code, self.dc_len = t(dcc), t(dcl)
        self.ac_code, self.ac_len = t(acc), t(acl)
        self.zrl_rep, self.zrl_len = t(rep), t([zl])


def _size(v: torch.Tensor) -> torch.Tensor:
    """T.81 F.1.2.1 SSSS: the bit length of |v|."""
    a = v.abs()
    s = torch.zeros_like(a)
    for k in range(16):
        s += (a >= (1 << k)).to(a.dtype)
    return s


def _magnitude(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The s low bits that code v (one's complement of |v| if v < 0)."""
    return torch.where(v < 0, v + (torch.ones_like(s) << s) - 1, v)


def _scan_blocks(grids, sampling, mcus_y: int, mcus_x: int):
    """(blocks (n, 64) in scan order, component of each block, blocks an
    MCU): component grids (bh, bw, 64) interleaved MCU by MCU, each
    component's blocks raster within the MCU; grids short of whole MCUs
    repeat their last block row and column."""
    parts, comp = [], []
    for c, (g, (h, v)) in enumerate(zip(grids, sampling)):
        dev = g.device
        rows = torch.clamp(torch.arange(mcus_y * v, device=dev),
                           max=g.shape[0] - 1)
        cols = torch.clamp(torch.arange(mcus_x * h, device=dev),
                           max=g.shape[1] - 1)
        gg = g.index_select(0, rows).index_select(1, cols)
        parts.append(gg.reshape(mcus_y, v, mcus_x, h, 64).permute(
            0, 2, 1, 3, 4).reshape(mcus_y * mcus_x, v * h, 64))
        comp += [c] * (v * h)
    blocks = torch.cat(parts, dim=1)
    n_mcu = mcus_y * mcus_x
    comp_t = torch.as_tensor(comp, device=blocks.device).repeat(n_mcu)
    return blocks.reshape(-1, 64).to(torch.int64), comp_t, len(comp)


def entropy_code(grids, sampling, tables, mcus_y: int, mcus_x: int,
                 restart: int) -> bytes:
    """The entropy-coded segment of one scan: every component of
    `grids` ((bh, bw, 64) int zigzag coefficients) with `sampling`
    ((h, v) each) and `tables` (a _Tables each), a restart marker every
    `restart` MCUs."""
    blocks, comp, bpm = _scan_blocks(grids, sampling, mcus_y, mcus_x)
    dev = blocks.device
    n = blocks.shape[0]
    interval = torch.arange(n, device=dev) // bpm // restart
    n_int = int(interval[-1]) + 1

    def field(attr):
        """A table field stacked over the components, (components, k)."""
        return torch.stack([getattr(t, attr) for t in tables])

    # DC: the difference from the component's previous block, the
    # predictor reset at each restart interval (T.81 F.1.2.1).
    dc = blocks[:, 0]
    diff = torch.empty_like(dc)
    for c in range(len(tables)):
        idx = torch.nonzero(comp == c).squeeze(1)
        d, iv = dc[idx], interval[idx]
        prev = torch.cat([d.new_zeros(1), d[:-1]])
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           iv[1:] != iv[:-1]])
        diff[idx] = d - torch.where(first, torch.zeros_like(prev), prev)
    s0 = _size(diff)
    if int(s0.max()) > 11:
        raise ValueError("a DC difference beyond baseline's 11 bits")
    v_dc = (field("dc_code")[comp, s0] << s0) | _magnitude(diff, s0)
    len_dc = field("dc_len")[comp, s0] + s0

    # AC: each nonzero coefficient is a token of its zero-run codes
    # (runs of 16), its run/size code and its magnitude bits.
    ac = blocks[:, 1:]
    nz = ac != 0
    pos = torch.arange(1, 64, device=dev).expand(n, 63)
    last = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)),
                        dim=1).values
    prev = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
    run = torch.where(nz, pos - prev - 1, torch.zeros_like(pos))
    s = _size(ac)
    if int(s.max()) > 10:
        raise ValueError("an AC coefficient beyond baseline's 10 bits")
    sym = ((run & 15) << 4) | s
    zrl = run >> 4
    ci = comp[:, None]
    code, clen = field("ac_code")[ci, sym], field("ac_len")[ci, sym]
    if bool(((clen == 0) & nz).any()):
        raise ValueError("a symbol the AC table lacks")
    rlen = zrl * field("zrl_len")[ci, 0]
    v_ac = torch.where(nz, (field("zrl_rep")[ci, zrl] << (clen + s))
                       | (code << s) | _magnitude(ac, s),
                       torch.zeros_like(ac))
    len_ac = torch.where(nz, rlen + clen + s, torch.zeros_like(ac))
    eob = last[:, -1] < 63
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    v_eob = torch.where(eob, field("ac_code")[comp, 0], zero)
    len_eob = torch.where(eob, field("ac_len")[comp, 0], zero)

    # Each interval padded with 1-bits to a whole byte (T.81 F.1.2.3).
    bits = len_dc + len_ac.sum(dim=1) + len_eob
    int_bits = torch.zeros(n_int, dtype=torch.int64, device=dev)
    int_bits.index_add_(0, interval, bits)
    pad = (-int_bits) % 8
    is_last = torch.ones(n, dtype=torch.bool, device=dev)
    is_last[:-1] = interval[1:] != interval[:-1]
    len_pad = torch.where(is_last, pad[interval], zero)
    v_pad = (torch.ones_like(len_pad) << len_pad) - 1

    vals = torch.cat([v_dc[:, None], v_ac, v_eob[:, None], v_pad[:, None]],
                     dim=1).reshape(-1)
    lens = torch.cat([len_dc[:, None], len_ac, len_eob[:, None],
                      len_pad[:, None]], dim=1).reshape(-1)
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    if int(lens.max()) > 59:
        raise ValueError("a token longer than 59 bits")
    data = _place_bits(vals, lens)
    return _stuff(data, (int_bits + pad) // 8)


def _place_bits(vals: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(bytes,) uint8: the tokens' bits back to back, most significant
    first. A token spans at most three 32-bit words; its parts in each
    are added into place, which is an OR, since no two tokens share a
    bit."""
    off = torch.cumsum(lens, 0) - lens
    total = int(off[-1] + lens[-1])
    words = torch.zeros(total // 32 + 4, dtype=torch.int64,
                        device=vals.device)
    a = off % 32
    w = off // 32
    e = a + lens
    for j in range(3):
        lo = torch.clamp(a, min=32 * j)
        hi = torch.clamp(e, max=32 * j + 32)
        nb = torch.clamp(hi - lo, min=0)
        part = (vals >> (e - hi).clamp(min=0)) & (
            (torch.ones_like(nb) << nb) - 1)
        part = part << (32 * j + 32 - hi).clamp(min=0)
        words.index_add_(0, w + j, torch.where(nb > 0, part,
                                               torch.zeros_like(part)))
    be = torch.stack([(words >> sh) & 255 for sh in (24, 16, 8, 0)], dim=1)
    return be.reshape(-1)[:total // 8]


def _stuff(data: torch.Tensor, int_bytes: torch.Tensor) -> bytes:
    """The scan's bytes with a 0x00 after each 0xFF and RST0..7 between
    intervals (T.81 B.1.1.5, B.2.1)."""
    dev = data.device
    n_int = int_bytes.numel()
    ff = (data == 0xFF).to(torch.int64)
    before = torch.cumsum(ff, 0) - ff
    which = torch.repeat_interleave(torch.arange(n_int, device=dev),
                                    int_bytes)
    pos = torch.arange(data.numel(), device=dev) + before + 2 * which
    out = torch.zeros(data.numel() + int(ff.sum()) + 2 * (n_int - 1),
                      dtype=torch.int64, device=dev)
    out[pos] = data
    if n_int > 1:
        starts = torch.cumsum(int_bytes, 0)[:-1]
        p = pos[starts]
        out[p - 2] = 0xFF
        out[p - 1] = 0xD0 + torch.arange(n_int - 1, device=dev) % 8
    return out.to(torch.uint8).cpu().numpy().tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def baseline_jpeg(grids, sampling, qtables, width: int, height: int,
                  restart: int = RESTART_MCUS, apps: bytes = b"") -> bytes:
    """A baseline JPEG: one scan of every component of `grids`, the first
    with the luma tables (quant table 0, Huffman 0), the others with the
    chroma ones; `apps` after SOI."""
    chroma = len(grids) > 1
    dev = grids[0].device
    luma = _Tables(DC_LUMA, AC_LUMA, dev)
    tabs = [luma] + [_Tables(DC_CHROMA, AC_CHROMA, dev)] * (len(grids) - 1)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    my, mx = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    data = entropy_code(grids, sampling, tabs, my, mx, restart)
    dqt = b"".join(bytes([k]) + bytes(q.astype(np.uint8)[codec.ZIGZAG])
                   for k, q in enumerate(qtables))
    sof = struct.pack(">BHHB", 8, height, width, len(grids)) + b"".join(
        bytes([c + 1, (h << 4) | v, min(c, 1)])
        for c, (h, v) in enumerate(sampling))
    dht = b""
    for k, (dc, ac) in enumerate([(DC_LUMA, AC_LUMA)]
                                 + [(DC_CHROMA, AC_CHROMA)] * chroma):
        for tc, (bits, vals) in ((0, dc), (1, ac)):
            dht += bytes([(tc << 4) | k]) + bytes(bits) + bytes(vals)
    sos = bytes([len(grids)]) + b"".join(
        bytes([c + 1, (min(c, 1) << 4) | min(c, 1)])
        for c in range(len(grids))) + bytes([0, 63, 0])
    return (b"\xff\xd8" + apps + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDD, struct.pack(">H", restart))
            + _segment(0xDA, sos) + data + b"\xff\xd9")


def _xmp(description: str, body: str = "") -> bytes:
    packet = ('<x:xmpmeta xmlns:x="adobe:ns:meta/">'
              '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-'
              f'ns#"><rdf:Description rdf:about="" {description}'
              + (f">{body}</rdf:Description>" if body else "/>")
              + "</rdf:RDF></x:xmpmeta>")
    return _segment(0xE1, XMP_NS + packet.encode())


def gainmap_xmp(log2_max: float) -> bytes:
    """The gain map's APP1: hdrgm metadata of a map from boost 1 to
    2 ** log2_max, with no offsets and gamma 1."""
    v = f"{log2_max:.9g}"
    return _xmp(f'xmlns:hdrgm="{GAINMAP_NS}" hdrgm:Version="1.0" '
                f'hdrgm:GainMapMin="0" hdrgm:GainMapMax="{v}" '
                'hdrgm:Gamma="1" hdrgm:OffsetSDR="0" hdrgm:OffsetHDR="0" '
                f'hdrgm:HDRCapacityMin="0" hdrgm:HDRCapacityMax="{v}" '
                'hdrgm:BaseRenditionIsHDR="False"')


def primary_xmp(gainmap_length: int) -> bytes:
    """The primary's APP1: the hdrgm version and the container directory
    naming the gain map's length."""
    item = "http://ns.google.com/photos/1.0/container/"
    return _xmp(
        f'xmlns:Container="{item}" xmlns:Item="{item}item/" '
        f'xmlns:hdrgm="{GAINMAP_NS}" hdrgm:Version="1.0"',
        '<Container:Directory><rdf:Seq>'
        '<rdf:li rdf:parseType="Resource"><Container:Item '
        'Item:Semantic="Primary" Item:Mime="image/jpeg"/></rdf:li>'
        '<rdf:li rdf:parseType="Resource"><Container:Item '
        'Item:Semantic="GainMap" Item:Mime="image/jpeg" '
        f'Item:Length="{gainmap_length}"/></rdf:li>'
        '</rdf:Seq></Container:Directory>')


def gamut_colorants(gamut: str) -> np.ndarray:
    """(3, 3) rows rXYZ, gXYZ, bXYZ of a D65 gamut adapted to D50."""
    def xyz(x, y):
        return np.array([x / y, 1.0, (1 - x - y) / y])

    p = np.stack([xyz(*c) for c in PRIMARIES[gamut]], axis=1)
    m = p * np.linalg.solve(p, xyz(*D65))
    src = BRADFORD @ xyz(*D65)
    dst = BRADFORD @ np.asarray(D50)
    adapt = np.linalg.inv(BRADFORD) @ np.diag(dst / src) @ BRADFORD
    return (adapt @ m).T


def _s15(x: float) -> bytes:
    return struct.pack(">i", int(round(x * 65536.0)))


def icc_profile(colorants: np.ndarray) -> bytes:
    """An ICC v4 display profile: D50 white, the (3, 3) colorants (rows
    rXYZ, gXYZ, bXYZ) and the sRGB curve on each channel."""
    def xyz(v):
        return b"XYZ \x00\x00\x00\x00" + b"".join(_s15(c) for c in v)

    srgb = b"para\x00\x00\x00\x00\x00\x03\x00\x00" + b"".join(
        _s15(c) for c in (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045))
    text = "portbench reference".encode("utf-16-be")
    desc = (b"mluc\x00\x00\x00\x00" + struct.pack(">II", 1, 12)
            + b"enUS" + struct.pack(">II", len(text), 28) + text)
    tags = [(b"desc", desc), (b"wtpt", xyz(D50)),
            (b"rXYZ", xyz(colorants[0])), (b"gXYZ", xyz(colorants[1])),
            (b"bXYZ", xyz(colorants[2])), (b"rTRC", srgb),
            (b"gTRC", srgb), (b"bTRC", srgb)]
    offset = 128 + 4 + 12 * len(tags)
    table, blobs = b"", b""
    for sig, data in tags:
        data += b"\x00" * (-len(data) % 4)
        table += sig + struct.pack(">II", offset + len(blobs), len(data))
        blobs += data
    size = offset + len(blobs)
    header = (struct.pack(">I", size) + b"\x00" * 4
              + bytes([4, 0x30, 0, 0]) + b"mntrRGB XYZ " + b"\x00" * 12
              + b"acsp" + b"\x00" * 24 + struct.pack(">I", 0)
              + b"".join(_s15(c) for c in D50) + b"\x00" * 48)
    return header + struct.pack(">I", len(tags)) + table + blobs


def _mpf(primary_size: int, gainmap_size: int, gainmap_offset: int) -> bytes:
    """An MPF APP2 of two images, big-endian, the second's offset from
    the MPF header as CIPA DC-007 counts it."""
    entries = (struct.pack(">IIIHH", 0x030000, primary_size, 0, 0, 0)
               + struct.pack(">IIIHH", 0, gainmap_size, gainmap_offset, 0, 0))
    ifd = (struct.pack(">H", 3) + struct.pack(">HHI", 0xB000, 7, 4) + b"0100"
           + struct.pack(">HHII", 0xB001, 4, 1, 2)
           + struct.pack(">HHII", 0xB002, 7, len(entries), 8 + 2 + 36 + 4)
           + struct.pack(">I", 0))
    return _segment(0xE2, b"MPF\x00MM\x00\x2a" + struct.pack(">I", 8) + ifd
                    + entries)


def jpegr(base: bytes, gainmap: bytes, gamut: str) -> bytes:
    """A JPEG/R of a base JPEG and a gain-map JPEG (each from SOI, the
    gain map's XMP already in it), the base in `gamut`."""
    icc = icc_segment(icc_profile(gamut_colorants(gamut)))
    head = b"\xff\xd8" + primary_xmp(len(gainmap)) + icc
    mpf_len = len(_mpf(0, 0, 0))
    primary_size = len(head) + mpf_len + len(base) - 2
    mpf = _mpf(primary_size, len(gainmap), primary_size - (len(head) + 8))
    return head + mpf + base[2:] + gainmap


def icc_segment(profile: bytes) -> bytes:
    return _segment(0xE2, b"ICC_PROFILE\x00\x01\x01" + profile)


def encode_jpegr(cfg: dict, y16: np.ndarray, uv16: np.ndarray,
                 device) -> bytes:
    """The JPEG/R of one P010 frame (uint16 y (h, w), interleaved uv
    (h/2, w)) under `cfg` (gamut, transfer, quality, gainmap_quality),
    coded on `device`."""
    y = torch.from_numpy(y16.astype(np.int32)).to(device)
    uv = torch.from_numpy(uv16.astype(np.int32)).to(device)
    gmap, y8, u8, v8 = codec.encode_front(y, uv, cfg["gamut"],
                                          cfg["transfer"])
    ql = codec.quant_table(codec.STD_LUMA, cfg["quality"])
    qc = codec.quant_table(codec.STD_CHROMA, cfg["quality"])
    qg = codec.quant_table(codec.STD_LUMA, cfg["gainmap_quality"])
    h, w = y16.shape
    base = baseline_jpeg([codec.fdct_quant(p, q) for p, q in
                          ((y8, ql), (u8, qc), (v8, qc))],
                         [(2, 2), (1, 1), (1, 1)], [ql, qc], w, h)
    # encode_front maps boosts 1 to peak / SDR white onto the codes.
    log2_max = math.log2(codec.PEAK_NITS[cfg["transfer"]]
                         / codec.SDR_WHITE_NITS)
    gm = baseline_jpeg([codec.fdct_quant(gmap, qg)], [(1, 1)], [qg],
                       gmap.shape[1], gmap.shape[0],
                       apps=gainmap_xmp(log2_max))
    return jpegr(base, gm, cfg["gamut"])

