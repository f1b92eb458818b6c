"""Baseline JPEG codec: markers, MCU interleave, the native Huffman
stage, and the plain-JPEG encode and decode on the device.

The subset of libultrahdr_dev_tpu/jpeg/codec.py that the port runs.
``encode_jpeg`` encodes gray, 4:2:0, 4:2:2 or 4:4:4 planes: the edge
padding, the fDCT (kernel B2, jpeg/dct.py) and the Huffman coding run
on the device, B19 for a restart-less scan and B12-enc (B3 at any
sampling) for one with restart intervals (jpeg/device_entropy.py); the
host copies the coded scan back, stuffs it and writes the markers.
The host Huffman coder (``entropy_encode``, jpeg/entropy.cpp) writes
the same bytes and stays as the reference the kernels are held against.
``decode_jpeg`` decodes to planes: streams the
device decoder takes go through B4 then B5 on the device
(jpeg/device_decode.py:decode_jpeg_device), all others through the host
Huffman decoder then B5. Progressive, arithmetic-coded and multi-scan
streams are not decoded yet: they raise UHDR_CODEC_UNSUPPORTED_FEATURE.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..container import jfif
from ..device import resolve_device, upload
from ..types import err
from . import device_entropy as de, tables
from .dct import dequant_idct, fdct_quant
from .device_decode import decode_jpeg_device
from .native import get_lib

MAX_DIM = 8192  # jpegdecoderhelper.h:42-43
_QUEUED = "queued in ROADMAP.md Queue A, \"Off-path formats\""


def _huff_arrays(selections):
    """Pack (bits, vals) table definitions into the [4][17]/[4][256]
    arrays the native codec takes. selections: list of (bits, vals) or
    None per slot."""
    bits = np.zeros((4, 17), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for i, sel in enumerate(selections):
        if sel is None:
            continue
        b, v = tables.pack_huff_table(*sel)
        bits[i] = b
        vals[i] = v
    return bits, vals


def _as_u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def entropy_encode(blocks_zz: np.ndarray, comp_ids: np.ndarray,
                   dc_sel, ac_sel, dc_tables, ac_tables,
                   restart_interval: int, mcu_blocks: int) -> bytes:
    """Huffman-code MCU-ordered zigzag blocks into a stuffed entropy
    segment (RSTn markers included when restart_interval > 0). Counts
    its calls in ``.calls``: the device route runs no host Huffman."""
    entropy_encode.calls += 1
    lib = get_lib()
    blocks_zz = np.ascontiguousarray(blocks_zz, np.int16)
    comp_ids = np.ascontiguousarray(comp_ids, np.uint8)
    dcb, dcv = _huff_arrays(dc_tables)
    acb, acv = _huff_arrays(ac_tables)
    dc_sel = np.asarray(dc_sel, np.uint8)
    ac_sel = np.asarray(ac_sel, np.uint8)
    cap = blocks_zz.shape[0] * 64 * 4 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.uhdr_huff_encode(
        _as_i16p(blocks_zz), blocks_zz.shape[0], _as_u8p(comp_ids),
        len(dc_sel), _as_u8p(dc_sel), _as_u8p(ac_sel),
        _as_u8p(dcb), _as_u8p(dcv), _as_u8p(acb), _as_u8p(acv),
        restart_interval, mcu_blocks, _as_u8p(out), cap)
    if n < 0:
        raise err("UHDR_CODEC_ERROR", "entropy encode overflow")
    return out[:n].tobytes()


entropy_encode.calls = 0


def entropy_decode(data: bytes, nblocks: int, comp_ids: np.ndarray,
                   dc_sel, ac_sel, dc_tables, ac_tables,
                   restart_interval: int, mcu_blocks: int) -> np.ndarray:
    """Inverse of entropy_encode: int16 (nblocks, 64) zigzag blocks.
    Counts its calls in ``.calls``."""
    entropy_decode.calls += 1
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)
    comp_ids = np.ascontiguousarray(comp_ids, np.uint8)
    dcb, dcv = _huff_arrays(dc_tables)
    acb, acv = _huff_arrays(ac_tables)
    dc_sel = np.asarray(dc_sel, np.uint8)
    ac_sel = np.asarray(ac_sel, np.uint8)
    out = np.zeros((nblocks, 64), np.int16)
    rc = lib.uhdr_huff_decode(
        _as_u8p(buf), len(buf), nblocks, _as_u8p(comp_ids),
        len(dc_sel), _as_u8p(dc_sel), _as_u8p(ac_sel),
        _as_u8p(dcb), _as_u8p(dcv), _as_u8p(acb), _as_u8p(acv),
        restart_interval, mcu_blocks, _as_i16p(out))
    if rc != 0:
        raise err("UHDR_CODEC_ERROR", f"entropy decode failed at block {-rc}")
    return out


entropy_decode.calls = 0


# ---------------------------------------------------------------------------
# Encoder: markers and MCU interleave.
# ---------------------------------------------------------------------------

def _marker(m: int, payload: bytes) -> bytes:
    length = len(payload) + 2
    return bytes([0xFF, m, length >> 8, length & 0xFF]) + payload


def _dqt(tbl_id: int, q_natural: np.ndarray) -> bytes:
    zz = q_natural.reshape(64)[tables.ZIGZAG]
    return bytes([tbl_id]) + bytes(int(v) for v in zz)


def _dht(cls: int, tbl_id: int, bits, vals) -> bytes:
    return bytes([(cls << 4) | tbl_id]) + bytes(bits) + bytes(vals)


def _sof0(w: int, h: int, comps) -> bytes:
    # comps: list of (id, h_samp, v_samp, qtbl)
    out = bytes([8, h >> 8, h & 0xFF, w >> 8, w & 0xFF, len(comps)])
    for cid, hs, vs, q in comps:
        out += bytes([cid, (hs << 4) | vs, q])
    return out


def _sos(comps) -> bytes:
    # comps: list of (id, dc_tbl, ac_tbl)
    out = bytes([len(comps)])
    for cid, dc, ac in comps:
        out += bytes([cid, (dc << 4) | ac])
    out += bytes([0, 63, 0])
    return out


def _jfif_app0() -> bytes:
    return _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _interleave_ycbcr(yb, ub, vb, mcus_x: int, mcus_y: int,
                      hs: int, vs: int):
    """Build the MCU-interleaved block array for hsxvs/1x1/1x1 sampling
    (4:2:0, 4:2:2 or 4:4:4).

    yb: (mcus_y*vs, mcus_x*hs, 64) block grid; ub/vb: (mcus_y, mcus_x,
    64). Returns (blocks, comp_ids) with hs*vs+2 blocks per MCU.
    """
    n = mcus_x * mcus_y
    yl = (yb.reshape(mcus_y, vs, mcus_x, hs, 64)
          .transpose(0, 2, 1, 3, 4)          # (my, mx, vy, vx, 64)
          .reshape(n, hs * vs, 64))
    blocks = np.concatenate(
        [yl, ub.reshape(n, 1, 64), vb.reshape(n, 1, 64)], axis=1)
    comp_ids = np.tile(
        np.array([0] * (hs * vs) + [1, 2], np.uint8), n)
    return blocks.reshape(-1, 64), comp_ids


def gray_jpeg_headers(w: int, h: int, quality: int,
                      icc: bytes | None = None,
                      restart_interval: int = 0) -> bytes:
    """All markers up to (and including) SOS for a grayscale image."""
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    out = bytearray()
    out += b"\xff\xd8"
    out += _jfif_app0()
    if icc:
        out += _marker(0xE2, icc)
    out += _marker(0xDB, _dqt(0, ql))
    out += _marker(0xC0, _sof0(w, h, [(1, 1, 1, 0)]))
    out += _marker(0xC4, _dht(0, 0, tables.DC_LUMA_BITS,
                              tables.DC_LUMA_VALS))
    out += _marker(0xC4, _dht(1, 0, tables.AC_LUMA_BITS,
                              tables.AC_LUMA_VALS))
    if restart_interval:
        out += _marker(0xDD, restart_interval.to_bytes(2, "big"))
    out += _marker(0xDA, _sos([(1, 0, 0)]))
    return bytes(out)


def yuv420_jpeg_headers(w: int, h: int, quality: int,
                        icc: bytes | None = None,
                        restart_interval: int = 0) -> bytes:
    """All markers up to (and including) SOS for 4:2:0 YCbCr."""
    return ycbcr_jpeg_headers(w, h, quality, (2, 2), icc,
                              restart_interval)


def ycbcr_jpeg_headers(w: int, h: int, quality: int,
                       sampling: tuple[int, int],
                       icc: bytes | None = None,
                       restart_interval: int = 0) -> bytes:
    """All markers up to (and including) SOS for YCbCr with luma
    sampling factors `sampling` = (h, v) in {(2,2), (2,1), (1,1)}
    (4:2:0 / 4:2:2 / 4:4:4); chroma is always 1x1."""
    hs, vs = sampling
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    out = bytearray()
    out += b"\xff\xd8"
    out += _jfif_app0()
    if icc:
        out += _marker(0xE2, icc)
    out += _marker(0xDB, _dqt(0, ql))
    out += _marker(0xDB, _dqt(1, qc))
    out += _marker(0xC0, _sof0(w, h, [(1, hs, vs, 0), (2, 1, 1, 1),
                                      (3, 1, 1, 1)]))
    out += _marker(0xC4, _dht(0, 0, tables.DC_LUMA_BITS,
                              tables.DC_LUMA_VALS))
    out += _marker(0xC4, _dht(1, 0, tables.AC_LUMA_BITS,
                              tables.AC_LUMA_VALS))
    out += _marker(0xC4, _dht(0, 1, tables.DC_CHROMA_BITS,
                              tables.DC_CHROMA_VALS))
    out += _marker(0xC4, _dht(1, 1, tables.AC_CHROMA_BITS,
                              tables.AC_CHROMA_VALS))
    if restart_interval:
        out += _marker(0xDD, restart_interval.to_bytes(2, "big"))
    out += _marker(0xDA, _sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]))
    return bytes(out)


def encode_ycbcr_scan(yz: np.ndarray, uz: np.ndarray, vz: np.ndarray,
                      mcus_x: int, mcus_y: int, sampling: tuple[int, int],
                      restart_interval: int) -> bytes:
    """Entropy segment of a YCbCr frame of mcus_x x mcus_y MCUs at luma
    sampling `sampling` = (hs, vs): yz is the (mcus_y*vs * mcus_x*hs,
    64) luma block grid, uz/vz the (mcus_y * mcus_x, 64) chroma grids."""
    hs, vs = sampling
    blocks, comp_ids = _interleave_ycbcr(
        yz.reshape(mcus_y * vs, mcus_x * hs, 64),
        uz.reshape(mcus_y, mcus_x, 64), vz.reshape(mcus_y, mcus_x, 64),
        mcus_x, mcus_y, hs, vs)
    return entropy_encode(
        blocks, comp_ids, [0, 1, 1], [0, 1, 1],
        [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
         (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)],
        [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
         (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)],
        restart_interval, hs * vs + 2)


def encode_yuv420_scan(yz: np.ndarray, uz: np.ndarray, vz: np.ndarray,
                       w: int, h: int, restart_interval: int) -> bytes:
    """Entropy segment of a 4:2:0 frame with 16-aligned dims: yz is the
    (h/8 * w/8, 64) luma block grid, uz/vz the chroma grids."""
    return encode_ycbcr_scan(yz, uz, vz, w // 16, h // 16, (2, 2),
                             restart_interval)


def encode_gray_scan(gz: np.ndarray, restart_interval: int) -> bytes:
    """Entropy segment of a grayscale frame from its block grid."""
    return entropy_encode(
        gz, np.zeros(gz.shape[0], np.uint8), [0], [0],
        [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)],
        [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)],
        restart_interval, 1)


# ---------------------------------------------------------------------------
# encode_jpeg: padding, fDCT and Huffman coding on the device
# (codec.py:326-528).
# ---------------------------------------------------------------------------

_QUEUED_ARITH = ("arithmetic coding in encode_jpeg is queued in ROADMAP.md "
                 "Queue A, \"Off-path formats\"")


def _align(x: int, m: int) -> int:
    return -(-x // m) * m


def _infer_sampling(y_shape, u_shape) -> tuple[int, int]:
    """Luma sampling factors from the chroma plane's size relative to
    luma: (2,2)=4:2:0, (2,1)=4:2:2, (1,1)=4:4:4. For odd luma dims both
    ceil-half and floor-half chroma planes count as subsampled (the
    missing row/column is edge-padded)."""
    h, w = y_shape
    ch, cw = u_shape
    hs = (2 if w > 1 and cw in ((w + 1) // 2, w // 2)
          else 1 if cw == w else 0)
    vs = (2 if h > 1 and ch in ((h + 1) // 2, h // 2)
          else 1 if ch == h else 0)
    if not hs or not vs or (hs, vs) == (1, 2):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"unsupported chroma geometry {cw}x{ch} for luma "
                  f"{w}x{h} (expected 4:2:0, 4:2:2 or 4:4:4)")
    return hs, vs


def _edge_pad(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(h, w) plane edge-replicated to (ph, pw), on its device."""
    h, w = p.shape
    if (ph, pw) == (h, w):
        return p
    rows = torch.clamp(torch.arange(ph, device=p.device), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=p.device), max=w - 1)
    return p.index_select(0, rows).index_select(1, cols)


@dataclass
class JpegCoefs:
    """encode_jpeg's device stage output: the quantized zigzag blocks of
    each component (int16 tensors (1, nblocks, 64) on the device: the
    MCU-aligned luma plane, the chroma planes padded to cover it), with
    the image size, the quality they were quantized at and the luma
    sampling (None for gray)."""

    width: int
    height: int
    quality: int
    sampling: tuple[int, int] | None
    coefs: list


def jpeg_coefs(planes: dict, quality: int,
               sampling: tuple[int, int] | None = None,
               device="cuda") -> JpegCoefs:
    """The device stage of encode_jpeg: YCbCr planes {y, u, v} or
    grayscale {y} (2-D uint8 numpy arrays or tensors) on their device
    (tensors) or `device` (numpy), edge-padded as the JAX package pads
    them (codec.py:495-526: luma to whole MCUs, chroma to cover the
    padded luma, gray to 8), then B2 (jpeg/dct.py:fdct_quant)."""
    y = planes["y"]
    dev = y.device if isinstance(y, torch.Tensor) else resolve_device(device)

    def on_dev(p):
        if isinstance(p, torch.Tensor):
            return p.to(dev, torch.uint8)
        return torch.from_numpy(np.ascontiguousarray(p, np.uint8)).to(dev)

    y = on_dev(y)
    h, w = y.shape
    if h > MAX_DIM or w > MAX_DIM:
        raise err("UHDR_CODEC_INVALID_PARAM", f"dims too large {w}x{h}")

    def dct(p, std):
        q = tables.scale_quant_table(std, quality).reshape(64)
        return fdct_quant(p.contiguous()[None],
                          torch.from_numpy(q.astype(np.int32)).to(dev))

    if "u" not in planes:   # B2 pads to 8 itself
        return JpegCoefs(w, h, quality, None,
                         [dct(y, tables.STD_LUMINANCE_QUANT)])
    u, v = on_dev(planes["u"]), on_dev(planes["v"])
    if u.shape != v.shape:
        raise err("UHDR_CODEC_INVALID_PARAM", "u/v shape mismatch")
    hs, vs = _infer_sampling((h, w), tuple(u.shape))
    if sampling is not None and tuple(sampling) != (hs, vs):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"requested sampling {tuple(sampling)} inconsistent "
                  f"with plane geometry (implies {(hs, vs)})")
    yp_h, yp_w = _align(h, 8 * vs), _align(w, 8 * hs)
    # Chroma covers the padded luma at its sampling: whole 8x8 blocks.
    ch, cw = yp_h // vs, yp_w // hs
    coefs = [dct(_edge_pad(y, yp_h, yp_w), tables.STD_LUMINANCE_QUANT)]
    coefs += [dct(_edge_pad(c, ch, cw), tables.STD_CHROMINANCE_QUANT)
              for c in (u, v)]
    return JpegCoefs(w, h, quality, (hs, vs), coefs)


def entropy_stage(c: JpegCoefs, restart_interval: int = 0):
    """The Huffman coding of encode_jpeg, on the blocks' device: B19
    for a restart-less scan -> (stream bytes uint8, (1,) int64 bits);
    with restart intervals B12-enc, B3 at the image's sampling (the JAX
    _device_rst_entropy, codec.py:326) -> (stream bytes uint8, (1, nc)
    int32 chunk bits). Counts its B12-enc calls on CUDA tensors in
    ``.rst_launches``."""
    if c.sampling is None:
        (gz,) = c.coefs
        if restart_interval:
            out = de.encode_gray_rst_stream(gz, restart_interval)
        else:
            out = de.encode_gray_stream(gz)
    else:
        hs, vs = c.sampling
        mcus = (-(-c.width // (8 * hs)), -(-c.height // (8 * vs)))
        if restart_interval:
            out = de.encode_ycbcr_rst_stream(*c.coefs, *mcus,
                                             restart_interval, c.sampling)
        else:
            out = de.encode_ycbcr_stream(*c.coefs, *mcus, c.sampling)
    if restart_interval and c.coefs[0].is_cuda:
        entropy_stage.rst_launches += 1
    return out


entropy_stage.rst_launches = 0


def assemble_jpeg(c: JpegCoefs, icc: bytes | None = None,
                  restart_interval: int = 0) -> bytes:
    """The entropy and host stages of encode_jpeg: entropy_stage, the
    coded scan and its bit counts to the host in one copy, then the JAX
    package's host tail (restart-less: _finalize's trim, 1-pad and
    stuffing; with restart intervals: finalize_rst_stream's stuffing
    and RSTn markers) and the markers (a DRI with restart intervals)."""
    stream, bits = entropy_stage(c, restart_interval)
    host = torch.cat([stream, bits.reshape(-1).view(torch.uint8)]
                     ).cpu().numpy()
    data = host[:stream.numel()]
    b = host[stream.numel():].copy().view(
        np.int64 if bits.dtype == torch.int64 else np.int32)
    if restart_interval:
        scan = de.finalize_rst_stream(data, b)
    else:
        scan = de.finalize_stream(data, b[0])
    if c.sampling is None:
        head = gray_jpeg_headers(c.width, c.height, c.quality, icc,
                                 restart_interval)
    else:
        head = ycbcr_jpeg_headers(c.width, c.height, c.quality, c.sampling,
                                  icc, restart_interval)
    return head + scan + b"\xff\xd9"


def encode_jpeg(planes: dict, quality: int, icc: bytes | None = None,
                restart_interval: int = 0,
                sampling: tuple[int, int] | None = None,
                arithmetic: bool = False, device="cuda") -> bytes:
    """Encode YCbCr planes {y, u, v} or grayscale {y} (2-D uint8 numpy
    arrays or tensors) to baseline JFIF, as the JAX package's
    encode_jpeg does (codec.py:479-528): chroma subsampling inferred
    from the chroma planes' shape (4:2:0, 4:2:2, 4:4:4) unless
    `sampling` pins it, ICC as one APP2 after APP0, a restart marker
    every `restart_interval` MCUs when it is not 0. Tensor planes are
    encoded on their device, numpy planes on `device`: the padding, the
    fDCT (B2, jpeg_coefs) and the Huffman coding (B19 or B12-enc,
    entropy_stage) there, the stuffing and markers on the host
    (assemble_jpeg). The JAX package Huffman-codes on the host below
    1 MP or off an accelerator (codec.py:375-393, 429-435), a dispatch
    rule of the TPU; its bytes are the same either way."""
    if arithmetic:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE", _QUEUED_ARITH)
    return assemble_jpeg(jpeg_coefs(planes, quality, sampling, device), icc,
                         restart_interval)


# ---------------------------------------------------------------------------
# Decoder: marker parse + native Huffman decode + MCU de-interleave.
# ---------------------------------------------------------------------------

@dataclass
class _Component:
    cid: int
    h: int
    v: int
    qtbl: int
    dc_tbl: int = 0
    ac_tbl: int = 0


@dataclass
class DecodedCoefs:
    """Entropy-decoded (host) stage output: per-component zigzag
    coefficient block grids, ready for device dequant/IDCT."""

    width: int
    height: int
    ncomp: int
    # per component: (coefs (bh, bw, 64) int16 zigzag, qtable 8x8,
    #                 crop_h, crop_w, (h_samp, v_samp))
    comps: list = field(default_factory=list)
    icc: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None


def _parse_dht(payload: bytes, dc_tables: dict, ac_tables: dict):
    """Parse one DHT payload with full validation — the native table
    builder trusts bits[]/vals[] shapes, so corrupt definitions
    (sum(bits) > 256, truncated vals, non-canonical code counts) must
    be rejected here, not segfault there."""
    pos = 0
    while pos < len(payload):
        tc, th = payload[pos] >> 4, payload[pos] & 15
        pos += 1
        if tc > 1 or th > 3 or pos + 16 > len(payload):
            raise err("UHDR_CODEC_ERROR", "bad DHT header")
        bits = list(payload[pos:pos + 16])
        pos += 16
        nvals = sum(bits)
        if nvals > 256 or pos + nvals > len(payload):
            raise err("UHDR_CODEC_ERROR", "bad DHT code counts")
        code = 0
        for length in range(1, 17):
            code += bits[length - 1]
            if code > (1 << length):
                raise err("UHDR_CODEC_ERROR",
                          "non-canonical DHT code counts")
            code <<= 1
        vals = list(payload[pos:pos + nvals])
        pos += nvals
        (dc_tables if tc == 0 else ac_tables)[th] = (bits, vals)


def _read_sof(p: bytes):
    if len(p) < 6 or len(p) < 6 + p[5] * 3:
        raise err("UHDR_CODEC_ERROR", "truncated SOF header")
    h = (p[1] << 8) | p[2]
    w = (p[3] << 8) | p[4]
    comps = [_Component(p[6 + i * 3], p[7 + i * 3] >> 4,
                        p[7 + i * 3] & 15, p[8 + i * 3])
             for i in range(p[5])]
    return w, h, comps


def decode_jpeg_coefs(data: bytes) -> DecodedCoefs:
    """Host stage of decode for baseline single-scan Huffman JPEGs:
    marker parse + native Huffman decode + MCU de-interleave. No device
    work — the caller runs dequant/IDCT (jpeg/dct.py) on the grids."""
    segments, sos_end = jfif.scan_segments(data, 0)
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    comps: list[_Component] = []
    w = h = 0
    restart_interval = 0
    result = DecodedCoefs(0, 0, 0)
    scan_comps: list[int] = []

    for seg in segments:
        if seg.marker == 0xDB:  # DQT
            p = seg.payload
            pos = 0
            while pos < len(p):
                pq, tq = p[pos] >> 4, p[pos] & 15
                pos += 1
                if pq == 0:
                    zz = np.frombuffer(p[pos:pos + 64], np.uint8)
                    pos += 64
                else:
                    zz = np.frombuffer(p[pos:pos + 128], ">u2")
                    pos += 128
                nat = np.zeros(64, np.int32)
                nat[tables.ZIGZAG] = zz
                qtables[tq] = nat.reshape(8, 8)
        elif seg.marker == 0xC4:  # DHT
            _parse_dht(seg.payload, dc_tables, ac_tables)
        elif seg.marker in (0xC0, 0xC1):  # SOF0/1 baseline(-ish)
            w, h, comps = _read_sof(seg.payload)
        elif seg.marker in (0xC2, 0xC9, 0xCA):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"progressive/arithmetic SOF {seg.marker:#x} is "
                      f"{_QUEUED}")
        elif seg.marker in set(range(0xC3, 0xD0)) - {0xC4, 0xC8, 0xCC}:
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"SOF marker {seg.marker:#x} not supported")
        elif seg.marker == 0xDD:  # DRI
            restart_interval = int.from_bytes(seg.payload[:2], "big")
        elif seg.marker == 0xDA:  # SOS
            p = seg.payload
            if len(p) < 1 or len(p) < 1 + p[0] * 2:
                raise err("UHDR_CODEC_ERROR", "truncated SOS header")
            scan_comps = []
            for i in range(p[0]):
                cid, sel = p[1 + i * 2], p[2 + i * 2]
                for c in comps:
                    if c.cid == cid:
                        c.dc_tbl, c.ac_tbl = sel >> 4, sel & 15
                        scan_comps.append(comps.index(c))
        elif seg.marker == 0xE1:
            if seg.payload.startswith(jfif.EXIF_SIG) and result.exif is None:
                result.exif = seg.payload
            elif seg.payload.startswith(jfif.XMP_SIG) and result.xmp is None:
                result.xmp = seg.payload
        elif seg.marker == 0xE2:
            if seg.payload.startswith(jfif.ICC_SIG) and result.icc is None:
                result.icc = seg.payload

    if not comps or w == 0 or h == 0:
        raise err("UHDR_CODEC_ERROR", "no frame header found")
    if w > MAX_DIM or h > MAX_DIM:
        raise err("UHDR_CODEC_ERROR", f"image too large {w}x{h}")
    if len(scan_comps) != len(comps):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"multi-scan baseline JPEG is {_QUEUED}")

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))

    if len(comps) == 1:
        # Non-interleaved single-component scan: MCU = one block.
        bw = -(-w // 8)
        bh = -(-h // 8)
        nblocks = bw * bh
        comp_ids = np.zeros(nblocks, np.uint8)
        mcu_blocks = 1
    else:
        mcu_blocks = sum(c.h * c.v for c in comps)
        nblocks = mcus_x * mcus_y * mcu_blocks
        pattern = []
        for i, c in enumerate(comps):
            pattern += [i] * (c.h * c.v)
        comp_ids = np.tile(np.asarray(pattern, np.uint8), mcus_x * mcus_y)

    dc_sel = [c.dc_tbl for c in comps]
    ac_sel = [c.ac_tbl for c in comps]

    def table_list(src: dict, sels):
        out = [None] * 4
        for s in sels:
            if s not in src:
                raise err("UHDR_CODEC_ERROR", f"missing huffman table {s}")
            out[s] = src[s]
        return out

    blocks = entropy_decode(
        data[sos_end:], nblocks, comp_ids, dc_sel, ac_sel,
        table_list(dc_tables, dc_sel), table_list(ac_tables, ac_sel),
        restart_interval, mcu_blocks)

    result.width, result.height, result.ncomp = w, h, len(comps)
    for c in comps:
        if c.qtbl not in qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")

    if len(comps) == 1:
        c = comps[0]
        result.comps = [(blocks.reshape(bh, bw, 64), qtables[c.qtbl],
                         h, w, (c.h, c.v))]
        return result

    # De-interleave per component.
    grid = blocks.reshape(mcus_y, mcus_x, mcu_blocks, 64)
    off = 0
    for c in comps:
        nb = c.h * c.v
        sub = grid[:, :, off:off + nb, :].reshape(mcus_y, mcus_x, c.v, c.h,
                                                  64)
        sub = sub.transpose(0, 2, 1, 3, 4).reshape(mcus_y * c.v,
                                                   mcus_x * c.h, 64)
        off += nb
        cw = -(-w * c.h // hmax)
        ch = -(-h * c.v // vmax)
        result.comps.append((sub, qtables[c.qtbl], ch, cw, (c.h, c.v)))
    return result


# ---------------------------------------------------------------------------
# decode_jpeg: planes on the device (codec.py:1278-1348).
# ---------------------------------------------------------------------------

@dataclass
class DecodedJpeg:
    """A JPEG decoded to its component planes at their natural sizes
    (no chroma upsampling): uint8 (h, w) tensors on the decode's device,
    with each component's (h, v) sampling factors."""

    width: int
    height: int
    ncomp: int
    planes: list = field(default_factory=list)
    sampling: list = field(default_factory=list)
    icc: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None


def decode_jpeg(data: bytes, device="cuda") -> DecodedJpeg:
    """Decode a baseline JPEG to per-component planes on `device` (the
    JAX decode_jpeg; JPEG/R's API-3 reads the 4:2:0 planes directly, as
    the reference's jpeg_read_raw_data path does). The route is chosen
    from the headers alone: streams that jpeg/device_decode.py:
    parse_device_stream takes (one baseline scan, gray or 4:2:0 / 4:2:2
    / 4:4:4, restart markers or not) decode on the device as B4 then B5,
    each component with its own quant table; all others through the
    host Huffman decoder (decode_jpeg_coefs) then B5, which raises the
    reference's errors for what it cannot decode. No size gate: the
    JAX package's 1-MP gate is a TPU cost heuristic, and both routes
    give the same planes."""
    dev = resolve_device(device)
    res = decode_jpeg_device(data, dev)
    if res is not None:
        ds, planes = res
        w, h = ds.width, ds.height
        result = DecodedJpeg(w, h, 1 if ds.gray else 3, icc=ds.icc,
                             exif=ds.exif, xmp=ds.xmp)
        if ds.gray:
            crops, samps = [(h, w)], [(1, 1)]
        else:
            hs, vs = ds.sampling
            ch, cw = -(-h // vs), -(-w // hs)
            crops = [(h, w), (ch, cw), (ch, cw)]
            samps = [ds.sampling, (1, 1), (1, 1)]
        for plane, (ph, pw), samp in zip(planes, crops, samps):
            result.planes.append(plane[0, :ph, :pw].contiguous())
            result.sampling.append(samp)
        return result
    coefs = decode_jpeg_coefs(data)
    result = DecodedJpeg(coefs.width, coefs.height, coefs.ncomp,
                         icc=coefs.icc, exif=coefs.exif, xmp=coefs.xmp)
    grids = upload([g.reshape(1, -1, 64) for g, *_ in coefs.comps]
                   + [np.stack([q.reshape(64) for _, q, *_ in coefs.comps])
                      .astype(np.int32)], dev)
    qd = grids.pop()
    for k, (grid, (g, _, ch, cw, samp)) in enumerate(zip(grids,
                                                          coefs.comps)):
        plane = dequant_idct(grid, qd[k:k + 1], g.shape[0], g.shape[1])
        result.planes.append(plane[0, :ch, :cw].contiguous())
        result.sampling.append(samp)
    return result
