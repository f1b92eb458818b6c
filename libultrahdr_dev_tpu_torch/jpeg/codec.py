"""JPEG codec: markers, MCU interleave, the native entropy stages, and
the plain-JPEG encode and decode on the device.

The port's copy of libultrahdr_dev_tpu/jpeg/codec.py. ``encode_jpeg``
encodes gray, 4:2:0, 4:2:2 or 4:4:4 planes: the edge padding, the fDCT
(kernel B2, jpeg/dct.py) and the Huffman coding run on the device, B19
for a restart-less scan and B12-enc (B3 at any sampling) for one with
restart intervals (jpeg/device_entropy.py); the host copies the coded
scan back, stuffs it and writes the markers. The host Huffman coder
(``entropy_encode``, jpeg/entropy.cpp) writes the same bytes and stays
as the reference the kernels are held against. With ``arithmetic=True``
the quantized blocks come to the host in one copy after B2 and the QM
coder (jpeg/arith.py, jpeg/arith.cpp) codes them there, as the JAX
package does (SOF9 with a DAC segment).
``decode_jpeg`` decodes to planes: streams the device decoder takes go
through B4 then B5 on the device (jpeg/device_decode.py:
decode_jpeg_device), all others through the host entropy decoder then
B5: one-scan baseline Huffman through jpeg/entropy.cpp's decoder;
progressive (SOF2), arithmetic-coded (SOF9, SOF10) and multi-scan
baseline streams scan by scan (``_decode_multiscan``: entropy.cpp's
progressive scan decoders, arith.py's QM decoders), the progressive
Huffman scans on several threads where their components allow.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device, upload
from ..types import err
from ..utils.workers import worker_count
from . import arith as ar, device_entropy as de, headers, tables
from .dct import dequant_idct, fdct_quant
from .device_decode import decode_jpeg_device
from .native import get_lib

MAX_DIM = 8192  # jpegdecoderhelper.h:42-43


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
                      restart_interval: int = 0,
                      arithmetic: bool = False) -> bytes:
    """All markers up to (and including) SOS for a grayscale image
    (SOF9 and a DAC segment of the default conditioning when
    `arithmetic`)."""
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    out = bytearray()
    out += b"\xff\xd8"
    out += _jfif_app0()
    if icc:
        out += _marker(0xE2, icc)
    out += _marker(0xDB, _dqt(0, ql))
    if arithmetic:
        out += _marker(0xC9, _sof0(w, h, [(1, 1, 1, 0)]))
        out += _marker(0xCC, bytes([0x00, 0x10, 0x10, 5]))
    else:
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
                       restart_interval: int = 0,
                       arithmetic: bool = False) -> bytes:
    """All markers up to (and including) SOS for YCbCr with luma
    sampling factors `sampling` = (h, v) in {(2,2), (2,1), (1,1)}
    (4:2:0 / 4:2:2 / 4:4:4); chroma is always 1x1. SOF9 and a DAC
    segment of the default conditioning when `arithmetic`."""
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
    sof = _sof0(w, h, [(1, hs, vs, 0), (2, 1, 1, 1), (3, 1, 1, 1)])
    if arithmetic:
        out += _marker(0xC9, sof)
        out += _marker(0xCC, bytes([0x00, 0x10, 0x01, 0x10,
                                    0x10, 5, 0x11, 5]))
    else:
        out += _marker(0xC0, sof)
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
# encode_jpeg: padding, fDCT and Huffman coding on the device, or the
# arithmetic coding on the host (codec.py:326-528).
# ---------------------------------------------------------------------------


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


def coefs_to_host(c: JpegCoefs) -> list:
    """The arithmetic encode's one device-to-host copy: each component's
    quantized zigzag blocks as an int16 (nblocks, 64) numpy array."""
    sizes = [g.numel() for g in c.coefs]
    host = torch.cat([g.reshape(-1) for g in c.coefs]).cpu().numpy()
    return [a.reshape(-1, 64)
            for a in np.split(host, np.cumsum(sizes)[:-1])]


def interleave_coefs(c: JpegCoefs, host: list):
    """The scan's blocks in MCU order, as the JAX assemble_gray_jpeg /
    assemble_ycbcr_jpeg order them (codec.py:365-453): -> (blocks,
    comp_ids, blocks per MCU)."""
    if c.sampling is None:
        (yz,) = host
        return yz, np.zeros(yz.shape[0], np.uint8), 1
    hs, vs = c.sampling
    mx, my = -(-c.width // (8 * hs)), -(-c.height // (8 * vs))
    yz, uz, vz = host
    blocks, comp_ids = _interleave_ycbcr(
        yz.reshape(my * vs, mx * hs, 64), uz.reshape(my, mx, 64),
        vz.reshape(my, mx, 64), mx, my, hs, vs)
    return blocks, comp_ids, hs * vs + 2


def arith_scan(blocks: np.ndarray, comp_ids: np.ndarray, gray: bool,
               restart_interval: int, mcu_blocks: int) -> bytes:
    """The arithmetic-coded entropy segment of MCU-ordered blocks with
    the default conditioning (the DAC segment the headers write), on
    the host (jpeg/arith.py:encode_seq_scan)."""
    blocks = np.ascontiguousarray(blocks, np.int16)
    if gray:
        return ar.encode_seq_scan(blocks, comp_ids, [0], [0],
                                  {0: ar.DEFAULT_DC_COND},
                                  {0: ar.DEFAULT_AC_COND},
                                  restart_interval, 1)
    return ar.encode_seq_scan(
        blocks, comp_ids, [0, 1, 1], [0, 1, 1],
        {0: ar.DEFAULT_DC_COND, 1: ar.DEFAULT_DC_COND},
        {0: ar.DEFAULT_AC_COND, 1: ar.DEFAULT_AC_COND},
        restart_interval, mcu_blocks)


def _headers(c: JpegCoefs, icc, restart_interval: int,
             arithmetic: bool) -> bytes:
    if c.sampling is None:
        return gray_jpeg_headers(c.width, c.height, c.quality, icc,
                                 restart_interval, arithmetic)
    return ycbcr_jpeg_headers(c.width, c.height, c.quality, c.sampling,
                              icc, restart_interval, arithmetic)


def assemble_jpeg(c: JpegCoefs, icc: bytes | None = None,
                  restart_interval: int = 0,
                  arithmetic: bool = False) -> bytes:
    """The entropy and host stages of encode_jpeg: entropy_stage, the
    coded scan and its bit counts to the host in one copy, then the JAX
    package's host tail (restart-less: _finalize's trim, 1-pad and
    stuffing; with restart intervals: finalize_rst_stream's stuffing
    and RSTn markers) and the markers (a DRI with restart intervals).
    With `arithmetic`: the blocks to the host in one copy
    (coefs_to_host), the MCU interleave (interleave_coefs) and the QM
    coder (arith_scan) there."""
    if arithmetic:
        blocks, comp_ids, mcu_blocks = interleave_coefs(c, coefs_to_host(c))
        scan = arith_scan(blocks, comp_ids, c.sampling is None,
                          restart_interval, mcu_blocks)
        return (_headers(c, icc, restart_interval, True) + scan
                + b"\xff\xd9")
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
    return _headers(c, icc, restart_interval, False) + scan + b"\xff\xd9"


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
    rule of the TPU; its bytes are the same either way. `arithmetic`
    writes SOF9 and a DAC segment and codes the scan with the QM coder
    on the host, after B2 (assemble_jpeg)."""
    return assemble_jpeg(jpeg_coefs(planes, quality, sampling, device), icc,
                         restart_interval, arithmetic)


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


def decode_jpeg_coefs(data) -> DecodedCoefs:
    """Host stage of decode: the host decoder's rule on a JPEG's headers
    (bytes, or its JpegHeaders; the first fault raises), native entropy
    decode and MCU de-interleave (the JAX decode_jpeg_coefs,
    codec.py:602-770). One-scan baseline Huffman streams decode in one
    call of jpeg/entropy.cpp's decoder; progressive (SOF2),
    arithmetic-coded (SOF9, SOF10) and multi-scan baseline streams scan
    by scan (_decode_multiscan). No device work — the caller runs
    dequant/IDCT (jpeg/dct.py) on the grids."""
    hdr = headers.of(data)
    if hdr.faults:
        raise hdr.faults[0].error
    if hdr.sos is not None and hdr.scan is None:
        raise err("UHDR_CODEC_ERROR", "truncated SOS header")
    comps: list[_Component] = []
    w = h = 0
    progressive = arith = False
    for f in hdr.frames:  # SOF0-2, SOF9-10: any other is a fault above
        w, h = f.width, f.height
        comps = [_Component(*c) for c in f.comps]
        if f.marker in (0xC2, 0xC9, 0xCA):
            progressive = f.marker in (0xC2, 0xCA)
            arith = f.marker in (0xC9, 0xCA)
    scan_comps: list[int] = []
    for cid, dc_tbl, ac_tbl in hdr.scan or ():
        for c in comps:
            if c.cid == cid:
                c.dc_tbl, c.ac_tbl = dc_tbl, ac_tbl
                scan_comps.append(comps.index(c))
    result = DecodedCoefs(0, 0, 0, icc=hdr.icc_chunk, exif=hdr.exif,
                          xmp=hdr.xmp)

    if not comps or w == 0 or h == 0:
        raise err("UHDR_CODEC_ERROR", "no frame header found")
    if w > MAX_DIM or h > MAX_DIM:
        raise err("UHDR_CODEC_ERROR", f"image too large {w}x{h}")
    if progressive or arith or len(scan_comps) != len(comps):
        # Arithmetic files (even single-scan sequential) take the
        # scan-by-scan walk so DAC markers between scans are honoured;
        # a multi-scan baseline file (several SOS, each covering a
        # component subset, T.81 A.2) decodes scan by scan too.
        result.width, result.height = w, h
        return _decode_multiscan(hdr, result, comps, w, h, progressive,
                                 arith)

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
    dc_tables, ac_tables = hdr.huffman
    blocks = entropy_decode(
        hdr.image[hdr.sos_end:], nblocks, comp_ids, dc_sel, ac_sel,
        _table_list(dc_tables, dc_sel), _table_list(ac_tables, ac_sel),
        hdr.restart_interval, mcu_blocks)

    result.width, result.height, result.ncomp = w, h, len(comps)
    for c in comps:
        if c.qtbl not in hdr.qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")

    if len(comps) == 1:
        c = comps[0]
        result.comps = [(blocks.reshape(bh, bw, 64), hdr.qtables[c.qtbl],
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
        result.comps.append((sub, hdr.qtables[c.qtbl], ch, cw, (c.h, c.v)))
    return result


def _table_list(src: dict, sels):
    """The native codec's four table slots: those `sels` select."""
    out = [None] * 4
    for s in sels:
        if s not in src:
            raise err("UHDR_CODEC_ERROR", f"missing huffman table {s}")
        out[s] = src[s]
    return out


# ---------------------------------------------------------------------------
# Progressive (SOF2, SOF10), arithmetic (SOF9) and multi-scan baseline
# decoding: multi-scan orchestration over the native per-scan decoders
# (T.81 Annex G.2; the JAX codec.py:778-1270). The reference inherits
# these from libjpeg (jpegdecoderhelper.cpp uses the full jpeg_read_*
# API); here each scan refines per-component coefficient grids on the
# host and the dequant/IDCT (B5) runs on the device.
# ---------------------------------------------------------------------------

def _entropy_end(data: bytes, start: int) -> int:
    """Offset of the first real marker after entropy data at start.

    Fully vectorized: inside entropy data the second byte of any
    FF-pair is never 0xFF (stuffing pairs are FF 00, restarts FF Dn,
    fill runs chain FF FF.. until the marker byte), so the first 0xFF
    whose successor is not {00, D0-D7, FF} IS the next real marker —
    no left-to-right overlap resolution needed (same argument as
    jpeg/headers.py find_eoi_marker)."""
    arr = np.frombuffer(data, np.uint8)
    cand = np.flatnonzero(arr[start:len(data) - 1] == 0xFF) + start
    nxt = arr[cand + 1]
    real = cand[(nxt != 0x00) & (nxt != 0xFF)
                & ~((nxt >= 0xD0) & (nxt <= 0xD7))]
    return int(real[0]) if real.size else len(data)


def _parse_dac(payload: bytes, dc_cond: dict, ac_cond: dict):
    """DAC marker (T.81 B.2.4.3): per table class/slot one
    conditioning byte — DC: L = low nibble, U = high nibble
    (0 <= L <= U <= 15); AC: Kx in [1, 63]."""
    pos = 0
    while pos + 1 < len(payload):
        tc, tb = payload[pos] >> 4, payload[pos] & 15
        cs = payload[pos + 1]
        pos += 2
        if tc > 1 or tb > 3:
            raise err("UHDR_CODEC_ERROR", "bad DAC header")
        if tc == 0:
            low, up = cs & 15, cs >> 4
            if low > up:
                raise err("UHDR_CODEC_ERROR",
                          f"bad DC conditioning L={low} U={up}")
            dc_cond[tb] = (low, up)
        else:
            if not 1 <= cs <= 63:
                raise err("UHDR_CODEC_ERROR", f"bad AC conditioning {cs}")
            ac_cond[tb] = cs
    if pos != len(payload):
        # A dangling odd byte is a truncated conditioning entry; the
        # reference's libjpeg errors on a bogus DAC segment length
        # rather than decoding with default conditioning.
        raise err("UHDR_CODEC_ERROR", "truncated DAC segment")


def _decode_multiscan(hdr: headers.JpegHeaders, result: DecodedCoefs,
                      comps: list, w: int, h: int, progressive: bool,
                      arith: bool = False) -> DecodedCoefs:
    """Run all scans of a progressive (SOF2/SOF10), multi-scan
    baseline, or arithmetic-coded (SOF9/SOF10) JPEG into
    per-component grids: the first from the image's headers, then
    the walk between scans, whose segments may redefine tables."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    if len(comps) == 1:
        grid_dims = [(-(-h // 8), -(-w // 8))]
    else:
        grid_dims = [(mcus_y * c.v, mcus_x * c.h) for c in comps]
    grids = [np.zeros((gh, gw, 64), np.int16) for gh, gw in grid_dims]

    qtables = dict(hdr.qtables)
    dc_tables, ac_tables = (dict(t) for t in hdr.huffman)
    dc_cond: dict[int, tuple] = {}   # arith DC (L, U) per slot
    ac_cond: dict[int, int] = {}     # arith AC Kx per slot
    for seg in hdr.segments:
        if seg.marker == 0xCC:  # DAC (arith conditioning)
            _parse_dac(seg.payload, dc_cond, ac_cond)
    restart = hdr.restart_interval
    # Cross-scan threading (Huffman progressive only): scans touching
    # disjoint (component, spectral band) state are data-independent
    # — AC scans write only their own component's band, DC scans only
    # band [0,0] — so on a multi-core host they run concurrently
    # (ctypes releases the GIL during the native scan decoders). The
    # reference gets its ingest throughput from libjpeg-turbo's SIMD
    # serial decode; this is the multi-core analog.
    prog_tasks = [] if (progressive and not arith
                        and _scan_threads() > 1) else None
    data = hdr.image
    n = len(data)

    def run_scan(payload, e0: int) -> int:
        """Decode (or defer) one scan; returns where its data ends."""
        if len(payload) < 1:
            raise err("UHDR_CODEC_ERROR", "truncated SOS")
        ns = payload[0]
        # Bound-check everything the scan decoders trust: corrupt
        # spectral params (se > 63) would otherwise drive
        # out-of-bounds coefficient writes in the native decoder.
        if not 1 <= ns <= 4 or len(payload) < 4 + ns * 2:
            raise err("UHDR_CODEC_ERROR", f"bad SOS ns={ns}")
        scan = []
        for i in range(ns):
            cid, sel = payload[1 + i * 2], payload[2 + i * 2]
            matches = [i2 for i2, c in enumerate(comps) if c.cid == cid]
            if not matches:
                raise err("UHDR_CODEC_ERROR",
                          f"SOS references unknown component {cid}")
            if (sel >> 4) > 3 or (sel & 15) > 3:
                raise err("UHDR_CODEC_ERROR", f"bad table selector {sel:#x}")
            scan.append((matches[0], sel >> 4, sel & 15))
        ss, se = payload[1 + ns * 2], payload[2 + ns * 2]
        a = payload[3 + ns * 2]
        ah, al = a >> 4, a & 15
        if not (ss <= se <= 63 and ah <= 13 and al <= 13):
            raise err("UHDR_CODEC_ERROR",
                      f"bad spectral selection {ss}..{se} ah={ah} al={al}")
        e1 = _entropy_end(data, e0)
        entropy = np.frombuffer(data, np.uint8, count=e1 - e0, offset=e0)
        arith_cond = (dc_cond, ac_cond) if arith else None
        if progressive and prog_tasks is not None:
            # Deferred for the cross-scan thread scheduler below.
            # Tables/restart can be redefined between scans, so each
            # task snapshots them as-of its SOS.
            prog_tasks.append((entropy, list(scan), ss, se, ah, al,
                               restart, dict(dc_tables), dict(ac_tables)))
        elif progressive:
            _run_scan(entropy, scan, comps, grids, grid_dims, mcus_x,
                      mcus_y, ss, se, ah, al, restart, dc_tables,
                      ac_tables, w, h, hmax, vmax, arith_cond)
        else:
            _run_baseline_scan(entropy.tobytes(), scan, comps, grids,
                               mcus_x, mcus_y, restart, dc_tables,
                               ac_tables, w, h, hmax, vmax, arith_cond)
        return e1

    pos = n if hdr.sos is None else run_scan(hdr.sos, hdr.sos_end)
    while pos + 4 <= n:
        marker, payload, pos_next = headers.read_segment(data, pos, n)
        if marker == headers.EOI:
            break
        pos = pos_next
        if payload is None:  # a fill byte, RSTn or TEM
            continue
        if marker == headers.DHT:
            tabs, error, _ = headers.read_dht(payload)
            if error is not None:
                raise error
            for tc, th, bits, vals in tabs:
                (dc_tables if tc == 0 else ac_tables)[th] = (bits, vals)
        elif marker == 0xCC:  # DAC
            _parse_dac(payload, dc_cond, ac_cond)
        elif marker == headers.DQT:  # may be (re)defined between scans
            qtables.update(headers.read_dqt(payload))
        elif marker == headers.DRI:
            restart = int.from_bytes(payload[:2], "big")
        elif marker == headers.SOS:
            pos = run_scan(payload, pos)

    if prog_tasks:
        _run_prog_tasks_threaded(prog_tasks, comps, grids,
                                 grid_dims, mcus_x, mcus_y, w, h,
                                 hmax, vmax)

    for i, c in enumerate(comps):
        if c.qtbl not in qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")
        cw = -(-w * c.h // hmax)
        ch = -(-h * c.v // vmax)
        result.comps.append((grids[i], qtables[c.qtbl], ch, cw,
                             (c.h, c.v)))
    result.ncomp = len(comps)
    return result


def _scan_threads() -> int:
    """Worker count for cross-scan progressive decode; override with
    UHDR_SCAN_THREADS (0/1 = serial)."""
    return worker_count("UHDR_SCAN_THREADS")


def _run_prog_tasks_threaded(tasks, comps, grids, grid_dims,
                             mcus_x, mcus_y, w, h, hmax, vmax):
    """Execute deferred progressive scans on a thread pool, ordering
    only genuinely dependent pairs: scan j waits on earlier scan i iff
    their component sets intersect. Scans on disjoint components write
    disjoint coefficient grids, so they run concurrently (e.g. the
    luma AC scans ∥ both chroma components' scans). Same-component
    scans stay ordered even when their spectral bands are disjoint:
    _run_scan stages through a full-grid copy-in/copy-out, so a
    concurrent same-grid scan would clobber the other band's writes.
    Dependencies always point to earlier submissions, so FIFO workers
    cannot deadlock; errors propagate through the futures."""
    metas = []     # component sets
    futures = []

    def run_after(deps, task):
        for d in deps:
            d.result()     # re-raises a failed dependency
        entropy, scan, ss, se, ah, al, restart, dcs, acs = task
        _run_scan(entropy, scan, comps, grids, grid_dims,
                  mcus_x, mcus_y, ss, se, ah, al, restart,
                  dcs, acs, w, h, hmax, vmax, None)

    with ThreadPoolExecutor(_scan_threads()) as ex:
        for task in tasks:
            cset = {ci for ci, _, _ in task[1]}
            deps = [futures[i] for i, mc in enumerate(metas)
                    if mc & cset]
            futures.append(ex.submit(run_after, deps, task))
            metas.append(cset)
        for f in futures:
            f.result()


def _wrap_prog(fn, *args):
    """Run a scan decoder, mapping the errors it raises (arith.py's
    ArithError on a malformed arithmetic stream) to the library's error
    contract like entropy_decode does for the baseline path; the
    caller maps a native return code to UHDR_CODEC_ERROR the same way.
    Nothing retries another route."""
    try:
        return fn(*args)
    except (ValueError, IndexError) as e:
        raise err("UHDR_CODEC_ERROR",
                  f"progressive scan failed: {e}") from e


def _prog_dc_first(data, buf, comp_ids, dc_sel, dc_tables, al, restart,
                   mcu_blocks) -> int:
    """jpeg/entropy.cpp's uhdr_prog_dc_first over the C-contiguous
    (nblocks, 64) int16 `buf`, in place: a progressive DC first scan.
    dc_sel maps each frame component to its slot of the 4-slot
    dc_tables list. -> the native return code (0, or minus the failing
    block + 1). huffman.prog_dc_first is its plain specification."""
    ent = np.frombuffer(data, np.uint8)
    dcb, dcv = _huff_arrays(dc_tables)
    return get_lib().uhdr_prog_dc_first(
        _as_u8p(ent), len(ent), buf.shape[0], _as_u8p(comp_ids),
        len(dc_sel), _as_u8p(dc_sel), _as_u8p(dcb), _as_u8p(dcv), al,
        restart, mcu_blocks, _as_i16p(buf))


def _prog_dc_refine(data, buf, al, restart, mcu_blocks) -> int:
    """uhdr_prog_dc_refine in place (plain: huffman.prog_dc_refine)."""
    ent = np.frombuffer(data, np.uint8)
    return get_lib().uhdr_prog_dc_refine(
        _as_u8p(ent), len(ent), buf.shape[0], al, restart, mcu_blocks,
        _as_i16p(buf))


def _prog_ac(name: str, data, buf, ac_table, ss, se, al, restart) -> int:
    ent = np.frombuffer(data, np.uint8)
    b, v = tables.pack_huff_table(*ac_table)
    return getattr(get_lib(), name)(
        _as_u8p(ent), len(ent), buf.shape[0], _as_u8p(b), _as_u8p(v), ss,
        se, al, restart, _as_i16p(buf))


def _prog_ac_first(data, buf, ac_table, ss, se, al, restart) -> int:
    """uhdr_prog_ac_first in place over one component's blocks, with
    the (bits, vals) table ac_table (plain: huffman.prog_ac_first)."""
    return _prog_ac("uhdr_prog_ac_first", data, buf, ac_table, ss, se, al,
                    restart)


def _prog_ac_refine(data, buf, ac_table, ss, se, al, restart) -> int:
    """uhdr_prog_ac_refine in place (plain: huffman.prog_ac_refine)."""
    return _prog_ac("uhdr_prog_ac_refine", data, buf, ac_table, ss, se, al,
                    restart)


def _scan_order_indices(scan, comps, grid_dims, mcus_x, mcus_y):
    """Flat grid indices (per comp) of blocks in interleaved MCU scan
    order; returns list of (comp_idx, flat_index_array)."""
    out = []
    for ci, _, _ in scan:
        c = comps[ci]
        gh, gw = grid_dims[ci]
        my, mx = np.meshgrid(np.arange(mcus_y), np.arange(mcus_x),
                             indexing="ij")
        vy, hx = np.meshgrid(np.arange(c.v), np.arange(c.h),
                             indexing="ij")
        rows = (my[..., None, None] * c.v + vy)  # (my, mx, v, h)
        colsx = (mx[..., None, None] * c.h + hx)
        out.append((ci, (rows * gw + colsx).reshape(mcus_y, mcus_x, -1)))
    return out


def _run_scan(entropy, scan, comps, grids, grid_dims, mcus_x,
              mcus_y, ss, se, ah, al, restart, dc_tables, ac_tables,
              w, h, hmax, vmax, arith_cond=None):
    """Decode one scan of a progressive file (Huffman, or arithmetic
    when `arith_cond` carries the (dc, ac) conditioning dicts) into the
    per-component grids."""
    if ss == 0:  # DC scan
        if len(scan) > 1:
            idxmaps = _scan_order_indices(scan, comps, grid_dims,
                                          mcus_x, mcus_y)
            mcu_blocks = sum(comps[ci].h * comps[ci].v
                             for ci, _, _ in scan)
            n_mcus = mcus_x * mcus_y
            nblocks = n_mcus * mcu_blocks
            buf = np.zeros((nblocks, 64), np.int16)
            comp_ids = np.zeros(nblocks, np.uint8)
            # columns occupied by each scan component within an MCU,
            # plus the flat grid index of every block in scan order.
            layout = []  # (ci, buf_row_selector, grid_flat_indices)
            col = 0
            for ci, idx in idxmaps:
                nb = idx.shape[-1]
                sel = (np.arange(n_mcus)[:, None] * mcu_blocks
                       + np.arange(col, col + nb)).reshape(-1)
                gidx = idx.reshape(-1)
                comp_ids[sel] = ci
                buf[sel] = grids[ci].reshape(-1, 64)[gidx]
                layout.append((ci, sel, gidx))
                col += nb
        else:
            # Non-interleaved scan: the block grid is ceil(comp/8) per
            # T.81 A.2.2 — NOT the MCU-padded grid (which overreads
            # blocks when luma dims aren't multiples of 16).
            ci = scan[0][0]
            c = comps[ci]
            cw_b = -(-(-(-w * c.h // hmax)) // 8)
            ch_b = -(-(-(-h * c.v // vmax)) // 8)
            nblocks = ch_b * cw_b
            buf = np.ascontiguousarray(
                grids[ci][:ch_b, :cw_b]).reshape(-1, 64)
            # dc_sel below is indexed by FRAME component id, so a
            # non-interleaved scan must carry its real component index
            # (a chroma DC scan with comp_ids=0 would decode with the
            # luma component's table slot / conditioning).
            comp_ids = np.full(nblocks, ci, np.uint8)
            mcu_blocks = 1

        if ah == 0 and arith_cond is not None:
            dcd = arith_cond[0]
            dc_sel = np.zeros(len(comps), np.uint8)
            for ci, dsel, _ in scan:
                dc_sel[ci] = dsel
            cond = {s: dcd.get(s, ar.DEFAULT_DC_COND)
                    for s in set(int(x) for x in dc_sel)}
            rc = _wrap_prog(ar.prog_dc_first, entropy.tobytes(), buf,
                            comp_ids, dc_sel, cond, al, restart,
                            mcu_blocks)
        elif ah != 0 and arith_cond is not None:
            rc = _wrap_prog(ar.prog_dc_refine, entropy.tobytes(), buf,
                            al, restart, mcu_blocks)
        elif ah == 0:
            dc_sel = np.zeros(len(comps), np.uint8)
            dct = [None] * 4
            for ci, dsel, _ in scan:
                if dsel not in dc_tables:
                    raise err("UHDR_CODEC_ERROR", "missing DC table")
                dct[dsel] = dc_tables[dsel]
                dc_sel[ci] = dsel
            rc = _wrap_prog(_prog_dc_first, entropy, buf, comp_ids,
                            dc_sel, dct, al, restart, mcu_blocks)
        else:
            rc = _wrap_prog(_prog_dc_refine, entropy, buf, al, restart,
                            mcu_blocks)
        if rc != 0:
            raise err("UHDR_CODEC_ERROR", f"progressive DC scan failed {rc}")

        # write back
        if len(scan) > 1:
            for ci, sel, gidx in layout:
                grids[ci].reshape(-1, 64)[gidx] = buf[sel]
        else:
            grids[ci][:ch_b, :cw_b] = buf.reshape(ch_b, cw_b, 64)
        return

    # AC scan: single component, over its ceil-dims block grid.
    if len(scan) != 1:
        raise err("UHDR_CODEC_ERROR", "interleaved AC scan is illegal")
    ci, _, asel = scan[0]
    c = comps[ci]
    cw_b = -(-(-(-w * c.h // hmax)) // 8)
    ch_b = -(-(-(-h * c.v // vmax)) // 8)
    sub = np.ascontiguousarray(grids[ci][:ch_b, :cw_b])
    if arith_cond is not None:
        kx = arith_cond[1].get(asel, ar.DEFAULT_AC_COND)
        fn = ar.prog_ac_first if ah == 0 else ar.prog_ac_refine
        args = ((entropy.tobytes(), sub.reshape(-1, 64), kx, ss, se,
                 al, restart) if ah == 0 else
                (entropy.tobytes(), sub.reshape(-1, 64), ss, se, al,
                 restart))
        rc = _wrap_prog(fn, *args)
        if rc != 0:
            raise err("UHDR_CODEC_ERROR",
                      f"progressive AC scan failed {rc}")
        grids[ci][:ch_b, :cw_b] = sub
        return
    if asel not in ac_tables:
        raise err("UHDR_CODEC_ERROR", "missing AC table")
    fn = _prog_ac_first if ah == 0 else _prog_ac_refine
    rc = _wrap_prog(fn, entropy, sub.reshape(-1, 64), ac_tables[asel], ss,
                    se, al, restart)
    if rc != 0:
        raise err("UHDR_CODEC_ERROR", f"progressive AC scan failed {rc}")
    grids[ci][:ch_b, :cw_b] = sub


def _run_baseline_scan(entropy: bytes, scan, comps, grids, mcus_x,
                       mcus_y, restart, dc_tables, ac_tables, w, h,
                       hmax, vmax, arith_cond=None):
    """Decode one full-precision sequential scan (one SOS of a
    multi-scan SOF0 file, or any SOF9 arithmetic scan when
    `arith_cond` carries the (dc, ac) conditioning dicts) into the
    per-component grids."""
    if len(scan) > 1:
        # Interleaved: the frame's global MCU grid, scan components
        # only (T.81 A.2.3).
        mcu_blocks = sum(comps[ci].h * comps[ci].v for ci, _, _ in scan)
        n_mcus = mcus_x * mcus_y
        nblocks = n_mcus * mcu_blocks
        pattern = []
        for si, (ci, _, _) in enumerate(scan):
            pattern += [si] * (comps[ci].h * comps[ci].v)
        comp_ids = np.tile(np.asarray(pattern, np.uint8), n_mcus)
    else:
        ci = scan[0][0]
        c = comps[ci]
        cw_b = -(-(-(-w * c.h // hmax)) // 8)
        ch_b = -(-(-(-h * c.v // vmax)) // 8)
        nblocks = ch_b * cw_b
        comp_ids = np.zeros(nblocks, np.uint8)
        mcu_blocks = 1

    dc_sel = [d for _, d, _ in scan]
    ac_sel = [a for _, _, a in scan]
    if arith_cond is not None:
        dcd, acd = arith_cond
        blocks = np.zeros((nblocks, 64), np.int16)
        try:
            ar.decode_seq_scan(
                entropy, blocks, comp_ids, dc_sel, ac_sel,
                {s: dcd.get(s, ar.DEFAULT_DC_COND) for s in dc_sel},
                {s: acd.get(s, ar.DEFAULT_AC_COND) for s in ac_sel},
                restart, mcu_blocks)
        except ar.ArithError as e:
            raise err("UHDR_CODEC_ERROR",
                      f"arith decode failed: {e}") from e
    else:
        blocks = entropy_decode(
            entropy, nblocks, comp_ids, dc_sel, ac_sel,
            _table_list(dc_tables, dc_sel), _table_list(ac_tables, ac_sel),
            restart, mcu_blocks)

    if len(scan) == 1:
        grids[ci][:ch_b, :cw_b] = blocks.reshape(ch_b, cw_b, 64)
        return
    grid = blocks.reshape(mcus_y, mcus_x, mcu_blocks, 64)
    off = 0
    for ci, _, _ in scan:
        c = comps[ci]
        nb = c.h * c.v
        sub = grid[:, :, off:off + nb, :].reshape(
            mcus_y, mcus_x, c.v, c.h, 64)
        sub = sub.transpose(0, 2, 1, 3, 4).reshape(
            mcus_y * c.v, mcus_x * c.h, 64)
        grids[ci][: mcus_y * c.v, : mcus_x * c.h] = sub
        off += nb


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


def decode_jpeg(data, device="cuda") -> DecodedJpeg:
    """Decode a JPEG to per-component planes on `device` (the JAX
    decode_jpeg; JPEG/R's API-3 reads the 4:2:0 planes directly, as the
    reference's jpeg_read_raw_data path does). The route is chosen from
    the headers alone: streams that jpeg/device_decode.py:
    parse_device_stream takes (one baseline scan, gray or 4:2:0 / 4:2:2
    / 4:4:4, restart markers or not) decode on the device as B4 then B5,
    each component with its own quant table; all others (progressive,
    arithmetic-coded, multi-scan, other samplings) through the host
    entropy decoder (decode_jpeg_coefs) then B5, which raises the
    reference's errors for what it cannot decode. No size gate: the
    JAX package's 1-MP gate is a TPU cost heuristic, and both routes
    give the same planes. `data`: bytes or JpegHeaders, read once."""
    dev = resolve_device(device)
    hdr = headers.of(data)
    res = decode_jpeg_device(hdr, dev)
    if res is not None:
        ds, planes = res
        w, h = ds.width, ds.height
        result = DecodedJpeg(w, h, 1 if ds.gray else 3, icc=hdr.icc_chunk,
                             exif=hdr.exif, xmp=hdr.xmp)
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
    return coefs_to_planes(decode_jpeg_coefs(hdr), dev)


def coefs_to_planes(coefs: DecodedCoefs, device="cuda") -> DecodedJpeg:
    """decode_jpeg's device stage on the host route: the coefficient
    grids and quant tables to `device` in one upload, then B5 per
    component, each plane cropped to its natural size."""
    dev = resolve_device(device)
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
