"""Batched API-0 encode and JPEG/R decode on one device.

The port of the encode/decode entry points of
libultrahdr_dev_tpu/parallel/sharding.py. A batch is a leading
dimension of same-size frames on one device (no mesh). Each direction
has a device stage and a host stage, public so that callers (and
chip_smoke.py) can time them apart:

- encode: ``encode_device_stage`` runs B1 (ops/gainmap.py:encode_front)
  and B2 (jpeg/dct.py:fdct_quant) over the batch; ``assemble_api0`` then
  entropy-codes each frame on the host with restart intervals
  (jpeg/codec.py, native Huffman) and muxes the JPEG/R. The blobs have
  the layout and metadata of sharding._assemble_rst_outputs.
- decode: ``decode_host_stage`` splits each blob and Huffman-decodes both
  images on the host; ``decode_device_stage`` runs B5
  (jpeg/dct.py:dequant_idct) and B6 (ops/gainmap.py:apply_gainmap) over
  the batch.

On a CPU device every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..container import icc as icc_mod
from ..container import mux, xmp
from ..jpeg import codec, tables
from ..jpeg.dct import dequant_idct, fdct_quant
from ..ops import color
from ..ops.gainmap import apply_gainmap, encode_front
from ..types import GainMapMetadata, MAP_COMPRESS_QUALITY, err

RST_INTERVAL = 4  # MCUs per restart marker, as the JAX batched encoder


# ---------------------------------------------------------------------------
# Encode.
# ---------------------------------------------------------------------------

def api0_metadata(hdr_tf: str) -> GainMapMetadata:
    """Gain-map metadata of an API-0 encode (ultrahdr.cpp:247-257)."""
    max_boost = color.hdr_inv_oetf_fn(hdr_tf)[1] / color.SDR_WHITE_NITS
    return GainMapMetadata(max_content_boost=max_boost,
                           min_content_boost=1.0, hdr_capacity_min=1.0,
                           hdr_capacity_max=max_boost)


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Natural-order (luma, chroma, gain map) quant tables of an API-0
    encode at base `quality`."""
    return (tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality),
            tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality),
            tables.scale_quant_table(tables.STD_LUMINANCE_QUANT,
                                     MAP_COMPRESS_QUALITY))


def p010_to_device(plane_u16: np.ndarray, device) -> torch.Tensor:
    """uint16 P010 samples -> int16 tensor of the same bits on `device`."""
    a = np.ascontiguousarray(plane_u16, np.uint16).view(np.int16)
    return torch.from_numpy(a).to(device)


def encode_device_stage(y_p010: torch.Tensor, uv_p010: torch.Tensor,
                        gamut: str, hdr_tf: str, quality: int):
    """B1 then B2 over a batch: int16 P010 planes (n, h, w) and
    (n, h/2, w) on the device -> zigzag coefficient blocks (y, u, v,
    gain map), each (n, nblocks, 64) int16 on the same device."""
    gmap, yb, ub, vb = encode_front(y_p010, uv_p010, gamut, hdr_tf)
    ql, qc, qg = (torch.from_numpy(q.reshape(64)).to(y_p010.device)
                  for q in quant_tables(quality))
    return (fdct_quant(yb, ql), fdct_quant(ub, qc), fdct_quant(vb, qc),
            fdct_quant(gmap, qg))


def assemble_api0(coefs, width: int, height: int, gamut: str, hdr_tf: str,
                  quality: int) -> list[bytes]:
    """Host stage of the batched encode: per frame, restart-interval
    Huffman coding of the base and gain map, headers, ICC and the
    JPEG/R mux. `coefs` is encode_device_stage's output."""
    yz, uz, vz, gz = (c.cpu().numpy() for c in coefs)
    metadata = api0_metadata(hdr_tf)
    icc = icc_mod.write_icc_profile("srgb", gamut)
    base_hdr = codec.yuv420_jpeg_headers(width, height, quality, icc=icc,
                                         restart_interval=RST_INTERVAL)
    gm_hdr = codec.gray_jpeg_headers(width // 4, height // 4,
                                     MAP_COMPRESS_QUALITY,
                                     restart_interval=RST_INTERVAL)
    out = []
    for i in range(yz.shape[0]):
        base = (base_hdr + codec.encode_yuv420_scan(
            yz[i], uz[i], vz[i], width, height, RST_INTERVAL) + b"\xff\xd9")
        gmap = (gm_hdr + codec.encode_gray_scan(gz[i], RST_INTERVAL)
                + b"\xff\xd9")
        out.append(mux.append_gainmap(base, gmap, metadata))
    return out


def batched_encode_api0(y_batch: np.ndarray, uv_batch: np.ndarray,
                        gamut: str = "bt2100", hdr_tf: str = "hlg",
                        quality: int = 95, device="cpu") -> list[bytes]:
    """API-0 encode of a batch of same-size P010 frames: uint16
    (n, h, w) luma and (n, h/2, w) interleaved CbCr, h and w multiples
    of 16. Returns one JPEG/R blob per frame."""
    n, h, w = y_batch.shape
    if h % 16 or w % 16:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"batched encode requires 16-aligned dims, got {w}x{h}")
    coefs = encode_device_stage(p010_to_device(y_batch, device),
                                p010_to_device(uv_batch, device), gamut,
                                hdr_tf, quality)
    return assemble_api0(coefs, w, h, gamut, hdr_tf, quality)


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def check_gainmap_metadata(metadata: GainMapMetadata):
    """Decode-side metadata restrictions (ultrahdr.cpp:369-406)."""
    if metadata.version != "1.0":
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"unsupported metadata version {metadata.version}")
    if metadata.gamma != 1.0 or metadata.offset_sdr != 0.0 \
            or metadata.offset_hdr != 0.0:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "unsupported gamma/offsets")
    if (metadata.hdr_capacity_min != metadata.min_content_boost
            or metadata.hdr_capacity_max != metadata.max_content_boost):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "hdr capacity != content boost")


def apply_scalars(metadata: GainMapMetadata,
                  max_display_boost: float) -> np.ndarray:
    """[log2(min boost), log2(max boost), boost factor, display boost]
    as float32, as JpegR.decode derives them (jpegr.py:587-599)."""
    display_boost = min(max_display_boost, metadata.max_content_boost)
    boost_factor = (display_boost / metadata.max_content_boost
                    if display_boost > 0 else 1.0)
    return np.asarray([math.log2(metadata.min_content_boost),
                       math.log2(metadata.max_content_boost),
                       boost_factor, display_boost], np.float32)


@dataclass
class HostDecoded:
    """One JPEG/R after the host stage: coefficient block grids
    (bh, bw, 64) int16 zigzag and natural-order quant tables of the
    base's Y/U/V and the gain map, plus what the container carried."""

    width: int
    height: int
    gm_width: int
    gm_height: int
    grids: tuple      # (y, u, v, gain map) coefficient grids
    qtables: tuple    # (luma, chroma, gain map) 8x8 int32
    metadata: GainMapMetadata
    icc: bytes | None = None
    exif: bytes | None = None


def decode_host_stage(blob: bytes) -> HostDecoded:
    """Split a JPEG/R and Huffman-decode both images on the host."""
    primary, gainmap = mux.extract_primary_and_gainmap(blob)
    base = codec.decode_jpeg_coefs(primary)
    if (base.ncomp != 3 or base.comps[0][4] != (2, 2)
            or base.comps[1][4] != (1, 1) or base.comps[2][4] != (1, 1)):
        raise err("UHDR_CODEC_ERROR", "base image is not YCbCr 4:2:0")
    gmdec = codec.decode_jpeg_coefs(gainmap)
    if gmdec.ncomp != 1:
        raise err("UHDR_CODEC_ERROR", "gain map is not grayscale")
    if gmdec.xmp is None:
        raise err("UHDR_CODEC_ERROR", "gain map carries no XMP")
    metadata = xmp.get_metadata_from_xmp(gmdec.xmp)
    w, h = base.width, base.height
    gg, qg, gh, gw, _ = gmdec.comps[0]
    if w % gw or h % gh or (w * gh != h * gw):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"non-integer map scale {w}x{h} vs {gw}x{gh}")
    check_gainmap_metadata(metadata)
    (yg, ql, *_), (ug, qc, *_), (vg, *_) = base.comps
    return HostDecoded(w, h, gw, gh, (yg, ug, vg, gg), (ql, qc, qg),
                       metadata, icc=base.icc, exif=base.exif)


def decode_device_stage(frames: list[HostDecoded], output_format: str,
                        max_display_boost: float, device) -> torch.Tensor:
    """B5 then B6 over a batch of same-size decoded frames: HDR pixels
    on `device`, (n, h, w, 4) int16 F16 bits for "hdr_linear" or
    (n, h, w) int32 RGBA1010102 words for "hdr_hlg" / "hdr_pq"."""
    f0 = frames[0]
    geom = (f0.width, f0.height, f0.gm_width, f0.gm_height)
    if any((f.width, f.height, f.gm_width, f.gm_height) != geom
           for f in frames):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  "a decode batch needs frames of one geometry")
    w, h, gw, gh = geom
    ch, cw = (h + 1) // 2, (w + 1) // 2
    planes = []
    # (plane, its quant table, its crop): Y, U, V, gain map.
    for k, qk, crop in ((0, 0, (h, w)), (1, 1, (ch, cw)), (2, 1, (ch, cw)),
                        (3, 2, (gh, gw))):
        grid = np.stack([f.grids[k] for f in frames])
        bh, bw = grid.shape[1:3]
        q = np.stack([f.qtables[qk].reshape(64)
                      for f in frames]).astype(np.int32)
        plane = dequant_idct(
            torch.from_numpy(grid.reshape(len(frames), bh * bw, 64))
            .to(device), torch.from_numpy(q).to(device), bh, bw)
        planes.append(plane[:, :crop[0], :crop[1]])
    scalars = torch.from_numpy(np.stack([
        apply_scalars(f.metadata, max_display_boost) for f in frames]))
    return apply_gainmap(*planes, scalars.to(device), output_format)


def batched_decode(blobs: list[bytes], output_format: str = "hdr_linear",
                   max_display_boost: float = float("inf"),
                   device="cpu") -> torch.Tensor:
    """Decode same-size JPEG/R blobs to HDR pixels on `device` (see
    decode_device_stage for the layout)."""
    return decode_device_stage([decode_host_stage(b) for b in blobs],
                               output_format, max_display_boost, device)
