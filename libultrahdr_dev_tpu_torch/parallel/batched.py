"""Batched API-0 / API-1 encode and JPEG/R decode, on one device or a
mesh of them.

The port of the encode/decode entry points of
libultrahdr_dev_tpu/parallel/sharding.py. A batch is a leading
dimension of same-size frames on one device, or, with ``mesh=``
(parallel/mesh.py), cut into contiguous shards, one per mesh device
(see "The mesh" below). Each direction has a device stage and a host
stage, public so that callers (and chip_smoke.py) can time them apart:

- encode: ``encode_device_stage`` runs B1 (ops/gainmap.py:encode_front,
  API-0: the HDR frame alone) or ``encode_device_stage_api1`` B9
  (ops/gainmap.py:encode_front_api1, API-1: an HDR frame and its SDR
  rendition), then B2 (jpeg/dct.py:fdct_quant) and B3
  (jpeg/device_entropy.py, restart-interval Huffman encode) over the
  batch; ``assemble_api0`` copies the streams to the host in one
  transfer, inserts byte stuffing and RSTn markers, and writes headers,
  ICC and the JPEG/R mux. Dense content (a block longer than the JAX
  encoder's 608-bit buffer, B3's count pass tells) takes the JAX
  package's fallback: API-0 writes the whole batch restart-less with
  B19 (``assemble_api0_restartless``) and gives no handoff; API-1
  raises OverflowError, and JpegR.encode_api1 takes the general route.
  ``batched_encode_device_stage`` (B20 of the JAX package) is B1 then
  B2 alone, with the gain map's metadata.
- decode: ``decode_host_stage`` splits each blob, parses its markers
  and destuffs its entropy segments; ``decode_device_stage`` uploads the
  batch in one transfer and runs B4 (jpeg/device_decode.py, parallel
  Huffman decode), B5 (jpeg/dct.py:dequant_idct) and B6
  (ops/gainmap.py:apply_gainmap; B11, its table arms, with use_luts)
  for HDR output, or B4 and B5 over the base alone and B7
  (ops/gainmap.py:yuv420_to_rgba8888) for SDR output, which reads
  nothing of the gain map. Output "planes" stops before the apply: B18
  (ops/gainmap.py:planes_composite) stacks the decoded planes into the
  u8 composite that the host-apply decode reads back
  (parallel/link.py). The route is chosen per batch from the headers
  alone: streams that the device decoder does not take (no
  baseline 4:2:0 base or gray gain map, several scans, ...) are
  Huffman-decoded on the host instead (``decode_host_huffman``), which
  raises the reference's errors for what it cannot decode either.
- handoff: ``batched_encode_api0(..., return_handoff=True)`` also returns
  the encoder's device-resident streams (``DeviceEncodedBatch``), which
  ``batched_decode_from_handoff`` decodes with no re-parse and no
  stream upload.
- the packed upload: ``batched_encode_api0(..., device_input=(y, uv))``
  encodes P010 batches already on the device (parallel/link.py
  upload_p010_batch: B14, or B0).
- apply: ``batched_apply_gainmap`` runs B6 over a batch of decoded
  planes and gain maps with one metadata.

The mesh: every batched entry point takes ``mesh`` (a
parallel/mesh.py DeviceMesh) and runs one shard loop over it; None, the
default, is the one-device mesh of `device`, whose one shard's outputs
come back as they are (a tensor, a DeviceEncodedBatch). Each shard runs
the device stage on its own device, every shard's device work enqueued
before any host tail starts; the host tails (stuffing and mux, parse
and destuff) run on one worker per shard (utils/workers.py caps them).
Blobs come back as one list in batch order, device pixels as a
``ShardedBatch``, handoffs as a tuple of one DeviceEncodedBatch per
shard; ``stats`` sums over the shards. What JAX's
one sharded program decides for the whole batch is decided for the
whole batch here too: B3's count passes of every shard are read before
any write pass runs, so one dense block anywhere writes every shard
restart-less, and the decode route (device or host Huffman) comes from
the headers of every blob. The outputs are the one-device call's, bytes
and pixels.

Entry points run on the CUDA device unless the caller passes another
device; on a CPU device every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..container import icc as icc_mod
from ..container import mux, xmp
from ..device import upload as _upload
from ..jpeg import codec, device_decode as dd, device_entropy as de, tables
from ..jpeg.dct import dequant_idct, fdct_quant
from ..ops.gainmap import (apply_gainmap, apply_scalars,  # noqa: F401
                           encode_front, encode_front_api1, gainmap_metadata,
                           planes_composite, yuv420_to_rgba8888)
from ..types import GainMapMetadata, MAP_COMPRESS_QUALITY, err
from ..utils import counters
from ..utils.profiler import span
from .mesh import (DeviceMesh, ShardedBatch, check_placed, map_shards,
                   merge_stats, mesh_for)

RST_INTERVAL = 4  # MCUs per restart marker, as the JAX batched encoder


# ---------------------------------------------------------------------------
# Encode.
# ---------------------------------------------------------------------------

# Gain-map metadata of an API-0 or API-1 encode (ultrahdr.cpp:247-257).
api0_metadata = gainmap_metadata


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


def _coefs(front, quality: int):
    """B2 over a front end's (gain map, y, u, v) planes, quantised by the
    reciprocals of the tables as the JAX encode program quantises
    (its tables are constants there; jpeg/dct.py)."""
    gmap, yb, ub, vb = front
    ql, qc, qg = (torch.from_numpy(q.reshape(64)).to(yb.device)
                  for q in quant_tables(quality))
    return tuple(fdct_quant(p, q, recip=True) for p, q in
                 ((yb, ql), (ub, qc), (vb, qc), (gmap, qg)))


def encode_coefs_stage(y_p010: torch.Tensor, uv_p010: torch.Tensor,
                       gamut: str, hdr_tf: str, quality: int):
    """B1 then B2 over a batch: int16 P010 planes (n, h, w) and
    (n, h/2, w) on the device -> zigzag coefficient blocks (y, u, v,
    gain map), each (n, nblocks, 64) int16 on the same device."""
    return _coefs(encode_front(y_p010, uv_p010, gamut, hdr_tf), quality)


def encode_coefs_stage_api1(y_p010: torch.Tensor, uv_p010: torch.Tensor,
                            sdr_y: torch.Tensor, sdr_u: torch.Tensor,
                            sdr_v: torch.Tensor, sdr_gamut: str,
                            hdr_gamut: str, hdr_tf: str, quality: int):
    """B9 then B2 over a batch: the P010 planes as encode_coefs_stage
    takes them and the SDR frame as uint8 (n, h, w), (n, h/2, w/2)
    planes on the same device -> the same four coefficient arrays."""
    return _coefs(encode_front_api1(y_p010, uv_p010, sdr_y, sdr_u, sdr_v,
                                    sdr_gamut, hdr_gamut, hdr_tf), quality)


@dataclass
class DeviceStreams:
    """B3's output for a batch: each image kind's chunk bytes (JPEG byte
    order, frames back to back) and (n, nc) int32 chunk bit counts, on
    the device. The per-frame chunk counts (the JAX _rst_chunk_geometry)
    are the bit arrays' widths."""

    width: int
    height: int
    base: torch.Tensor
    base_bits: torch.Tensor
    gm: torch.Tensor
    gm_bits: torch.Tensor


def _streams_shards(coefs, w: int, h: int) -> list[DeviceStreams] | None:
    """B3 over each shard's coefficients, the base images first: every
    shard's count pass is read before any write pass runs, so that a
    block of any shard longer than the JAX encoder's buffer
    (de.BLOCK_BIT_CAP) gives None for the whole batch, with no write
    pass launched after the flagged count passes."""
    base = [de.count_ycbcr_rst(yz, uz, vz, w // 16, h // 16, RST_INTERVAL)
            for yz, uz, vz, _ in coefs]
    if max(c.longest for c in base) > de.BLOCK_BIT_CAP:
        return None
    base = [c.write() for c in base]
    gm = [de.count_gray_rst(c[3], RST_INTERVAL) for c in coefs]
    if max(c.longest for c in gm) > de.BLOCK_BIT_CAP:
        return None
    return [DeviceStreams(w, h, *b, *g.write()) for b, g in zip(base, gm)]


def _streams(coefs, w: int, h: int) -> DeviceStreams | None:
    """B3 over a batch's coefficients on one device; None for dense
    content (_streams_shards)."""
    out = _streams_shards([coefs], w, h)
    return None if out is None else out[0]


def encode_device_stage(y_p010: torch.Tensor, uv_p010: torch.Tensor,
                        gamut: str, hdr_tf: str,
                        quality: int) -> DeviceStreams | None:
    """B1, B2 and B3 over a batch (see encode_coefs_stage for the
    inputs): the restart-interval entropy streams of every base image
    and gain map, on the device; None for dense content (_streams)."""
    _, h, w = y_p010.shape
    return _streams(encode_coefs_stage(y_p010, uv_p010, gamut, hdr_tf,
                                       quality), w, h)


def batched_encode_device_stage(y_batch: np.ndarray, uv_batch: np.ndarray,
                                gamut: str = "bt2100", hdr_tf: str = "hlg",
                                base_quality: int = 95, device="cuda",
                                mesh=None):
    """The device stage of API-0 for a batch of same-size P010 frames
    (the JAX sharding.batched_encode_device_stage, kernel B20 there):
    uint16 (n, h, w) and (n, h/2, w) planes, uploaded to `device`,
    through B1 and B2 -> ((y, u, v, gain map) zigzag coefficient
    blocks, each (n, nblocks, 64) int16 on the device; the gain map's
    metadata). With a mesh each shard is uploaded to its device and the
    four coefficient arrays are ShardedBatches."""
    one, mesh = mesh is None, mesh_for(mesh, device)
    coefs = [encode_coefs_stage(p010_to_device(y_batch[sl], d),
                                p010_to_device(uv_batch[sl], d), gamut, hdr_tf,
                                base_quality)
             for sl, d in zip(mesh.shards(len(y_batch)), mesh.devices)]
    return (coefs[0] if one else tuple(ShardedBatch(c) for c in zip(*coefs)),
            api0_metadata(hdr_tf))


def encode_device_stage_api1(y_p010: torch.Tensor, uv_p010: torch.Tensor,
                             sdr_y: torch.Tensor, sdr_u: torch.Tensor,
                             sdr_v: torch.Tensor, sdr_gamut: str,
                             hdr_gamut: str, hdr_tf: str,
                             quality: int) -> DeviceStreams | None:
    """B9, B2 and B3 over a batch (see encode_coefs_stage_api1 for the
    inputs): the entropy streams, on the device; None for dense
    content."""
    _, h, w = y_p010.shape
    return _streams(encode_coefs_stage_api1(
        y_p010, uv_p010, sdr_y, sdr_u, sdr_v, sdr_gamut, hdr_gamut, hdr_tf,
        quality), w, h)


@dataclass
class DeviceEncodedBatch:
    """Handoff from batched_encode_api0 to batched_decode_from_handoff:
    the encoder's chunk streams stay on the device and the decoder reads
    its lane windows straight from them, with no JFIF re-parse, no
    destuff and no stream upload (the reference's in-process
    encode -> decode loop, jpegr.cpp:167-247, never re-parses its own
    buffers either). The chunk bit counts are the host copies the blob
    assembly fetched."""

    streams: DeviceStreams
    base_bits: np.ndarray   # (n, nc)
    gm_bits: np.ndarray     # (n, ncg)
    quality: int
    metadata: GainMapMetadata


def _frame_spans(bits: np.ndarray) -> np.ndarray:
    """Byte offsets of each frame's chunks in a B3 stream: (n + 1,)."""
    nbytes = 4 * ((bits.astype(np.int64) + 31) >> 5).sum(axis=1)
    return np.concatenate([[0], np.cumsum(nbytes)])


def _headers(width: int, height: int, gamut: str, quality: int):
    icc = icc_mod.write_icc_profile("srgb", gamut)
    return (codec.yuv420_jpeg_headers(width, height, quality, icc=icc,
                                      restart_interval=RST_INTERVAL),
            codec.gray_jpeg_headers(width // 4, height // 4,
                                    MAP_COMPRESS_QUALITY,
                                    restart_interval=RST_INTERVAL))


def assemble_api0(streams: DeviceStreams, gamut: str, hdr_tf: str,
                  quality: int, stats=None):
    """Host stage of the batched encode (the JAX _assemble_rst_outputs):
    ONE device-to-host copy of the streams and chunk bit counts, then
    per frame the stuffing/marker tail (finalize_rst_stream), headers,
    ICC and the JPEG/R mux. `gamut` is the base's (the SDR gamut of an
    API-1 encode); the metadata is API-0's for both routes. `stats`
    gains d2h_bytes, the copy's size. Returns (blobs, base bits,
    gain-map bits)."""
    s = streams
    nb, ng = s.base.numel(), s.gm.numel()
    host = torch.cat([s.base, s.gm,
                      s.base_bits.reshape(-1).view(torch.uint8),
                      s.gm_bits.reshape(-1).view(torch.uint8)]).cpu().numpy()
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + host.nbytes
    base_bits = host[nb + ng:nb + ng + s.base_bits.numel() * 4].view(
        np.int32).reshape(s.base_bits.shape)
    gm_bits = host[nb + ng + s.base_bits.numel() * 4:].view(
        np.int32).reshape(s.gm_bits.shape)
    bspan, gspan = _frame_spans(base_bits), _frame_spans(gm_bits)
    metadata = api0_metadata(hdr_tf)
    base_hdr, gm_hdr = _headers(s.width, s.height, gamut, quality)
    out = []
    for i in range(base_bits.shape[0]):
        base = de.finalize_rst_stream(host[bspan[i]:bspan[i + 1]],
                                      base_bits[i])
        gmap = de.finalize_rst_stream(host[nb + gspan[i]:nb + gspan[i + 1]],
                                      gm_bits[i])
        out.append(mux.append_gainmap(base_hdr + base + b"\xff\xd9",
                                      gm_hdr + gmap + b"\xff\xd9", metadata))
    return out, base_bits, gm_bits


def assemble_api0_host_huffman(coefs, width: int, height: int, gamut: str,
                               hdr_tf: str, quality: int) -> list[bytes]:
    """The host-Huffman route of the same blobs: coefficients (the output
    of encode_coefs_stage) to the host, then restart-interval Huffman
    coding in C++ (jpeg/entropy.cpp). Kept as the reference that B3's
    output is held against; the entry points do not call it."""
    yz, uz, vz, gz = (c.cpu().numpy() for c in coefs)
    metadata = api0_metadata(hdr_tf)
    base_hdr, gm_hdr = _headers(width, height, gamut, quality)
    out = []
    for i in range(yz.shape[0]):
        base = (base_hdr + codec.encode_yuv420_scan(
            yz[i], uz[i], vz[i], width, height, RST_INTERVAL) + b"\xff\xd9")
        gmap = (gm_hdr + codec.encode_gray_scan(gz[i], RST_INTERVAL)
                + b"\xff\xd9")
        out.append(mux.append_gainmap(base, gmap, metadata))
    return out


def assemble_api0_restartless(coefs, width: int, height: int, gamut: str,
                              hdr_tf: str, quality: int) -> list[bytes]:
    """The dense-content route of API-0 (the JAX scatter fallback,
    sharding.py:861-898): B19 over the batch's base images and gain
    maps, the streams and bit counts to the host in one copy, then per
    frame the restart-less tail (finalize_stream), headers without DRI,
    ICC and the JPEG/R mux."""
    return _assemble_restartless(_restartless_streams(coefs, width, height),
                                 width, height, gamut, hdr_tf, quality)


def _restartless_streams(coefs, width: int, height: int):
    """B19 over a batch's base images and gain maps: (base stream, its
    (n,) int64 bits, gain-map stream, its bits) on the device."""
    yz, uz, vz, gz = coefs
    return (*de.encode_ycbcr_stream(yz, uz, vz, width // 16, height // 16),
            *de.encode_gray_stream(gz))


def _assemble_restartless(streams, width: int, height: int, gamut: str,
                          hdr_tf: str, quality: int) -> list[bytes]:
    """The host stage of assemble_api0_restartless."""
    base, base_bits, gm, gm_bits = streams
    nb, ng, n = base.numel(), gm.numel(), base_bits.numel()
    host = torch.cat([base, gm, base_bits.view(torch.uint8),
                      gm_bits.view(torch.uint8)]).cpu().numpy()
    bits = host[nb + ng:].copy().view(np.int64)
    bspan, gspan = de.stream_spans(bits[:n]), de.stream_spans(bits[n:])
    icc = icc_mod.write_icc_profile("srgb", gamut)
    base_hdr = codec.yuv420_jpeg_headers(width, height, quality, icc=icc)
    gm_hdr = codec.gray_jpeg_headers(width // 4, height // 4,
                                     MAP_COMPRESS_QUALITY)
    metadata = api0_metadata(hdr_tf)
    out = []
    for i in range(n):
        b = de.finalize_stream(host[bspan[i]:bspan[i + 1]], bits[i])
        g = de.finalize_stream(host[nb + gspan[i]:nb + gspan[i + 1]],
                               bits[n + i])
        out.append(mux.append_gainmap(base_hdr + b + b"\xff\xd9",
                                      gm_hdr + g + b"\xff\xd9", metadata))
    return out


def batched_encode_api0(y_batch: np.ndarray | None,
                        uv_batch: np.ndarray | None, gamut: str = "bt2100",
                        hdr_tf: str = "hlg", quality: int = 95, device="cuda",
                        return_handoff: bool = False, device_input=None,
                        stats=None, mesh=None):
    """API-0 encode of a batch of same-size P010 frames: uint16
    (n, h, w) luma and (n, h/2, w) interleaved CbCr, h and w multiples
    of 16. Returns one JPEG/R blob per frame; with return_handoff, also
    a DeviceEncodedBatch for batched_decode_from_handoff. Dense content
    writes the whole batch restart-less (assemble_api0_restartless) and
    hands off None, as the JAX package does.

    device_input: (y, uv) MSB-aligned int16 batches already on a device
    (parallel/link.py upload_p010_batch, the packed upload; JAX
    sharding.py:787); the host batches are then not read, and the encode
    runs on that device. Otherwise the host batches are copied as
    uint16 (one copy per plane). stats: a dict that gains h2d_bytes and
    h2d_pack ("u16"; nothing for device_input, whose upload counts its
    own) and d2h_bytes (the streams' copy to the host).

    mesh: the batch is cut into one shard per mesh device (the module's
    "The mesh"); device_input is then a pair of ShardedBatches laid over
    the mesh (upload_p010_batch(..., mesh=)), and the handoff a tuple of
    one DeviceEncodedBatch per shard. Without a mesh the call runs on
    the one-device mesh of `device` (or of device_input's tensors):
    each shard's B1, B2 and B3 count pass on its device, the batch's one
    dense decision, the write passes (or B19 for every shard), then the
    host tails on a worker a shard."""
    one = mesh is None
    if device_input is not None:
        if one:
            device_input = tuple(ShardedBatch([t]) for t in device_input)
            mesh = DeviceMesh(device_input[0].devices)
        for t in device_input:
            check_placed(mesh, t)
        ys, uvs = (t.shards for t in device_input)
    else:
        mesh = mesh_for(mesh, device)
        spans = mesh.shards(len(y_batch))
        ys = [p010_to_device(y_batch[sl], d)
              for sl, d in zip(spans, mesh.devices)]
        uvs = [p010_to_device(uv_batch[sl], d)
               for sl, d in zip(spans, mesh.devices)]
        if stats is not None:
            stats["h2d_bytes"] = (stats.get("h2d_bytes", 0)
                                  + y_batch.nbytes + uv_batch.nbytes)
            stats["h2d_pack"] = "u16"
    _check_aligned(ys[0].shape)
    _, h, w = ys[0].shape
    coefs = [encode_coefs_stage(y, uv, gamut, hdr_tf, quality)
             for y, uv in zip(ys, uvs)]
    streams = _streams_shards(coefs, w, h)
    if streams is None:
        dense = [_restartless_streams(c, w, h) for c in coefs]
        blobs = [b for part in map_shards(
            lambda d: _assemble_restartless(d, w, h, gamut, hdr_tf, quality),
            dense) for b in part]
        return (blobs, None) if return_handoff else blobs
    shard_stats = [{} for _ in streams]
    parts = map_shards(lambda i: _finish_encode(
        streams[i], gamut, hdr_tf, quality, shard_stats[i]),
        range(len(streams)))
    merge_stats(stats, shard_stats)
    return _joined(parts, one, return_handoff)


def _check_aligned(shape):
    _, h, w = shape
    if h % 16 or w % 16:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"batched encode requires 16-aligned dims, got {w}x{h}")


def _finish_encode(streams: DeviceStreams, gamut: str, hdr_tf: str,
                   quality: int, stats=None):
    """One shard's host tail: (its blobs, its DeviceEncodedBatch)."""
    blobs, base_bits, gm_bits = assemble_api0(streams, gamut, hdr_tf,
                                              quality, stats)
    return blobs, DeviceEncodedBatch(streams, base_bits, gm_bits,
                                     int(quality), api0_metadata(hdr_tf))


def _joined(parts, one: bool, return_handoff: bool):
    """The shards' (blobs, handoff) pairs as an encode returns them: the
    blobs as one list in batch order and, with return_handoff, the
    handoffs, a tuple of one a shard where the caller gave a mesh (the
    one shard's where it did not)."""
    blobs = [b for part, _ in parts for b in part]
    if not return_handoff:
        return blobs
    hands = tuple(hand for _, hand in parts)
    return blobs, hands[0] if one else hands


def batched_encode_api1(p010_y_batch: np.ndarray, p010_uv_batch: np.ndarray,
                        sdr_y_batch: np.ndarray, sdr_u_batch: np.ndarray,
                        sdr_v_batch: np.ndarray, sdr_gamut: str = "bt709",
                        hdr_gamut: str = "bt2100", hdr_tf: str = "hlg",
                        quality: int = 95, device="cuda",
                        return_handoff: bool = False, mesh=None):
    """API-1 encode of a batch of same-size frames (the JAX
    sharding.batched_encode_api1): P010 as batched_encode_api0 takes it
    and the SDR rendition as uint8 YUV420 planes (n, h, w) and
    (n, h/2, w/2) in `sdr_gamut`'s YUV encoding, h and w multiples of
    16. All five planes go to the device in one copy (a copy a shard
    with a mesh). Returns one JPEG/R blob per frame; with
    return_handoff, also a DeviceEncodedBatch (a tuple of one a shard
    with a mesh). Raises OverflowError for dense content in any frame,
    as the JAX package does (sharding.py:688-694); JpegR.encode_api1
    then takes the general route."""
    one, mesh = mesh is None, mesh_for(mesh, device)
    _check_aligned(p010_y_batch.shape)
    arrays = ([np.ascontiguousarray(p010_y_batch, np.uint16).view(np.int16),
               np.ascontiguousarray(p010_uv_batch, np.uint16).view(np.int16)]
              + [np.ascontiguousarray(a, np.uint8)
                 for a in (sdr_y_batch, sdr_u_batch, sdr_v_batch)])
    coefs = [encode_coefs_stage_api1(*_upload([a[sl] for a in arrays], d),
                                     sdr_gamut, hdr_gamut, hdr_tf, quality)
             for sl, d in zip(mesh.shards(len(p010_y_batch)), mesh.devices)]
    _, h, w = p010_y_batch.shape
    streams = _streams_shards(coefs, w, h)
    if streams is None:
        raise OverflowError("dense content: a block passes the JAX "
                            "encoder's 608-bit buffer")
    parts = map_shards(lambda st: _finish_encode(st, sdr_gamut, hdr_tf,
                                                 quality), streams)
    return _joined(parts, one, return_handoff)


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


@dataclass
class HostDecoded:
    """One JPEG/R after the host stage: what its container and headers
    carried, natural-order quant tables of the base's luma and chroma
    and of the gain map, and either the parsed entropy streams of base
    and gain map (`streams`, the device route) or their coefficient
    grids (`grids`, (bh, bw, 64) int16 zigzag of Y, U, V and the gain
    map, the host route). A stage for SDR output reads the base alone:
    no gain-map stream, grid, table or metadata, and gm_width =
    gm_height = 0."""

    width: int
    height: int
    gm_width: int
    gm_height: int
    qtables: tuple    # (luma, chroma[, gain map]) 8x8 int32
    metadata: GainMapMetadata | None
    icc: bytes | None = None
    exif: bytes | None = None
    streams: tuple | None = None
    grids: tuple | None = None


def _check_geometry(w: int, h: int, gw: int, gh: int):
    if w % gw or h % gh or (w * gh != h * gw):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"non-integer map scale {w}x{h} vs {gw}x{gh}")


def parse_device_route(images, sdr: bool = False) -> HostDecoded | None:
    """Host stage of the device route (the JAX _decode_device_path up to
    its launch) on the headers of a JPEG/R's two images
    (mux.read_primary_and_gainmap): both, or the base alone for SDR
    output, checked and destuffed. None when an image does not suit the
    device decoder (a 4:2:0 base and a gray gain map). Spans: each
    image's rule, the gain map's XMP and checks "decode.headers"; each
    destuffing "decode.destuff"."""
    primary, gainmap = images
    with span("decode.headers"):
        hb = dd.parse_device_headers(primary)
    if hb is None or hb.gray or hb.sampling != (2, 2):
        return None
    with span("decode.destuff"):
        ds = dd.destuff_device_stream(hb)
    if ds is None:
        return None
    if sdr:
        return HostDecoded(ds.width, ds.height, 0, 0,
                           (ds.qtables[0], ds.qtables[1]), None,
                           icc=primary.icc_chunk, exif=primary.exif,
                           streams=(ds,))
    with span("decode.headers"):
        hg = dd.parse_device_headers(gainmap)
        if hg is None or not hg.gray:
            return None
        if gainmap.xmp is None:
            raise err("UHDR_CODEC_ERROR", "gain map carries no XMP")
        metadata = xmp.get_metadata_from_xmp(gainmap.xmp)
        _check_geometry(ds.width, ds.height, hg.width, hg.height)
        check_gainmap_metadata(metadata)
    with span("decode.destuff"):
        dsg = dd.destuff_device_stream(hg)
    if dsg is None:
        return None
    return HostDecoded(ds.width, ds.height, dsg.width, dsg.height,
                       (ds.qtables[0], ds.qtables[1], dsg.qtables[0]),
                       metadata, icc=primary.icc_chunk, exif=primary.exif,
                       streams=(ds, dsg))


def decode_host_huffman(images, sdr: bool = False) -> HostDecoded:
    """Host stage of the host route on the headers of a JPEG/R's two
    images: both Huffman-decoded on the host (jpeg/entropy.cpp), or the
    base alone for SDR output."""
    primary, gainmap = images
    base = codec.decode_jpeg_coefs(primary)
    if (base.ncomp != 3 or base.comps[0][4] != (2, 2)
            or base.comps[1][4] != (1, 1) or base.comps[2][4] != (1, 1)):
        raise err("UHDR_CODEC_ERROR", "base image is not YCbCr 4:2:0")
    (yg, ql, *_), (ug, qc, *_), (vg, *_) = base.comps
    if sdr:
        return HostDecoded(base.width, base.height, 0, 0, (ql, qc), None,
                           icc=base.icc, exif=base.exif, grids=(yg, ug, vg))
    gmdec = codec.decode_jpeg_coefs(gainmap)
    if gmdec.ncomp != 1:
        raise err("UHDR_CODEC_ERROR", "gain map is not grayscale")
    if gmdec.xmp is None:
        raise err("UHDR_CODEC_ERROR", "gain map carries no XMP")
    metadata = xmp.get_metadata_from_xmp(gmdec.xmp)
    gg, qg, gh, gw, _ = gmdec.comps[0]
    _check_geometry(base.width, base.height, gw, gh)
    check_gainmap_metadata(metadata)
    return HostDecoded(base.width, base.height, gw, gh, (ql, qc, qg),
                       metadata, icc=base.icc, exif=base.exif,
                       grids=(yg, ug, vg, gg))


def decode_host_stage(blobs: list[bytes], output_format: str = "hdr_linear",
                      mesh=None) -> list[HostDecoded]:
    """Host stage of a batched decode. Each blob is split and its images'
    headers read once (span "decode.split"); the route is chosen from
    them alone, for the whole batch: the device route when every blob
    suits it (parse and destuff only), else host Huffman. For "sdr"
    output only the base is decoded: the gain map's XMP and stream are
    never looked at (the JAX SDR branch, jpegr.py:451-464, 555-570).
    With a mesh each shard's blobs are parsed on a worker of their own,
    and the route is still the whole batch's. Runs in span
    "decode.host"; a batch sent to host Huffman adds its frames to
    counter "decode_route_host"."""
    sdr = output_format == "sdr"
    shards = [slice(None)] if mesh is None else mesh.shards(len(blobs))

    def each(fn, items):
        return [f for part in map_shards(
            lambda sl: [fn(x) for x in items[sl]], shards) for f in part]

    def device_route(blob):
        with span("decode.split"):
            images = mux.read_primary_and_gainmap(blob)
        return images, parse_device_route(images, sdr)

    with span("decode.host"):
        parsed = each(device_route, blobs)
        if all(f is not None for _, f in parsed):
            return [f for _, f in parsed]
        counters.bump("decode_route_host", len(blobs))
        return each(lambda p: decode_host_huffman(p[0], sdr), parsed)


def _planes(grids, qtables: torch.Tensor, geom):
    """B5 over the coefficient grids (Y, U, V and, for HDR output, the
    gain map), cropped to the image: uint8 planes in the same order."""
    w, h, gw, gh = geom
    ch, cw = (h + 1) // 2, (w + 1) // 2
    shapes = (((h + 15) // 16 * 2, (w + 15) // 16 * 2), ((h + 15) // 16,
              (w + 15) // 16), ((h + 15) // 16, (w + 15) // 16),
              ((gh + 7) // 8, (gw + 7) // 8))
    planes = []
    for grid, qk, (bh, bw), crop in zip(grids, (0, 1, 1, 2), shapes,
                                        ((h, w), (ch, cw), (ch, cw),
                                         (gh, gw))):
        plane = dequant_idct(grid, qtables[:, qk].contiguous(), bh, bw)
        planes.append(plane[:, :crop[0], :crop[1]])
    return planes


def gainmap_plane(frame: HostDecoded, device) -> torch.Tensor:
    """The decoded uint8 gain-map plane (gm_height, gm_width) of an HDR
    frame's host stage, on `device` (the JAX JpegRDecodeResult.gainmap,
    jpegr.py:636-662): its gray stream through B4 and B5
    (device_decode.decode_stream_device) on the device route, its
    host-decoded grid through B5 on the host route."""
    gh, gw = frame.gm_height, frame.gm_width
    if frame.streams is not None:
        plane = dd.decode_stream_device(frame.streams[1], device)[0]
    else:
        gg = frame.grids[3]
        grid, q = _upload([gg.reshape(1, -1, 64),
                           np.asarray(frame.qtables[2], np.int32)
                           .reshape(1, 64)], device)
        plane = dequant_idct(grid, q, gg.shape[0], gg.shape[1])
    return plane[0, :gh, :gw]


def decode_device_stage(frames: list[HostDecoded], output_format: str,
                        max_display_boost: float, device,
                        use_luts: bool = False,
                        meta_out: dict | None = None, mesh=None):
    """Device stage of a batched decode of same-size frames: pixels on
    `device`, (n, h, w, 4) int16 F16 bits for "hdr_linear", (n, h, w)
    int32 RGBA1010102 words for "hdr_hlg" / "hdr_pq", (n, 3, h, w) int16
    10-bit linear RGB codes for "hdr_linear_rgb_10bit", (n, h, w) int32
    RGBA8888 words for "sdr", or for "planes" the (n, rows, wc) uint8
    composite of the decoded planes (ops/gainmap.py planes_composite)
    that the host-apply decode reads back. The device route uploads the
    destuffed streams, lane starts, decode and quant tables and apply
    scalars in one copy, then runs B4 (base and gain map), B5 and B6
    (B11 with use_luts; B18 in its place for "planes"); for "sdr", B4
    and B5 over the base and B7. The host route uploads coefficient
    grids instead of streams. `meta_out` (not for "sdr") gains w, h,
    gw, gh and the (n, 4) float32 apply scalars, as JAX's meta_out
    (sharding.py:1158). With a mesh the frames (one geometry for the
    whole batch) are cut into one shard per mesh device, each shard's
    upload and kernels on its device, and the pixels come back as a
    ShardedBatch (`device` is then not read)."""
    f0 = frames[0]
    _check_batch(frames, (f0.width, f0.height) if output_format == "sdr"
                 else (f0.width, f0.height, f0.gm_width, f0.gm_height))
    one, mesh = mesh is None, mesh_for(mesh, device)
    metas, out = [], []
    for sl, d in zip(mesh.shards(len(frames)), mesh.devices):
        metas.append({})
        out.append(_decode_shard(frames[sl], output_format,
                                 max_display_boost, d, use_luts, metas[-1]))
    if meta_out is not None and metas[0]:
        meta_out.update(metas[0], scalars=np.concatenate(
            [m["scalars"] for m in metas]))
    return out[0] if one else ShardedBatch(out)


def _decode_shard(frames: list[HostDecoded], output_format: str,
                  max_display_boost: float, device, use_luts: bool,
                  meta_out: dict) -> torch.Tensor:
    """decode_device_stage over one shard's frames on `device`, in span
    "decode.device_stage": "decode.pack" lays the upload out, "upload"
    copies it, "decode.launch" enqueues the kernels."""
    with span("decode.device_stage"):
        if output_format == "sdr":
            return _decode_device_sdr(frames, device)
        f0 = frames[0]
        geom = (f0.width, f0.height, f0.gm_width, f0.gm_height)
        with span("decode.pack"):
            q = np.stack([np.stack([t.reshape(64) for t in f.qtables])
                          for f in frames]).astype(np.int32)
            scalars = np.stack([apply_scalars(f.metadata, max_display_boost)
                                for f in frames])
            if f0.streams is not None:
                lb = dd.pack_streams([f.streams[0] for f in frames])
                lg = dd.pack_streams([f.streams[1] for f in frames])
                arrays = [np.concatenate([lb.src, lg.src]), lb.frames,
                          lb.lanes, lb.tables, _shift(lg.frames, lb.src.size),
                          lg.lanes, lg.tables]
            else:
                arrays = [np.stack([f.grids[k] for f in frames])
                          .reshape(len(frames), -1, 64) for k in range(4)]
        *up, qd, sd = _upload(arrays + [q, scalars], device)
        meta_out.update(w=geom[0], h=geom[1], gw=geom[2], gh=geom[3],
                        scalars=scalars)
        with span("decode.launch"):
            if f0.streams is not None:
                src, bf, bl, bt, gf, gl, gt = up
                grids = (dd.decode_rst_chunks(src, bf, bl, bt, False, (2, 2),
                                              lb.mcus_x, lb.mcus_y)
                         + dd.decode_rst_chunks(src, gf, gl, gt, True, (1, 1),
                                                lg.mcus_x, lg.mcus_y))
            else:
                grids = tuple(up)
            planes = _planes(grids, qd, geom)
            if output_format == "planes":
                return planes_composite(*planes)
            return apply_gainmap(*planes, sd, output_format, use_luts)


def _check_batch(frames, geom):
    if any((f.width, f.height, f.gm_width, f.gm_height)[:len(geom)] != geom
           for f in frames):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  "a decode batch needs frames of one geometry")


def _decode_device_sdr(frames: list[HostDecoded], device) -> torch.Tensor:
    """decode_device_stage for "sdr": the base alone (its streams or
    grids and its two quant tables, whatever else the frames carry) in
    one copy, then B4, B5 and B7; spans as _decode_shard's."""
    f0 = frames[0]
    geom = (f0.width, f0.height)
    with span("decode.pack"):
        q = np.stack([np.stack([t.reshape(64) for t in f.qtables[:2]])
                      for f in frames]).astype(np.int32)
        if f0.streams is not None:
            lb = dd.pack_streams([f.streams[0] for f in frames])
            arrays = [lb.src, lb.frames, lb.lanes, lb.tables]
        else:
            arrays = [np.stack([f.grids[k] for f in frames])
                      .reshape(len(frames), -1, 64) for k in range(3)]
    *up, qd = _upload(arrays + [q], device)
    with span("decode.launch"):
        if f0.streams is not None:
            grids = dd.decode_rst_chunks(*up, False, (2, 2), lb.mcus_x,
                                         lb.mcus_y)
        else:
            grids = up
        return yuv420_to_rgba8888(*_planes(grids, qd, geom + (0, 0)))


def _shift(frame_rows: np.ndarray, by: int) -> np.ndarray:
    """Descriptors of streams placed `by` bytes further into src."""
    off = frame_rows[:, dd.F_OFF].astype(np.int64) + by
    if int((off + frame_rows[:, dd.F_LEN] + frame_rows[:, dd.F_WIN]).max()
           ) >= 2**31:
        raise ValueError("decode batch exceeds the int32 index range")
    out = frame_rows.copy()
    out[:, dd.F_OFF] = off
    return out


def batched_decode(blobs: list[bytes], output_format: str = "hdr_linear",
                   max_display_boost: float = float("inf"),
                   device="cuda", use_luts: bool = False, mesh=None):
    """Decode same-size JPEG/R blobs to pixels on `device` (see
    decode_device_stage for the layout); with a mesh, a ShardedBatch of
    each shard's pixels on its device."""
    frames = decode_host_stage(blobs, output_format, mesh_for(mesh, device))
    return decode_device_stage(frames, output_format, max_display_boost,
                               device, use_luts, mesh=mesh)


def handoff_apply_scalars(handoff, max_display_boost: float) -> np.ndarray:
    """Apply scalars of a handoff (a DeviceEncodedBatch, or a mesh's
    tuple of them, whose shards share one metadata), round-tripped
    through the XMP writer and parser so they are bit-identical to what
    a decode of the assembled blob computes (XMP writes boosts as
    decimal text)."""
    if not isinstance(handoff, DeviceEncodedBatch):
        handoff = handoff[0]
    md = xmp.get_metadata_from_xmp(
        xmp.XMP_NAMESPACE.encode() + b"\x00"
        + xmp.generate_xmp_for_secondary_image(handoff.metadata).encode())
    return apply_scalars(md, max_display_boost)


def _handoff_lanes(bits: np.ndarray, specs):
    """B4 descriptors over one image kind of a handoff: each frame's
    chunks in the encoder's buffer, lanes at their word-aligned starts
    (the alignment fill is never-consumed lookahead)."""
    n, nc = bits.shape
    cw = (bits.astype(np.int64) + 31) >> 5
    starts = 4 * (np.cumsum(cw, axis=1) - cw)
    win = dd.bucket_len(4 * int(cw.max()))
    span = _frame_spans(bits)
    mcb = dd.min_code_bits(specs)
    rows = np.asarray([dd.frame_row(int(span[i]), int(span[i + 1] - span[i]),
                                    win, RST_INTERVAL, i * nc, nc, False, mcb)
                       for i in range(n)], np.int32)
    lanes = np.stack([starts.reshape(-1), np.zeros(n * nc, np.int64)],
                     axis=1).astype(np.int32)
    tabs = np.broadcast_to(dd.decode_tables(specs),
                           (n, 4, dd.TABLE_WORDS)).copy()
    return rows, lanes, tabs


def batched_decode_from_handoff(handoff,
                                output_format: str = "hdr_linear",
                                max_display_boost: float = float("inf"),
                                use_luts: bool = False, mesh=None):
    """Decode a DeviceEncodedBatch on the encoder's device: bitwise the
    pixels batched_decode gives for the assembled blobs. B4 reads its
    lane windows in place from the encoder's chunk bytes (its handoff
    mode), with the encoder's own tables (Annex K, quant tables scaled
    to the encode quality); the only upload is the small descriptor,
    table and scalar arrays. For "sdr" only the base lanes are decoded,
    then B5 and B7; "planes" ends in B18 instead of B6. A mesh's handoff
    (a tuple of one DeviceEncodedBatch per shard, each on its `mesh`
    device) decodes shard by shard into a ShardedBatch."""
    single = isinstance(handoff, DeviceEncodedBatch)
    hands = (handoff,) if single else tuple(handoff)
    if mesh is not None and (len(hands) != len(mesh) or any(
            h.streams.base.device != d for h, d in zip(hands, mesh.devices))):
        raise ValueError(f"the handoff's shards do not lie on {mesh}")
    out = [_decode_handoff(h, output_format, max_display_boost, use_luts)
           for h in hands]
    return out[0] if single and mesh is None else ShardedBatch(out)


def _decode_handoff(handoff: DeviceEncodedBatch, output_format: str,
                    max_display_boost: float, use_luts: bool) -> torch.Tensor:
    s = handoff.streams
    dev = s.base.device
    n = handoff.base_bits.shape[0]
    w, h = s.width, s.height
    sdr = output_format == "sdr"
    qt = quant_tables(handoff.quality)[:2 if sdr else 3]
    q = np.broadcast_to(np.stack([t.reshape(64) for t in qt]).astype(
        np.int32), (n, len(qt), 64)).copy()
    base_lanes = _handoff_lanes(handoff.base_bits, dd.ANNEX_K_COLOR)
    if sdr:
        bf, bl, bt, qd = _upload([*base_lanes, q], dev)
        grids = dd.decode_rst_chunks(s.base, bf, bl, bt, False, (2, 2),
                                     w // 16, h // 16)
        return yuv420_to_rgba8888(*_planes(grids, qd, (w, h, 0, 0)))
    sc = np.broadcast_to(handoff_apply_scalars(handoff, max_display_boost),
                         (n, 4)).copy()
    arrays = (base_lanes + _handoff_lanes(handoff.gm_bits, dd.ANNEX_K_GRAY)
              + (q, sc))
    bf, bl, bt, gf, gl, gt, qd, sd = _upload(arrays, dev)
    gw, gh = w // 4, h // 4
    grids = (dd.decode_rst_chunks(s.base, bf, bl, bt, False, (2, 2),
                                  w // 16, h // 16)
             + dd.decode_rst_chunks(s.gm, gf, gl, gt, True, (1, 1),
                                    -(-gw // 8), -(-gh // 8)))
    planes = _planes(grids, qd, (w, h, gw, gh))
    if output_format == "planes":
        return planes_composite(*planes)
    return apply_gainmap(*planes, sd, output_format, use_luts)


# ---------------------------------------------------------------------------
# Apply over a raw batch.
# ---------------------------------------------------------------------------

def batched_apply_gainmap(y8_batch, u8_batch, v8_batch, gmap_batch,
                          metadata: GainMapMetadata, output_format: str,
                          max_display_boost: float,
                          device="cuda", mesh=None):
    """B6 over a leading batch dimension (JAX sharding.py:1351
    batched_apply_gainmap): uint8 planes Y (n, h, w), U/V (n, h/2, w/2)
    and gain maps (n, mh, mw), numpy arrays (uploaded in one transfer)
    or tensors (moved to `device`), with one metadata and display boost
    for the batch -> the HDR pixels of ops/gainmap.py:apply_gainmap on
    `device`; with a mesh, each shard's planes go to its device and the
    pixels come back as a ShardedBatch."""
    one, mesh = mesh is None, mesh_for(mesh, device)
    planes = (y8_batch, u8_batch, v8_batch, gmap_batch)
    out = [_apply_shard([p[sl] for p in planes], metadata, output_format,
                        max_display_boost, d)
           for sl, d in zip(mesh.shards(len(y8_batch)), mesh.devices)]
    return out[0] if one else ShardedBatch(out)


def _apply_shard(planes, metadata: GainMapMetadata, output_format: str,
                 max_display_boost: float, dev) -> torch.Tensor:
    """batched_apply_gainmap over one shard's planes on `dev`."""
    if all(isinstance(p, torch.Tensor) for p in planes):
        planes = [p.to(dev) for p in planes]
    else:
        planes = _upload([np.ascontiguousarray(
            p.cpu().numpy() if isinstance(p, torch.Tensor) else p, np.uint8)
            for p in planes], dev)
    n = planes[0].shape[0]
    sc = torch.from_numpy(np.tile(apply_scalars(
        metadata, max_display_boost), (n, 1))).to(dev)
    return apply_gainmap(*planes, sc, output_format)
