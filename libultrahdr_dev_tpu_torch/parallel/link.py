"""The serving loop's host<->device links: the packed P010 upload, the
packed pixel readbacks and the host-apply decode.

The port of libultrahdr_dev_tpu/parallel/sharding.py:47-148
(pack_p010_host, _unpack_p010_device = kernel B0, _split_p010_stack_fn
= fused into B14, pack_p010_batch_host, upload_p010_batch), :151-312
(fetch_1010102_packed, fetch_f16_packed, fetch_pixels_packed) and
:312-422 (hostapply_available, apply_planes_host,
decode_batch_hostapply).

- Upload: ``pack_p010_batch_host`` stacks a batch's y and uv planes
  into one tall 10-bit plane and segment-packs it on the host
  (parallel/packio.py pack_plane_host); ``upload_p010_batch`` copies the
  one u32 blob to the device, where B14 rebuilds the MSB-aligned y and
  uv batches. Content the pack does not shrink below 90% of the dense
  10-bit layout (noise), or a geometry outside the pack's 32-row groups,
  goes dense instead: high bytes plus 2-bit tails, rebuilt by B0 (the
  content rule of sharding.py:97-104, counted as "h2d_dense").
- Pixels to the host: a decoded RGBA1010102 batch through the RCT +
  Rice pack (parallel/packio.py fetch_rgba1010102_auto: B15, B16 at 10
  bits), else the RCT fine-width pack (fetch_rgba1010102_batch: B17),
  else a raw copy; an F16 batch through the Rice bit-pattern pack (B15,
  B16 at 16 bits), else a raw copy. A pack that would not save 15%
  declines and the raw copy is used, as in JAX; a kernel or unpack that
  fails raises (JAX's ``except Exception`` fallbacks are not ported).
- A mesh (parallel/mesh.py): the upload packs and copies each shard's
  frames to its own device (a blob a shard, rebuilt there by B14 or B0)
  and gives ShardedBatches; every readback takes a ShardedBatch and
  reads it back shard by shard into one host array.
- Decode to host pixels with the host apply: the device decodes to the
  u8 planes composite
  (batched.py, output "planes": B4, B5, B18), the planar Rice readback
  (packio.fetch_planes_u8: B15, B16, the native unpack) brings it to
  the host, and ops/apply.cpp applies the gain map there
  (``apply_planes_host``), within 1 ten-bit code / 1 F16 ULP of the
  device's B6.

The native host code is built at first use (jpeg/native.py) and a
failed build raises: unlike JAX, ``hostapply_available`` does not
answer False for a missing library. ``apply_planes_host`` checks the
composite's size before the native call.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import upload as _upload
from ..jpeg import native
from ..utils import counters
from ..utils.log import get_logger
from . import batched, packio
from .mesh import ShardedBatch, merge_stats, mesh_for

_HOSTAPPLY_MODES = {"hdr_linear": 0, "hdr_hlg": 1, "hdr_pq": 2}


# ---------------------------------------------------------------------------
# Upload.
# ---------------------------------------------------------------------------

def pack_p010_host(plane_u16: np.ndarray):
    """Dense 10-bit layout of P010 samples for upload: the high 8 bits
    (uint8, same shape) and the 2-bit tails, four to a byte (uint8,
    last dim / 4). The last dim must be a multiple of 4."""
    v = (np.asarray(plane_u16) >> 6).astype(np.uint16)
    hi = (v >> 2).astype(np.uint8)
    lo = (v & 3).astype(np.uint8)
    lo4 = lo.reshape(*lo.shape[:-1], lo.shape[-1] // 4, 4)
    lob = (lo4[..., 0] | (lo4[..., 1] << 2) | (lo4[..., 2] << 4)
           | (lo4[..., 3] << 6))
    return hi, np.ascontiguousarray(lob)


def pack_p010_batch_host(p010_y_batch, p010_uv_batch, mesh=None):
    """Host half of the packed upload of uint16 P010 batches y (n, h, w)
    and uv (n, h/2, w): ("seg", PackedPlane, blob, n, h, w) when the
    segment pack of the tall plane pays, else ("dense", (y hi, y lo),
    (uv hi, uv lo), n, h, w); with a mesh, the list of each shard's.
    Pure host work: a caller can overlap it with the previous batch's
    device work in a thread."""
    y, uv = np.asarray(p010_y_batch), np.asarray(p010_uv_batch)
    if mesh is None:
        return _pack_shard(y, uv)
    return [_pack_shard(y[sl], uv[sl]) for sl in mesh.shards(len(y))]


def _pack_shard(y: np.ndarray, uv: np.ndarray):
    """pack_p010_batch_host of one shard's frames."""
    n, h, w = y.shape
    dense_bytes = (y.size + uv.size) * 10 // 8
    if h % 64 == 0 and w % 16 == 0:
        big = np.concatenate([(y >> 6).reshape(n * h, w),
                              (uv >> 6).reshape(n * (h // 2), w)])
        packed = packio.pack_plane_host(big)
        if packed.nbytes() < 0.9 * dense_bytes:
            return ("seg", packed, packed.to_blob(), n, h, w)
    counters.bump("h2d_dense")
    return ("dense", pack_p010_host(y), pack_p010_host(uv), n, h, w)


def upload_p010_batch(p010_y_batch, p010_uv_batch, stats=None,
                      prepacked=None, device="cuda", mesh=None):
    """Upload a P010 batch in ONE host-to-device copy and rebuild it on
    `device`: the segment blob through B14, or the dense layout through
    B0. `prepacked` is pack_p010_batch_host's result (else it is packed
    here). Returns (y, uv, h2d_bytes): MSB-aligned int16 batches (n, h,
    w) and (n, h/2, w) on the device. `stats` gains h2d_bytes, h2d_pack
    ("seg" | "dense") and h2d_ms (the enqueue time; the copy itself with
    UHDR_FETCH_SYNC_STAGES=1). With a mesh, one copy and one B14 (or B0)
    a shard on its device: y and uv are ShardedBatches, and h2d_pack
    joins the shards' distinct packs with "+"; `prepacked` is then
    pack_p010_batch_host's list for the mesh."""
    one, mesh = mesh is None, mesh_for(mesh, device)
    if prepacked is None:
        prepacked = pack_p010_batch_host(p010_y_batch, p010_uv_batch, mesh)
    elif one:
        prepacked = [prepacked]
    parts = [{} for _ in prepacked]
    outs = [_upload_shard(pre, d, st)
            for pre, d, st in zip(prepacked, mesh.devices, parts)]
    merge_stats(stats, parts)
    nbytes = sum(o[2] for o in outs)
    if one:
        return outs[0][0], outs[0][1], nbytes
    return (ShardedBatch(o[0] for o in outs),
            ShardedBatch(o[1] for o in outs), nbytes)


def _upload_shard(pre, dev, stats: dict):
    """upload_p010_batch of one shard's packed frames to `dev`."""
    t0 = time.perf_counter()
    sync = os.environ.get("UHDR_FETCH_SYNC_STAGES") == "1" \
        and dev.type == "cuda"
    if pre[0] == "seg":
        _, packed, blob, n, h, w = pre
        blob_dev = torch.from_numpy(blob.view(np.int32)).to(dev)
        if sync:
            torch.cuda.synchronize(dev)
        ydev, uvdev = packio.unpack_plane_device(blob_dev, packed.plan, n, h)
        nbytes = blob.nbytes
    else:
        _, (yh, yl), (uh, ul), n, h, w = pre
        parts = _upload([yh, yl, uh, ul], dev)
        if sync:
            torch.cuda.synchronize(dev)
        ydev, uvdev = packio.unpack_p010_dense(*parts)
        nbytes = yh.nbytes + yl.nbytes + uh.nbytes + ul.nbytes
    stats["h2d_bytes"] = nbytes
    stats["h2d_pack"] = pre[0]
    stats["h2d_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    return ydev, uvdev, nbytes


# ---------------------------------------------------------------------------
# Packed pixel readbacks.
# ---------------------------------------------------------------------------

def _raw_copy(out_dev: torch.Tensor) -> np.ndarray:
    a = out_dev.cpu().numpy()
    return a.view({np.dtype(np.int32): np.uint32,
                   np.dtype(np.int16): np.uint16}.get(a.dtype, a.dtype))


def _per_shard(fetch, batch: ShardedBatch, stats, *args) -> np.ndarray:
    """`fetch` over each shard of a ShardedBatch in turn, in the calling
    thread (its per-thread fetch state is the last shard's), the host
    arrays joined in batch order and the shards' stats merged."""
    parts = [{} for _ in batch.shards]
    out = [fetch(s, st, *args) for s, st in zip(batch.shards, parts)]
    merge_stats(stats, parts)
    return out[0] if len(out) == 1 else np.concatenate(out)


def _account(stats, nbytes: int, pack: str):
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + int(nbytes)
        stats["d2h_pack"] = pack
        if pack != "raw":
            stats["d2h_stages"] = dict(packio.last_fetch()[0])


def fetch_1010102_packed(out_dev: torch.Tensor, stats=None) -> np.ndarray:
    """An (n, h, w) int32 RGBA1010102 batch on the device to host uint32
    pixels through a lossless pack: RCT + Rice with the scheme
    auto-picked, else RCT + fine widths, else the raw copy (content that
    does not compress). `stats` gains d2h_bytes (every byte that crossed,
    the maps of a declined pack included), d2h_pack and d2h_stages. Alpha
    comes back as the packers' constant 0xC0000000 (ops/color.py
    pack_rgba1010102 writes the same)."""
    if isinstance(out_dev, ShardedBatch):
        return _per_shard(fetch_1010102_packed, out_dev, stats)
    out, nbytes = packio.fetch_rgba1010102_auto(out_dev)
    wasted, mode = 0, f"rct-rice-auto({packio.last_fetch()[1]})"
    if out is None:
        wasted += nbytes
        get_logger().debug("rice readback declined; fine-width pack")
        out, nbytes = packio.fetch_rgba1010102_batch(out_dev)
        mode = "rct-seg"
    if out is None:
        wasted += nbytes
        out = _raw_copy(out_dev)
        nbytes, mode = out.nbytes, "raw"
    _account(stats, nbytes + wasted, mode)
    return out


def fetch_f16_packed(out_dev: torch.Tensor, stats=None) -> np.ndarray:
    """An (n, h, w, 4) int16 RGBA F16 batch (half bits) on the device to
    host uint16 halves through the RCT + Rice bit-pattern pack, scheme
    auto-picked, else the raw copy. `stats` as fetch_1010102_packed's.
    Alpha comes back as the packer's constant 0x3C00 (1.0)."""
    if isinstance(out_dev, ShardedBatch):
        return _per_shard(fetch_f16_packed, out_dev, stats)
    out, nbytes = packio.fetch_rgba_f16_auto(out_dev)
    wasted, mode = 0, f"rct-rice16-auto({packio.last_fetch()[1]})"
    if out is None:
        wasted += nbytes
        out = _raw_copy(out_dev)
        nbytes, mode = out.nbytes, "raw"
    _account(stats, nbytes + wasted, mode)
    return out


def fetch_pixels_packed(arr, stats=None, fmt=None):
    """A decode output to the host, through the packed readback where the
    caller names a packable format: fmt "rgba1010102" (or
    PixelFormat.RGBA1010102) with an int32 (h, w) or (n, h, w) tensor ->
    fetch_1010102_packed; fmt "rgba_f16" / "rgbaf16" with an int16
    (h, w, 4) or (n, h, w, 4) tensor -> fetch_f16_packed (a single image
    rides with a unit batch axis). Any other format, or none, is a raw
    copy: the packers re-attach a format's alpha constant, so routing on
    dtype alone would corrupt look-alike layouts (SDR RGBA8888 is int32
    too). A numpy array is already on the host and is returned as it
    is."""
    name = getattr(fmt, "value", fmt)
    if name == "rgbaf16":
        name = "rgba_f16"
    if isinstance(arr, ShardedBatch):
        return _per_shard(fetch_pixels_packed, arr, stats, fmt)
    if isinstance(arr, np.ndarray):
        if stats is not None:
            stats.setdefault("d2h_bytes", 0)
            stats["d2h_pack"] = "host"
        return arr
    shape = tuple(arr.shape)
    if (name == "rgba1010102" and arr.dtype == torch.int32
            and len(shape) in (2, 3)):
        one = len(shape) == 2
        out = fetch_1010102_packed(arr[None] if one else arr, stats)
        return out[0] if one else out
    if (name == "rgba_f16" and arr.dtype == torch.int16
            and len(shape) in (3, 4) and shape[-1] == 4):
        one = len(shape) == 3
        out = fetch_f16_packed(arr[None] if one else arr, stats)
        return out[0] if one else out
    out = _raw_copy(arr)
    _account(stats, out.nbytes, "raw")
    return out


# ---------------------------------------------------------------------------
# Host-apply decode.
# ---------------------------------------------------------------------------

def hostapply_available(output_format: str) -> bool:
    """True for the output formats the host apply serves (F16 linear,
    HLG and PQ RGBA1010102)."""
    return output_format in _HOSTAPPLY_MODES


def apply_planes_host(comp, scalars, h: int, w: int, gh: int, gw: int,
                      output_format: str, stats=None) -> np.ndarray:
    """Native gain-map apply (ops/apply.cpp) over a host (n, rows, wc)
    u8 planes composite of frames h x w with a gh x gw gain map ->
    (n, h, w, 4) uint16 F16 halves for "hdr_linear", (n, h, w) uint32
    RGBA1010102 for "hdr_hlg" / "hdr_pq". `scalars` is the (n, 4) float32
    [log2 min boost, log2 max boost, boost factor, display boost] block.
    The composite's size is checked first; `stats` gains host_apply_ms.
    Threads: UHDR_UNPACK_THREADS (default min(cores, 4))."""
    if output_format not in _HOSTAPPLY_MODES:
        raise ValueError(f"host apply does not serve {output_format}")
    mode = _HOSTAPPLY_MODES[output_format]
    comp = np.ascontiguousarray(comp)
    if comp.dtype != np.uint8 or comp.ndim != 3:
        raise ValueError(f"expected an (n, rows, wc) uint8 composite, got "
                         f"{comp.dtype} {comp.shape}")
    n, rows, stride = comp.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if min(h, w, gh, gw) <= 0 or w % gw:
        raise ValueError(f"bad geometry {w}x{h} with a {gw}x{gh} map")
    if rows < h + ch + gh or stride < max(w, 2 * cw, gw):
        raise ValueError(f"composite {rows}x{stride} is short for {w}x{h} "
                         f"+ {cw}x{ch} chroma + {gw}x{gh} gain map")
    sc = np.ascontiguousarray(scalars, np.float32)
    if sc.shape != (n, 4):
        raise ValueError(f"scalars {sc.shape} != ({n}, 4)")
    out = (np.empty((n, h, w, 4), np.uint16) if mode == 0
           else np.empty((n, h, w), np.uint32))
    lib = native.get_apply()
    nt = packio._unpack_threads()
    t0 = time.perf_counter()
    for i in range(n):
        rc = lib.uhdr_apply_gainmap(
            comp[i].ctypes.data, stride, h, w, ch, cw, gh, gw, w // gw,
            float(sc[i, 0]), float(sc[i, 1]), float(sc[i, 2]),
            float(sc[i, 3]), mode, out[i].ctypes.data, nt)
        if rc != 0:
            raise RuntimeError(f"uhdr_apply_gainmap rc={rc}")
    if stats is not None:
        stats["host_apply_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    return out


def fetch_planes(comp_dev: torch.Tensor, stats=None) -> np.ndarray:
    """The planes composite to the host: the Rice readback, or the raw
    copy when the pack declines. `stats` gains d2h_bytes (every byte
    that crossed, the map of a declined pack included), d2h_pack and
    fetch_stages."""
    if isinstance(comp_dev, ShardedBatch):
        return _per_shard(fetch_planes, comp_dev, stats)
    comp, nbytes = packio.fetch_planes_u8(comp_dev)
    pack = f"planes-rice-auto({packio.last_fetch()[1]})"
    if comp is None:
        comp = comp_dev.cpu().numpy()
        nbytes += comp.nbytes
        pack = "planes-raw"
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + int(nbytes)
        stats["d2h_pack"] = pack
        stats["fetch_stages"] = dict(packio.last_fetch()[0])
    return comp


def decode_batch_hostapply(blobs, output_format: str,
                           max_display_boost: float, stats=None,
                           handoff=None, device="cuda", mesh=None):
    """Decode a batch all the way to host pixels through the planes
    readback: the device decodes (B4, B5) and emits the u8 composite
    (B18), the Rice readback brings it over, the host applies the gain
    map. From `blobs` (same-size JPEG/R of this codec) or, with
    `handoff` (batched.DeviceEncodedBatch), straight off the encoder's
    streams on their device. Returns apply_planes_host's pixels, or None
    where JAX's route does not apply (an output format the host apply
    does not serve, or blobs that need the host Huffman decoder): the
    caller then decodes on the device (batched.batched_decode). With a
    mesh, each shard decodes on its device (from its blobs, or from its
    DeviceEncodedBatch of a mesh encode's tuple) and the composites come
    back shard by shard; the host apply takes the whole batch."""
    if not hostapply_available(output_format):
        return None
    if handoff is not None:
        comp_dev = batched.batched_decode_from_handoff(
            handoff, "planes", max_display_boost, mesh=mesh)
        n = int(comp_dev.shape[0])
        scalars = np.broadcast_to(batched.handoff_apply_scalars(
            handoff, max_display_boost), (n, 4))
        s = (handoff if isinstance(handoff, batched.DeviceEncodedBatch)
             else handoff[0]).streams
        w, h, gw, gh = s.width, s.height, s.width // 4, s.height // 4
    else:
        frames = batched.decode_host_stage(blobs, "planes",
                                           mesh_for(mesh, device))
        if frames[0].streams is None:
            return None
        meta = {}
        comp_dev = batched.decode_device_stage(
            frames, "planes", max_display_boost, device, meta_out=meta,
            mesh=mesh)
        w, h, gw, gh = meta["w"], meta["h"], meta["gw"], meta["gh"]
        scalars = meta["scalars"]
    return apply_planes_host(fetch_planes(comp_dev, stats), scalars, h, w,
                             gh, gw, output_format, stats)
