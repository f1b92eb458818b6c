"""Batched JPEG/R serving loop: encode a batch of P010 frames and decode
it back to host pixels, round after round, with three stages in flight.
The port of examples/serving_loop.py (the JAX package's loop, which
bench.py times as its headline):

  pack thread  : host pack of batch N+1's P010 planes and its upload
                 (parallel/link.py: the segment pack and B14, or the
                 dense layout and B0)
  main thread  : API-0 encode of batch N from the device (B1, B2, B3)
                 and its handoff decode to the u8 planes composite
                 (B4, B5, B18)
  fetch threads: the planar Rice readback of batch N-1 (B15, B16, the
                 native unpack) and the gain-map apply on the host; or,
                 with --no-hostapply, the device applies the gain map
                 (B6) in the main thread and the fetch threads read the
                 pixels back packed (parallel/link.py
                 fetch_1010102_packed: B15, B16 at 10 bits, else B17;
                 fetch_f16_packed: B15, B16 at 16 bits)

Run with synthetic 4080x3072 frames, batch 4, four rounds, HLG output,
on every visible CUDA GPU (parallel/mesh.py default_mesh, as the JAX
loop runs on sharding.default_mesh(); each GPU takes a contiguous shard
of the batch, which must be a multiple of the GPU count; one GPU takes
the whole batch as one shard):

    python -m libultrahdr_dev_tpu_torch.serving

or on the CPU (the kernels' plain versions) with small frames:

    python -m libultrahdr_dev_tpu_torch.serving --cpu --height 64 --width 96

--f16 decodes to linear RGBA F16 instead of HLG RGBA1010102;
--no-hostapply applies the gain map on the device and reads the pixels
back packed.
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .parallel import batched, link
from .parallel.mesh import default_mesh, mesh_for

BOOST = 1000 / 203   # the loop's display boost (HLG peak over SDR white)


def synth_p010(n: int, h: int, w: int, seed: int = 0):
    """The JAX loop's synthetic frames: 16x16 blocks of random luma,
    neutral chroma; uint16 P010 (n, h, w) and (n, h/2, w)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (n, h // 16 + 1, w // 16 + 1))
    y = np.kron(small, np.ones((1, 16, 16)))[:, :h, :w]
    y = np.clip(y, 64, 940).astype(np.uint16) << 6
    uv = np.full((n, h // 2, w), 512 << 6, np.uint16)
    return y, uv


@dataclass
class ServeResult:
    """What a run leaves: the last round's pixels (uint32 RGBA1010102 or
    uint16 F16 halves, host), its fetched composite and the device
    composite it came from (with --no-hostapply: the fetched pixels
    again and the device pixels), its blobs and apply scalars (None with
    --no-hostapply); every round's upload and fetch stats; the intervals
    between pixel completions in ms per frame (the last one a flush that
    overlaps no device work)."""

    pixels: np.ndarray
    comp: np.ndarray
    comp_dev: object
    blobs: list
    scalars: np.ndarray
    stats: list = field(default_factory=list)
    intervals_ms: list = field(default_factory=list)


def run(batch: int = 4, height: int = 3072, width: int = 4080,
        rounds: int = 4, f16: bool = False, device=None, frames=None,
        log=print, hostapply: bool = True, mesh=None) -> ServeResult:
    """Serve `rounds` rounds of one batch (`frames` = (y, uv) uint16
    P010 batches, else synth_p010's) on `mesh`, else on `device` alone,
    else on default_mesh() (every visible CUDA GPU); the batch must be a
    multiple of the mesh size. hostapply=False is --no-hostapply."""
    if mesh is None and device is None:
        mesh = default_mesh()
    ys, uvs = frames if frames is not None else synth_p010(batch, height,
                                                           width)
    n, h, w = ys.shape
    mesh_for(mesh, device).shards(n)
    out_fmt = "hdr_linear" if f16 else "hdr_hlg"
    gw, gh = w // 4, h // 4

    def pack_and_upload():
        st = {}
        pre = link.pack_p010_batch_host(ys, uvs, mesh)
        y, uv, _ = link.upload_p010_batch(ys, uvs, st, pre, device, mesh)
        return y, uv, st

    def fetch(comp_dev, scalars, st):
        if not hostapply:
            pixels = (link.fetch_f16_packed if f16
                      else link.fetch_1010102_packed)(comp_dev, st)
            return pixels, pixels
        comp = link.fetch_planes(comp_dev, st)
        return link.apply_planes_host(comp, scalars, h, w, gh, gw, out_fmt,
                                      st), comp

    dec_fmt = "planes" if hostapply else out_fmt

    t_pix, stats = [], []
    last = None
    # Two fetch workers let batch N's copy to the host overlap batch
    # N-1's native unpack and apply (both release the GIL); the futures
    # keep the order.
    with ThreadPoolExecutor(1) as pack_pool, \
            ThreadPoolExecutor(2) as fetch_pool:
        pk = pack_pool.submit(pack_and_upload)
        fetch_fut = None
        for r in range(rounds):
            ydev, uvdev, st = pk.result()
            if r + 1 < rounds:
                pk = pack_pool.submit(pack_and_upload)
            blobs, handoff = batched.batched_encode_api0(
                None, None, device_input=(ydev, uvdev),
                return_handoff=True, stats=st, mesh=mesh)
            scalars = None
            if handoff is not None:
                comp_dev = batched.batched_decode_from_handoff(
                    handoff, dec_fmt, BOOST, mesh=mesh)
                if hostapply:
                    scalars = np.broadcast_to(batched.handoff_apply_scalars(
                        handoff, BOOST), (n, 4))
            else:   # dense content: restart-less blobs, decoded as blobs
                meta = {}
                parsed = batched.decode_host_stage(blobs, dec_fmt, mesh)
                comp_dev = batched.decode_device_stage(
                    parsed, dec_fmt, BOOST, device, meta_out=meta, mesh=mesh)
                if hostapply:
                    scalars = meta["scalars"]
            if fetch_fut is not None:
                pixels, _ = fetch_fut.result()
                t_pix.append(time.perf_counter())
                log(f"round {r - 1}: {pixels.shape} pixels ready, "
                    f"{len(blobs[0])} B/JPEG-R")
            stats.append(st)
            fetch_fut = fetch_pool.submit(fetch, comp_dev, scalars, st)
            last = (comp_dev, blobs, scalars)
        pixels, comp = fetch_fut.result()
        t_pix.append(time.perf_counter())
        log(f"round {rounds - 1}: {pixels.shape} pixels ready")
    intervals = [(b - a) * 1e3 / n for a, b in zip(t_pix, t_pix[1:])]
    if intervals:
        log(f"steady-state cadence: "
            f"{(t_pix[-1] - t_pix[0]) * 1e3 / (len(intervals) * n):.1f} "
            f"ms/frame")
    return ServeResult(pixels, comp, last[0], last[1], last[2], stats,
                       intervals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions; "
                         "small frames advised)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=3072)
    ap.add_argument("--width", type=int, default=4080)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--f16", action="store_true",
                    help="decode to linear RGBA F16 (the reference's "
                         "default decode output) instead of HLG "
                         "RGBA1010102")
    ap.add_argument("--no-hostapply", action="store_true",
                    help="apply the gain map on the device and read the "
                         "pixels back packed, instead of reading the "
                         "decoded planes back and applying on the host")
    args = ap.parse_args(argv)
    run(args.batch, args.height, args.width, args.rounds, args.f16,
        "cpu" if args.cpu else None, hostapply=not args.no_hostapply)
    return 0


if __name__ == "__main__":
    sys.exit(main())
