#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from kernels/csrc with nvcc (one nvcc
per source, in parallel), checks each of the thirty-one (B0-B7, B6's
10-bit planar arm, B9, B10a, B10b, B10c, B11, B12, B12-enc, B13, B14,
B15 and B16 at 8, 10 and 16 bits, B17's two passes, B18, B19, B21's two
passes, B22)
against its plain PyTorch version at the shapes of the main path (a
4080x3072 frame, batch of 2; the general routes' B10, B12, B12-enc and
B19 and the converter's B13 at one 4000x3000 frame; the serving loop's
B0, B14, B15, B16, B17, B18 and B21 at a batch of 4), drives the
serving loop (packed upload, encode, planes decode, planar Rice
readback, host gain-map apply; and with --no-hostapply the device
apply and the packed pixel readbacks), the command-line tool (encode,
decode through fetch_pixels_packed) and the API-0
round trip, the API-1 encode, SDR decode, table-transfer (use_luts)
decode, the general encode routes (non-16-aligned and EXIF encodes,
API-2/3/4/x, encode_jpeg with and without restart intervals), the
UltraHdr converter (a JPEG/R edited by an effect chain into a JPEG/R
and raw pixels) and dense content (API-0 written restart-less, API-1 on
the general route) through the entry points a user calls (batched
encode/decode, the encode -> decode handoff, JpegR, UhdrEncoder /
UhdrDecoder, UltraHdr, and the decode of the reference goldens in
tests/goldens), checks what comes out, and times the kernels and the
stages.

Phases: B1 (HLG and PQ, timed; also at a width of 1296 and on
full-range codes), B2 (bitwise), B5, B6 (with its 10-bit planar arm),
B11, B7 kernel vs plain (B2 and B5 timed by CUDA-graph replay; B6, B11
and B7 also at odd widths and heights; B7 also on a 4001x2999 frame, a
1080x1920 and a 1081-wide editor output and all-0 and all-255 content,
each bitwise); the exactly rounded pow of B6,
B11, B1, B9 and B10b (pow_exact = pow_rn bitwise over every float32 its
call sites can receive, the PQ inverse OETF's exponents among them, the
share that took its double path, both pows' float64 instructions in the
SASS and their times); B2's
tensor-core premise (every row sum of its bf16 mma exact on two
adversarial rows of each of the 1,536 (term, row, output column)
triples and on sharp-edged blocks, then B2 = plain bitwise on those
blocks, on the 1,179,648 blocks of tests/test_torch_dct.py's bitwise
cases and on its dense HLG V plane; HMMA in B2's SASS); B3 (Huffman
encode) kernel vs plain (also at intervals of 43 and 300 MCUs) and its
JPEG/R bytes vs the host-Huffman route;
B9 (API-1 front end) kernel vs plain (also at a width of 1296) and its
JPEG/R bytes vs the host-Huffman route; B4 (Huffman decode) kernel vs plain vs the host
decoder on the port's streams, on the restart-less goldens (DC carry),
on garbage (also lanes at every start byte mod 4 and start bit, windows
ending mid-word and at the stream's end), on DHTs with 1- and 16-bit
codes and on two frames with different DHTs in one launch; B22 (the
decode's log emission) on the same inputs, the handoff, garbage lanes
cut short, a truncated stream and flat (DC-only) content: B22 kernel =
B22 plain = B4 kernel, timed beside B4 in turns with its pass split;
B10 (B10a tonemap and B10c re-encode bit-exact,
B10b in five variants); B12 (decode_jpeg's device route on gray,
4:2:0, 4:2:2, 4:4:4 and a restart-marked 4:2:0 stream: kernels = plain
= host-Huffman route, B22 then B5 = B4 then B5); B13 (each single
effect, the converter's 4-step chain (one launch per image: 2 for frame
and map) and a chain longer than one launch on a 4000x3000 YUV420 frame
and its 1000x750 gain map; the edges of its tiles: a 4001x2999 frame
with 2001x1500 chroma, a 1081-wide crop at an unaligned left edge, a
2x resize up, quarter turns of sides that are no multiple of a tile, a
monochrome image; all bitwise equal to the plain version); B19
(restart-less Huffman encode) on the general route's base and gain map,
encode_jpeg's 4:2:2 and 4:4:4 planes, edge-case blocks (edge_blocks)
over three frames of several 256-block tiles and a dense 4080x3072
batch: kernel = plain, finalized scans = the host coder's; B12-enc
(encode_jpeg's restart intervals) on gray, 4:2:0, 4:2:2 and 4:4:4 at r in
{1, 4, 17, 86, 300} (the last two longer than a B3 tile): kernel = plain
= the host coder with RSTn markers; B0 and B14 (the P010
upload: dense on uniform noise, segment-packed on bench content; B14
timed by CUDA graph and events, and at its edges: all zero, noise, a
partial segment of width 250, the y/uv split at group 2, three frames
of width 1000, content mixing zero segments and all three buckets), B18
(the planes composite of a decoded batch of 4, timed by CUDA graph and
events; and its edges: odd widths, h + ch + gh not a multiple of 3,
strided views at odd offsets, batches of 1 and 4), B15 and B16 (Rice
pass 1 and pack over that composite, vertical and MED, two-phase and
fused), bitwise; B15 and B16 at 10 and 16 bits (both schemes, two-phase
and fused), B17 and B21 on a decoded batch of 4, bitwise, each host
unpack = the device pixels (B17's order alone = the stable sort, its
rank totals = the host's counts, timed apart from the pack; B17's
widths pass timed by CUDA graph and events; and its edges: all zero,
noise, segment counts off the order's tile, several tiles, padding
rows that carry, a width of 1001 over 37 rows); the main-path windows
(API-0 round trip, handoff, goldens, the log-emission window: the API-0 blob decodes, the handoff
decode and decode_jpeg at 4000x3000 with the emission default set to
"log", each output = the dense route's, B22 launched and B4 not; API-1
encode + HDR decode, SDR decode, use_luts decode, general routes,
converter, dense content, the serving loop: four HLG rounds and one F16
round at batch 4, seg upload, fetched composite = the device's, host
apply within 1 code / ULP of the device apply, no plain-version call;
the readback window: --no-hostapply, three HLG and two F16 rounds, the
fine-width arm and pack_plane_device, every fetched batch = the
device's; the CLI window: a 4000x3000 encode decoded to RGBA1010102 and
F16, each file = the unpacked decode; the off-path window: arithmetic
encode and decode, a JPEG/R with an arithmetic primary, the committed
progressive fixture (tests/fixtures_torch) against its sidecar's grids
digest, and a multi-scan baseline file, at 4000x3000; the mesh window:
the batched entry points at 4080x3072, batch 4, as one-device calls and
then on default_mesh(), on two shards of cuda:0 and, with two GPUs, on
cuda:0 and cuda:1, each arm's bytes and pixels the one-device calls',
its launches the shard count times theirs), each with every
launch counter zeroed just before and read just after (each window's
kernels launched; no host Huffman call in any window but the off-path
one, whose host entropy calls are counted against what its formats
need: the general routes and the converter code each JPEG they generate
with B19); stage times (the decode stages under both emissions and the
off-path formats' host and device stages and each mesh arm's calls
among them) and the host cost of the launch guard (kernels/build.py
launch).

Under UHDR_DECODE_EMIT=log every decode runs B22, and each window's
need of B4 is read as a need of B22.

It needs one CUDA device and fails (exit code != 0, no result line)
without one; nothing falls back to the CPU. It imports nothing of JAX.

Output: progress lines, the card's name and power limit as nvidia-smi
reports them, a JSON line {"kernels": [...]}, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes.util
import gzip
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

W, H, FRAMES = 4080, 3072, 2
# The general encode routes and the plain-JPEG codec: one 12 MP 4:3
# camera frame, 3000 rows (not 16-aligned).
GW, GH = 4000, 3000
# The converter window's chain on the GW x GH frame (converter_chain):
# crop to rows CONV_ROWS, rotate 90, mirror, resize to CONV_SIZE (w, h).
CONV_ROWS = (376, 2624)
CONV_SIZE = (1080, 1920)
# The dense-content window: the side of a square of uniform noise in the
# second frame of its batch.
DENSE_PATCH = 256
SEED = 0
EXIF = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x00"
CONFIGS = (("bt2100", "hlg"), ("bt709", "pq"))
# API-1: (SDR gamut, HDR gamut, transfer).
API1_CONFIGS = (("bt709", "bt2100", "hlg"), ("p3", "bt2100", "pq"))
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "goldens")
# (golden encode, its F16 decode by the reference, display boost); the
# last two are checked against the host decode only.
GOLDEN_F16 = [(f"enc0_{g}_{t}.jpegr", f"dec0_{g}_{t}_f16.raw.gz",
               4.926108 if t == "hlg" else 49.261084)
              for g in ("709", "p3", "2100") for t in ("hlg", "pq")]
GOLDEN_OTHER = ["enc0_hlg.jpegr", "enc0_pq.jpegr"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # outside the tensor cores
FP64_FLOPS = 34e12          # H100 SXM data sheet, outside the tensor cores
BF16_TC_FLOPS = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
# The parent's times of the kernels this tree redesigned last (ms per
# frame; PR 14's last run of this script on an NVIDIA H100 80GB HBM3 at
# 700.00 W), printed beside this run's.
PARENT_MS = {"B7": 0.0712, "B13 crop 3600x2248": 0.0378,
             "B13 mirror horizontal": 0.0660, "B13 rotate 90": 0.1197,
             "B13 rotate 180": 0.0694, "B13 resize 1080x1920": 0.0222,
             "B13 converter chain": 0.0371}
# ... and of B17b and B18 (ms per frame of the batch of 4, CUDA events;
# the parent tree's last run of this script, same card and limit).
PARENT_MS.update({"B17b": 0.4284, "B18": 0.0650})
# ... and of B14 and B17a (ms per frame of the batch of 4, CUDA events,
# the parent tree's last run of this script, same card and limit; this
# run logs its events time beside them, while the kernels line's `ms` of
# these two is by CUDA graph).
PARENT_MS.update({"B14": 0.0392, "B17a": 0.1869})
# ... and of B21a (ms per frame of the batch of 4, CUDA events, the parent
# tree's last run of this script, same card and limit).
PARENT_MS.update({"B21a": 0.1489})

# Operations per sample, counted from the kernels' sources (the branch a
# sample usually takes): float32 operations (a fused multiply-add 2;
# add, multiply, min, max, compare, convert, sqrt, log, exp2 and divide
# 1 each), and the exactly rounded power laws at POW_F64_OPS float64
# operations each: apply.cu's pow_exact fast path (color.cuh: 14
# fused multiply-adds, 4 multiplies, 3 adds and the convert to float),
# counted the same way. Each row counts the least work known for its
# function, whatever the kernel that ran it: for B6 one pow a pixel
# (green; red and blue are reads of B6's sRGB tables, built once per
# device). encode_front.cu (B1, B9, B10b) computes its pows with the
# same pow_exact (pow_phase counts its and the double pow()'s float64
# instructions in the SASS).
POW_F64_OPS = 36
OPS = {
    # apply.cu per output pixel: 4 load/normalize, 14 YUV -> RGB, 3 +
    # 1 pow sRGB inverse OETF (red and blue: table reads), 17 gain-map
    # samples and blend (the Shepard weights are a per-launch table), 10
    # gain factor and scale, then 3 F16 converts, or 21 HLG OETF (+ 0
    # pow) / 21 PQ OETF (+ 6 pow) and 12 for the 10-bit pack.
    "B6 hdr_linear": (51, 1), "B6 hdr_hlg": (81, 1),
    "B6 hdr_pq": (81, 7),
    # B11: the table reads replace the transfer functions: 9 for the
    # sRGB index, 9 for the OETF index, no pow.
    "B11 hdr_linear": (61, 0), "B11 hdr_hlg": (79, 0),
    "B11 hdr_pq": (79, 0),
    # The 10-bit planar arm: F16's count less its 3 converts, plus a
    # clamp (2), multiply and convert per channel.
    "B6 hdr_linear_rgb_10bit": (60, 1),
    "B11 hdr_linear_rgb_10bit": (70, 0),
    # sdr_out.cu per output pixel: 5 converts, 8 colour matrix, 12
    # round/clip/convert (the integer upsample is not counted).
    "B7": (25, 0),
    # encode_front.cu per gain-map sample (HLG: 114 + 3 pow; PQ: 9 pow)
    # and per 2x2 quad of the BT.601 re-encode (63).
    "B9 map hlg": (114, 3), "B9 map pq": (114, 9), "B9 quad": (63, 0),
    # B10b is B9's map arm (the counts above); its table arm replaces the
    # six computed transfer functions (33 operations and every pow) by
    # six table indexes (4 each).
    "B10b lut": (105, 0),
}


def log(msg: str):
    print(msg, flush=True)


def synth_p010(n: int, h: int, w: int, seed: int):
    """Band-limited HDR content (the generator of bench.py), n frames of
    uint16 P010 luma (n, h, w) and interleaved CbCr (n, h/2, w)."""
    rng = np.random.default_rng(seed)
    ys, uvs = [], []
    for _ in range(n):
        small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
            np.float32)
        y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
        y = (y + np.roll(y, 7, 0) + np.roll(y, 7, 1)) / 3.0
        ys.append(np.clip(y, 64, 940).astype(np.uint16) << 6)
        c = rng.integers(448, 576, (h // 32 + 1, w // 32 + 1)).astype(
            np.float32)
        c = np.kron(c, np.ones((16, 32), np.float32))[:h // 2, :w // 2]
        uv = np.empty((h // 2, w), np.uint16)
        uv[:, 0::2] = np.clip(c, 64, 960).astype(np.uint16) << 6
        uv[:, 1::2] = np.clip(c[:, ::-1], 64, 960).astype(np.uint16) << 6
        uvs.append(uv)
    return np.stack(ys), np.stack(uvs)


def hdr_nits_reference(y_u16, uv_u16, gamut: str, tf: str):
    """Per-pixel luminance in nits of P010 HDR input, in float64 numpy,
    independent of the port: narrow-range YUV -> RGB -> inverse OETF ->
    luminance (BT.2100 / the reference's gainmapmath)."""
    y = ((y_u16 >> 6).astype(np.float64) - 64.0) / 876.0
    c = ((uv_u16 >> 6).astype(np.float64) - 64.0) / 896.0 - 0.5
    u = np.repeat(np.repeat(c[..., 0::2], 2, -2), 2, -1)
    v = np.repeat(np.repeat(c[..., 1::2], 2, -2), 2, -1)
    (kr, kg, kb), cb, cr = {
        "bt709": ((0.2126, 0.7152, 0.0722), 1.8556, 1.5748),
        "bt2100": ((0.2627, 0.6780, 0.0593), 1.8814, 1.4746)}[gamut]
    rgb = [np.clip(y + cr * v, 0, 1),
           np.clip(y - kb * cb / kg * u - kr * cr / kg * v, 0, 1),
           np.clip(y + cb * u, 0, 1)]
    if tf == "hlg":
        a, b, c0 = 0.17883277, 0.28466892, 0.55991073
        lin = [np.where(e <= 0.5, e * e / 3.0,
                        (np.exp((e - c0) / a) + b) / 12.0) for e in rgb]
        white = 1000.0
    else:
        m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
        c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 128.0, 2392.0 / 128.0
        lin = []
        for e in rgb:
            p = np.power(e, 1.0 / m2)
            lin.append(np.power(np.maximum(p - c1, 0) / (c2 - c3 * p),
                                1.0 / m1))
        white = 10000.0
    nits = (kr * lin[0] + kg * lin[1] + kb * lin[2]) * white
    return nits, white, (kr, kg, kb)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Warm, synchronized mean milliseconds per call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device milliseconds per call of fn's kernels alone: `iters` calls
    captured in one CUDA graph and replayed, so no host work (argument
    packing, allocation, the ctypes call) sits between the launches. For
    kernels shorter than their wrapper's host work, where cuda_ms
    measures the enqueue rate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device milliseconds per call of fn, by CUDA kernel, from a
    torch.profiler trace of `iters` warm calls: {kernel name: ms}, the
    names shortened to the function's (empty when the profiler records
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            key = e.key.replace("(anonymous namespace)::", "")
            name = key.split("(")[0].split("<")[0].split("::")[-1].strip()
            name = name.removeprefix("void ")  # a template's return type
            out[name or key] = out.get(name or key, 0.0) + us / 1e3 / iters
    return out


def log_breakdown(label: str, fn, iters: int, wall_ms: float):
    """Log fn's device time by kernel and the device's idle share of
    its wall time per call (`wall_ms`, synchronized)."""
    by = device_ms_by_kernel(fn, iters)
    if not by:
        log(f"{label}: device time by kernel not measured (the profiler "
            f"recorded none)")
        return
    busy = sum(by.values())
    log(f"{label}: device ms per call by kernel "
        f"{ {k: round(v, 4) for k, v in by.items()} }, busy {busy:.4f} of "
        f"{wall_ms:.4f} ms wall (idle share {1 - busy / wall_ms:.2f})")


def host_ms(fn, iters: int) -> float:
    """Warm mean milliseconds per call of work that ends synchronized."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


class Failure(Exception):
    pass


def require(cond: bool, what: str):
    if not cond:
        raise Failure(what)


def code_diff(a, b, fmt: str):
    """Per-channel |difference| of two output batches: F16 bits as
    integers (ULPs of same-sign halves), or the three 10-bit codes."""
    import torch

    if fmt == "hdr_linear":
        return (a[..., :3].to(torch.int32)
                - b[..., :3].to(torch.int32)).abs()
    if fmt == "hdr_linear_rgb_10bit":
        return (a.to(torch.int32) - b.to(torch.int32)).abs()
    return torch.stack([(((a >> s) & 1023) - ((b >> s) & 1023)).abs()
                        for s in (0, 10, 20)])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: float, flops: float = 0.0, dflops: float = 0.0,
          tc_flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: the largest of the bytes
    over the memory rate, the float32 operations over their peak rate,
    the float64 operations over theirs and the bf16 tensor-core
    operations over theirs."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, dflops / FP64_FLOPS,
                tc_flops / BF16_TC_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ops(key: str, samples: float) -> dict:
    """flops / dflops of `samples` samples of the work OPS[key] counts."""
    f32, pows = OPS[key]
    return dict(flops=f32 * samples, dflops=pows * POW_F64_OPS * samples)


def int_diff(a, b):
    """Max |a - b| and the count of differing elements."""
    import torch

    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()) if d.numel() else 0, int((d > 0).sum())


def _timed(label: str, run, per: int = FRAMES, iters: int = 20) -> dict:
    """ms per frame of `run` (`per` frames a call) by CUDA-graph replay,
    beside the CUDA-event time (which, for launches shorter than the
    wrappers' host work, measures the enqueue) and the profiler's device
    time by kernel."""
    ms = graph_ms(run, iters) / per
    enqueue_ms = cuda_ms(run, iters) / per
    by = {k: round(v / per, 4)
          for k, v in device_ms_by_kernel(run, 10).items()}
    log(f"{label}: {ms:.4f} ms/frame by CUDA graph, {enqueue_ms:.4f} by CUDA "
        f"events, device ms/frame by kernel {by or 'not measured'}")
    return dict(ms=ms, enqueue_ms=enqueue_ms)


# B1's edge width: 16-aligned, 162 tiles of 8 columns a row (no multiple
# of a CTA's 256 tiles).
B1_EDGE_W = 1296


def full_range_p010(n: int, h: int, w: int, seed: int):
    """P010 frames of full-range codes: luma constant over 8x8 blocks at
    10-bit 0, 1023 or a random code (the blocks at 0 and 1023 floor and
    saturate the gain codes), uniform random chroma over all 10-bit
    codes. uint16 (n, h, w) and (n, h/2, w)."""
    rng = np.random.default_rng(seed)
    lvl = rng.choice(np.array([0, 1023, -1]), (n, h // 8, w // 8))
    lvl = np.where(lvl < 0, rng.integers(0, 1024, lvl.shape), lvl)
    y = np.kron(lvl, np.ones((1, 8, 8), np.int64)).astype(np.uint16) << 6
    uv = rng.integers(0, 1024, (n, h // 2, w), dtype=np.uint16) << 6
    return y, uv


def b1_check(y, uv, gamut: str, tf: str, what: str,
             extremes: bool = False) -> int:
    """B1 against its plain version: gain codes <= 1 apart on <= 1e-4
    of samples, base planes <= 1 apart; with `extremes`, the input must
    give both the saturated and the floored gain code. Returns the max
    |diff|."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import color, gainmap as gm

    got = gm.encode_front(y, uv, gamut, tf)
    ref = gm.encode_front_plain(y, uv, gamut, tf)
    d = [(g.to(torch.int32) - r.to(torch.int32)).abs()
         for g, r in zip(got, ref)]
    n_off = int((d[0] > 0).sum())
    ends = ""
    if extremes:
        _, _, _, _, sat, floor = color.gain_code_params(
            1.0, color.hdr_inv_oetf_fn(tf)[1] / color.SDR_WHITE_NITS)
        n_sat, n_floor = (int((ref[0] == c).sum()) for c in (sat, floor))
        ends = f"; {n_sat} saturated ({sat}), {n_floor} floored ({floor})"
        require(n_sat > 0 and n_floor > 0, f"B1 {what} {gamut}/{tf}: the "
                f"input reaches no saturated or no floored gain code")
    log(f"B1 encode_front {what} {gamut}/{tf}: max |diff| gain "
        f"{int(d[0].max())} on {n_off} of {d[0].numel()} samples, planes "
        f"max {max(int(x.max()) for x in d[1:])}{ends}")
    require(int(d[0].max()) <= 1 and n_off <= 1e-4 * d[0].numel(),
            f"B1 {what} {gamut}/{tf}: gain codes disagree with the plain "
            f"version")
    require(all(int(x.max()) <= 1 for x in d[1:]),
            f"B1 {what} {gamut}/{tf}: base planes disagree with the plain "
            f"version")
    return max(int(x.max()) for x in d)


def b1_times(y, uv, gamut: str, tf: str) -> dict:
    """B1's kernels-line row for one configuration: ms per frame by CUDA
    events (and by CUDA graph), the plain version's, the bytes and the
    operations (OPS: the gain-map samples and the re-encoded quads)."""
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    n, h, w = y.shape
    out = gm.encode_front(y, uv, gamut, tf)
    samples = ops(f"B9 map {tf}", (h // 4) * (w // 4))
    quads = ops("B9 quad", (h // 2) * (w // 2))
    row = dict(
        err=0, ms=cuda_ms(lambda: gm.encode_front(y, uv, gamut, tf), 20) / n,
        graph_ms=graph_ms(lambda: gm.encode_front(y, uv, gamut, tf), 20) / n,
        plain_ms=cuda_ms(lambda: gm.encode_front_plain(y, uv, gamut, tf), 3)
        / n, bytes=nbytes(y, uv, *out) / n, library_ms=None,
        flops=samples["flops"] + quads["flops"], dflops=samples["dflops"])
    t_bytes = bound(row["bytes"])[0]
    t_ops = bound(0.0, row["flops"], row["dflops"])[0]
    log(f"B1 {gamut}/{tf}: kernel {row['ms']:.4f} ms/frame by CUDA events "
        f"({row['graph_ms']:.4f} by CUDA graph), plain {row['plain_ms']:.3f}"
        f"; byte bound {t_bytes:.4f} ({row['bytes'] / 1e6:.1f} MB), "
        f"operation bound {t_ops:.4f} ({row['dflops'] / 1e9:.3f} GFLOP f64, "
        f"{row['flops'] / 1e9:.3f} f32) ms/frame")
    return row


def kernel_phases(dev, results: dict):
    """B1, B2, B5, B6, B11 and B7 against their plain versions at the
    4080x3072 shapes, on inputs from a seed; the stages feed each other
    like the main path does."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import dct
    from libultrahdr_dev_tpu_torch.ops import color, gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(FRAMES, H, W, SEED)
    y = batched.p010_to_device(y_np, dev)
    uv = batched.p010_to_device(uv_np, dev)
    gamut, tf = CONFIGS[0]

    # B1: gain codes <= 1 apart on <= 1e-4 of samples; planes <= 1 apart.
    # Both configurations (HLG and PQ), timed; the kernels line reports
    # HLG's. Edges: a 16-aligned width (1296) whose tiles fill no whole
    # CTA row, and full-range codes (saturated and floored gain codes).
    got = gm.encode_front(y, uv, gamut, tf)
    err_b1 = 0
    for g_, t_ in CONFIGS:
        b1_check(y, uv, g_, t_, f"{W}x{H}")
        row = b1_times(y, uv, g_, t_)
        if (g_, t_) == (gamut, tf):
            results["B1"] = row
        err_b1 = max(err_b1, row["err"])
    wy, wuv = (batched.p010_to_device(a, dev)
               for a in synth_p010(FRAMES, H, B1_EDGE_W, SEED + 7))
    fy, fuv = (batched.p010_to_device(a, dev)
               for a in full_range_p010(FRAMES, H, W, SEED + 8))
    for g_, t_ in CONFIGS:
        err_b1 = max(err_b1, b1_check(wy, wuv, g_, t_, f"{B1_EDGE_W}x{H}"),
                     b1_check(fy, fuv, g_, t_, f"{W}x{H} full-range",
                              extremes=True))
    results["B1"]["err"] = err_b1
    gmap, yb, ub, vb = got

    # B2: int16 bitwise equal (both compute JAX's kron form, the dots'
    # pairwise float32 tree over exact row sums), by the quotient and by
    # the reciprocal (the main path's form); timed by the reciprocal.
    qs = [torch.from_numpy(q.reshape(64)).to(dev)
          for q in batched.quant_tables(95)]
    planes = ((yb, qs[0]), (ub, qs[1]), (vb, qs[1]), (gmap, qs[2]))
    coefs, worst, n_off, n_all = [], 0, 0, 0
    for p, q in planes:
        for recip in (False, True):
            c = dct.fdct_quant(p, q, recip)
            w_, o_ = int_diff(c, dct.fdct_quant_plain(p, q, recip))
            worst, n_off = max(worst, w_), n_off + o_
            n_all += c.numel()
        coefs.append(c)
    log(f"B2 fdct_quant: max |diff| {worst} on {n_off} of {n_all} "
        f"coefficients")
    require(n_off == 0, "B2 coefficients disagree with the plain version")
    n_blocks = sum(c.shape[1] for c in coefs)   # per frame
    # Library yardstick, transform only: one (N, 64) x (64, 64) float32
    # product over the frame's blocks (TF32 off); B2's kron form does
    # three (one per bf16 term), 3 x 64 x 64 multiply-adds per block.
    xs = torch.randn(n_blocks * FRAMES, 64, device=dev)
    kron = torch.randn(64, 64, device=dev)
    lib_ms = cuda_ms(lambda: torch.matmul(xs, kron), 20) / FRAMES
    # The tensor cores do the three bf16 products (3 x 64 x 64
    # multiply-adds a block); the CUDA cores the float32 epilogue, 24
    # operations a coefficient (21 tree adds, 2 term adds, the divide).
    results["B2"] = dict(
        err=worst, **_timed("B2", lambda: [dct.fdct_quant(p, q, True)
                                           for p, q in planes]),
        plain_ms=cuda_ms(lambda: [dct.fdct_quant_plain(p, q, True)
                                  for p, q in planes], 3) / FRAMES,
        bytes=nbytes(yb, ub, vb, gmap, *coefs) / FRAMES,
        tc_flops=24576.0 * n_blocks, flops=24.0 * 64 * n_blocks,
        library_ms=lib_ms)

    # B5: u8 planes <= 1 apart on <= 1e-4 of pixels.
    idct_args = []
    for c, (p, q) in zip(coefs, planes):
        bh, bw = dct.blocks_dims(*p.shape[1:])
        idct_args.append((c, q.expand(FRAMES, 64).contiguous(), bh, bw))
    decoded, worst, n_off, n_all = [], 0, 0, 0
    for args in idct_args:
        pix = dct.dequant_idct(*args)
        w_, o_ = int_diff(pix, dct.dequant_idct_plain(*args))
        worst, n_off, n_all = max(worst, w_), n_off + o_, n_all + pix.numel()
        decoded.append(pix)
    log(f"B5 dequant_idct: max |diff| {worst} on {n_off} of {n_all} pixels")
    require(worst <= 1 and n_off <= 1e-4 * n_all,
            "B5 pixels disagree with the plain version")
    results["B5"] = dict(
        err=worst, **_timed("B5", lambda: [dct.dequant_idct(*a)
                                           for a in idct_args]),
        plain_ms=cuda_ms(lambda: [dct.dequant_idct_plain(*a)
                                  for a in idct_args], 3) / FRAMES,
        bytes=nbytes(*coefs, *decoded) / FRAMES, flops=2048.0 * n_blocks,
        library_ms=lib_ms)

    # B6: <= 1 ten-bit code / F16 ULP, >= 99.9% bit-exact per channel,
    # in each output format, the 10-bit planar arm (B6r) included.
    # B11 (its table arms): bit-exact.
    y8, u8, v8 = decoded[:3]
    g8 = decoded[3][:, :H // 4, :W // 4]
    in_bytes = FRAMES * (H * W + 2 * (H // 2) * (W // 2) + (H // 4) * (W // 4))
    for name, luts in (("B6", False), ("B11", True)):
        worst, rows = 0, {}
        for fmt, (g_, t_) in (("hdr_linear", CONFIGS[0]),
                              ("hdr_hlg", CONFIGS[0]), ("hdr_pq", CONFIGS[1]),
                              ("hdr_linear_rgb_10bit", CONFIGS[0])):
            sc = torch.from_numpy(np.stack([batched.apply_scalars(
                batched.api0_metadata(t_), math.inf)] * FRAMES)).to(dev)
            args = (y8, u8, v8, g8, sc, fmt, luts)
            out = gm.apply_gainmap(*args)
            dd = code_diff(out, gm.apply_gainmap_plain(*args), fmt)
            exact = float((dd == 0).double().mean())
            log(f"{name} apply_gainmap {fmt}: max |diff| {int(dd.max())}, "
                f"{int((dd > 0).sum())} of {dd.numel()} channel samples "
                f"differ ({exact:.6f} exact)")
            if luts:
                require(int(dd.max()) == 0,
                        f"B11 {fmt} is not bit-exact with the plain version")
            require(int(dd.max()) <= 1 and exact >= 0.999,
                    f"{name} {fmt} disagrees with the plain version")
            worst = max(worst, int(dd.max()))
            # The tables cross the memory bus once, like an input.
            tables = nbytes(gm.srgb_rb_tables(dev))
            if luts:
                tables = nbytes(color.lut_tensor("srgb_inv", dev))
                if fmt in ("hdr_hlg", "hdr_pq"):
                    tables += nbytes(color.lut_tensor(fmt[4:] + "_oetf", dev))
            row = dict(
                ms=cuda_ms(lambda: gm.apply_gainmap(*args), 20) / FRAMES,
                plain_ms=cuda_ms(lambda: gm.apply_gainmap_plain(*args), 3) /
                FRAMES, bytes=(in_bytes + nbytes(out) + tables) / FRAMES,
                err=int(dd.max()), **ops(f"{name} {fmt}", H * W))
            row["bound_ms"], row["bound_by"] = bound(
                row["bytes"], row["flops"], row["dflops"])
            rows[fmt] = row
            log(f"{name} {fmt}: kernel {row['ms']:.4f} ms/frame, plain "
                f"{row['plain_ms']:.3f} ms/frame, bound "
                f"{row['bound_ms']:.4f} ms/frame ({row['bound_by']}; "
                f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.3f} "
                f"GFLOP f32, {row['dflops'] / 1e9:.3f} GFLOP f64)")
        # The kernels line reports B6's F16 row and B11's HLG row (the
        # format the use_luts window of the main path decodes first).
        results[name] = dict(rows["hdr_hlg" if luts else "hdr_linear"],
                             err=worst, library_ms=None, rows=rows)
        if not luts:
            results["B6r"] = dict(rows["hdr_linear_rgb_10bit"],
                                  library_ms=None)

    # B6 and B11 at odd widths and heights (map scale 3: the weight
    # table; scale 9: the weights computed per pixel), on crops of the
    # decoded planes (rows of the padded IDCT output, unaligned): the
    # same bounds as above.
    for w_, h_, scale in ((1023, 765, 3), (1017, 765, 9)):
        ch_, cw_ = (h_ + 1) // 2, (w_ + 1) // 2
        crop = (y8[:, :h_, :w_], u8[:, :ch_, :cw_], v8[:, :ch_, :cw_],
                decoded[3][:, :h_ // scale, :w_ // scale])
        for name, luts in (("B6", False), ("B11", True)):
            for fmt, (g_, t_) in (("hdr_linear", CONFIGS[0]),
                                  ("hdr_hlg", CONFIGS[0]),
                                  ("hdr_pq", CONFIGS[1]),
                                  ("hdr_linear_rgb_10bit", CONFIGS[0])):
                sc = torch.from_numpy(np.stack([batched.apply_scalars(
                    batched.api0_metadata(t_), math.inf)] * FRAMES)).to(dev)
                args = (*crop, sc, fmt, luts)
                dd = code_diff(gm.apply_gainmap(*args),
                               gm.apply_gainmap_plain(*args), fmt)
                exact = float((dd == 0).double().mean())
                log(f"{name} apply_gainmap {fmt} at {w_}x{h_}, scale "
                    f"{scale}: max |diff| {int(dd.max())} ({exact:.6f} "
                    f"exact)")
                require(int(dd.max()) <= (0 if luts else 1) and
                        exact >= 0.999, f"{name} {fmt} at {w_}x{h_} "
                        f"disagrees with the plain version")

    # B7: bit-exact, here and at its edges (b7_edges).
    out = b7_check(f"{W}x{H}, batch {FRAMES}", y8, u8, v8)
    results["B7"] = dict(
        err=0, ms=cuda_ms(lambda: gm.yuv420_to_rgba8888(y8, u8, v8), 20) /
        FRAMES,
        plain_ms=cuda_ms(lambda: gm.yuv420_to_rgba8888_plain(y8, u8, v8),
                         3) / FRAMES,
        bytes=(in_bytes - FRAMES * (H // 4) * (W // 4) + nbytes(out)) /
        FRAMES, library_ms=None, **ops("B7", H * W))
    log(f"B7: kernel {results['B7']['ms']:.4f} ms/frame by CUDA events "
        f"(parent, PR 14: {PARENT_MS['B7']:.4f})")
    b7_edges(dev, y8, u8, v8)


def b7_check(label: str, y8, u8, v8):
    """B7 bitwise equal to its plain version on these planes."""
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    out = gm.yuv420_to_rgba8888(y8, u8, v8)
    err = int((out != gm.yuv420_to_rgba8888_plain(y8, u8, v8)).sum())
    log(f"B7 yuv420_to_rgba8888 {label}: {err} of {out.numel()} words "
        f"differ from the plain version")
    require(err == 0, f"B7 {label} is not bit-exact with the plain version")
    return out


def b7_edges(dev, y8, u8, v8):
    """B7 at the edges of its 2x8 pixel blocks, bitwise: a 4001x2999
    frame (odd h and w), the editor's contiguous 1080x1920 output and a
    1081-wide crop (rows at unaligned addresses), B5's padded crops at
    odd sizes, all-0 and all-255 content."""
    import torch

    from libultrahdr_dev_tpu_torch import PixelFormat, RawImage
    from libultrahdr_dev_tpu_torch.ops import editor

    rng = np.random.default_rng(SEED + 75)
    h, w = 2999, 4001
    odd = [torch.from_numpy(rng.integers(0, 256, (1,) + s, dtype=np.uint8))
           .to(dev) for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                              ((h + 1) // 2, (w + 1) // 2))]
    b7_check(f"{w}x{h}", *odd)
    img = RawImage(fmt=PixelFormat.YUV420, width=W, height=H,
                   planes={k: p[0] for k, p in zip("yuv", (y8, u8, v8))})
    for label, chain in (
            ("editor output {}x{}".format(*CONV_SIZE), converter_chain()),
            ("editor crop 1081x2000", [editor.CropEffect(6, 1087, 0,
                                                         2000)])):
        e = editor.apply_effects(img, chain)
        b7_check(label, *(e.planes[k][None] for k in "yuv"))
    for w_, h_ in ((1023, 765), (1017, 765)):
        ch_, cw_ = (h_ + 1) // 2, (w_ + 1) // 2
        b7_check(f"B5 crop {w_}x{h_}", y8[:, :h_, :w_], u8[:, :ch_, :cw_],
                 v8[:, :ch_, :cw_])
    for value in (0, 255):
        b7_check(f"all {value}", *(torch.full_like(p, value)
                                   for p in (y8, u8, v8)))


def _kind_plane(kind: str, seed: int):
    """A 4096x512 plane (32,768 blocks) of one kind of content, as
    tests/test_torch_dct.py::_blocks_plane makes it: uniform noise,
    smooth blocks, or blocks of four flat quadrants with noise."""
    rng = np.random.default_rng(seed)
    h, w = 4096, 512
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w] % 8
        lvl = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
        gy, gx = (np.kron(rng.normal(0, 4, (h // 8, w // 8)), np.ones((8, 8)))
                  for _ in range(2))
        p = lvl + gy * yy + gx * xx + rng.normal(0, 2, (h, w))
    else:
        p = np.kron(rng.integers(0, 256, (h // 4, w // 4)), np.ones((4, 4)))
        p = p + rng.normal(0, 6, (h, w))
    return np.clip(np.round(p), 0, 255).astype(np.uint8)


#: tests/test_torch_dct.py's TIE_BLOCK: zigzag 39 is exactly -45.5, so
#: -6.5 against luma q95's 7.
B2_TIE_BLOCK = np.array(
    [[204, 184, 152, 203, 155, 20, 163, 189],
     [182, 140, 60, 195, 64, 193, 61, 93],
     [197, 43, 30, 100, 187, 32, 50, 31],
     [206, 155, 173, 59, 85, 159, 198, 146],
     [156, 174, 142, 138, 41, 24, 72, 64],
     [201, 162, 197, 175, 74, 187, 190, 130],
     [103, 55, 34, 190, 70, 45, 154, 84],
     [173, 60, 174, 134, 150, 187, 150, 163]], np.uint8)


def b2_premise_phase(dev):
    """B2's premise on the card: each row sum of its bf16 tensor-core
    mma (a k = 8 product with a zero accumulator) is the exact sum,
    bitwise, on two adversarial rows (dct.kron_adversarial_rows) of
    every (term, row, output column) triple, the block's other rows
    drawn from the seed, and on a plane of sharp-edged blocks; then B2
    = plain bitwise, in both quantisation forms (the quotient, and the
    reciprocal the encode path takes), on those blocks, on the 1,179,648
    blocks of tests/test_torch_dct.py::test_fdct_quant_bitwise_as_jax
    (regenerated from its seeds), on the dense HLG V plane of
    test_fdct_dense_v_plane_near_tie_as_jax (coefficient 1342 is 156)
    and on B2_TIE_BLOCK (zigzag 39 is -6 by the quotient, -7 by the
    reciprocal)."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import dct, tables
    from libultrahdr_dev_tpu_torch.kernels import build
    from libultrahdr_dev_tpu_torch.parallel import batched

    # The compiled B2 runs on the tensor cores: HMMA in its SASS.
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         build.build()], capture_output=True, text=True, timeout=300,
        check=True).stdout
    hmma, fn = 0, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line
        elif "fdct_quant_kernel" in fn and "HMMA" in line:
            hmma += 1
    log(f"B2 fdct_quant_kernel: {hmma} HMMA instructions in its SASS")
    require(hmma > 0, "B2 does not run on the tensor cores")

    rng = np.random.default_rng(SEED + 70)
    adv = dct.kron_adversarial_rows()            # (3, 8, 64, 2, 8)
    blocks = rng.integers(0, 256, adv.shape[:4] + (8, 8)).astype(np.uint8)
    for r in range(8):
        blocks[:, r, :, :, r] = adv[:, r] + 128
    blocks = blocks.reshape(-1, 8, 8)            # 3,072 blocks
    sharp = _kind_plane("quadrants", SEED + 71)[:512]
    sharp_blocks = sharp.reshape(64, 8, 64, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    n_sums, n_off = 0, 0
    for b in (blocks, sharp_blocks):
        bt = torch.from_numpy(np.ascontiguousarray(b)).to(dev)
        got = dct.mma_row_sums(bt)
        want = dct.kron_row_sums_plain(bt)
        n_sums += got.numel()
        n_off += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    log(f"B2 premise: {n_off} of {n_sums} tensor-core row sums differ from "
        f"the exact sums ({len(blocks)} adversarial blocks, "
        f"{len(sharp_blocks)} sharp-edged)")
    require(n_off == 0, "B2: a tensor-core row sum is not exact")

    q95 = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, 95)
    qts = [torch.ones(64, dtype=torch.int32, device=dev),
           torch.from_numpy(q95.reshape(64).astype(np.int32)).to(dev)]
    adv_plane = blocks.reshape(48, 64, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(1, 384, 512)
    planes = [adv_plane, sharp[None]]
    planes += [_kind_plane(k, rep)[None] for rep in range(6)
               for k in ("noise", "smooth", "quadrants")]
    n_blocks, n_off = 0, 0
    for p in planes:
        pt = torch.from_numpy(np.ascontiguousarray(p)).to(dev)
        for q in qts:
            for recip in (False, True):
                c = dct.fdct_quant(pt, q, recip)
                n_off += int((c != dct.fdct_quant_plain(pt, q, recip)).sum())
                n_blocks += c.shape[1]
    # The dense HLG noise frame at quality 100: V block 20's zigzag 62
    # is a near-tie (155.4999963) that JAX rounds to 156.
    rng = np.random.default_rng(3)
    y = (rng.integers(0, 1024, (64, 128)) << 6).astype(np.uint16)
    uv = (rng.integers(0, 1024, (32, 128)) << 6).astype(np.uint16)
    v = batched.encode_front(batched.p010_to_device(y[None], "cpu"),
                             batched.p010_to_device(uv[None], "cpu"),
                             "bt2100", "hlg")[3].to(dev)
    qc = torch.from_numpy(batched.quant_tables(100)[1].reshape(64)).to(dev)
    c = dct.fdct_quant(v, qc)
    n_off += int((c != dct.fdct_quant_plain(v, qc)).sum())
    cr = dct.fdct_quant(v, qc, True)
    n_off += int((cr != dct.fdct_quant_plain(v, qc, True)).sum())
    n_blocks += 2 * c.shape[1]
    tie = torch.from_numpy(B2_TIE_BLOCK[None]).to(dev)
    ql = torch.from_numpy(batched.quant_tables(95)[0].reshape(64)).to(dev)
    ties = [int(dct.fdct_quant(tie, ql, r)[0, 0, 39]) for r in (False, True)]
    log(f"B2 premise: kernel = plain on {n_blocks} blocks ({n_off} "
        f"coefficients off), the dense V plane's coefficient 1342 "
        f"{int(c.reshape(-1)[1342])} (reciprocal form "
        f"{int(cr.reshape(-1)[1342])}), the tie block's zigzag 39 {ties[0]} "
        f"by the quotient and {ties[1]} by the reciprocal")
    require(n_off == 0, "B2 differs from the plain version")
    require(int(c.reshape(-1)[1342]) == 156, "B2 misses the V near-tie")
    require(ties == [-6, -7], "B2 misses the exact tie of either form")


def _f32_bits(x: float) -> int:
    return int(np.array([x], np.float32).view(np.uint32)[0])


def _f64_op(op: str) -> bool:
    """Whether a SASS opcode runs on the float64 pipe: the adds,
    multiplies, fused multiply-adds, compares and min/max, the converts
    from or to float64 and the float64 special-function seeds."""
    base = op.split(".")[0]
    return (base in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
            or (base in ("F2F", "I2F", "F2I") and "64" in op and "F" in
                op[4:])
            or (base == "MUFU" and "64H" in op))


def pow_phase(dev):
    """pow_exact (B6, B11, B1, B9, B10b) against pow_rn (the double
    pow() it replaces), bitwise, over every float32 its call sites can
    receive: [0.09, 1] for the sRGB inverse OETF's base ((0.04045 +
    0.055) / 1.055 = 0.0905...), every positive finite float32 for the
    PQ OETF's exponents m1 and m2 (with the share of the PQ ratio's own
    range, [c1, c2 / c3], apart), every positive float32 <= 1 for the
    PQ inverse OETF's exponents (its bases lie in [0, 1]: the callers
    clamp RGB to [0, 1]); the share that took the double path; each
    pow's float64 instructions in the built SASS (pow_probe_kernel) and
    its time on 2^24 inputs; B6's sRGB red / blue tables against the
    plain version, entry by entry."""
    import torch

    from libultrahdr_dev_tpu_torch.kernels import build
    from libultrahdr_dev_tpu_torch.ops import color, gainmap as gm

    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 4096.0 * 32.0, 2392.0 / 4096.0 * 32.0
    inf_bits = _f32_bits(math.inf)
    domains = (("sRGB base x^2.4 on [0.09, 1]", 2.4, _f32_bits(0.09),
                _f32_bits(1.0) + 1),
               ("PQ x^m1 on every positive finite float32", m1, 1, inf_bits),
               ("PQ x^m2 on every positive finite float32", m2, 1, inf_bits),
               ("PQ x^m2 on the PQ ratio's range [c1, c2 / c3]", m2,
                _f32_bits(c1), _f32_bits(np.float32(c2) / np.float32(c3)) + 1),
               ("PQ inverse x^0.0126833 on every positive float32 <= 1",
                0.0126833, 1, _f32_bits(1.0) + 1),
               ("PQ inverse x^6.2773946361 on every positive float32 <= 1",
                6.2773946361, 1, _f32_bits(1.0) + 1))
    for label, p, lo, hi in domains:
        bad, slow = gm.pow_exact_check(p, lo, hi, dev)
        log(f"pow_exact, {label}: {bad} of {hi - lo} results differ from "
            f"pow_rn; {slow} ({slow / (hi - lo):.6%}) took the double path")
        require(bad == 0, f"pow_exact differs from pow_rn ({label})")

    sass = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         build.build()], capture_output=True, text=True, timeout=300,
        check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = ("pow_exact" if "pow_probe_kernelILb1E" in line else
                  "pow_rn" if "pow_probe_kernelILb0E" in line else None)
        elif fn and "*/" in line:
            toks = [t for t in line.split("*/", 1)[1].split(";")[0].split()
                    if not t.startswith("@")]
            if toks and _f64_op(toks[0]):
                counts[fn] = counts.get(fn, 0) + 1
    log(f"SASS float64-pipe instructions: pow_rn (the double pow) "
        f"{counts.get('pow_rn', 0)}, pow_exact {counts.get('pow_exact', 0)} "
        f"(its fast path and its pow_rn fallback); POW_F64_OPS = "
        f"{POW_F64_OPS} operations (the fast path, from the source)")
    require(counts.get("pow_rn", 0) > 0 and counts.get("pow_exact", 0) > 0,
            "no float64 instruction found in the pow probes' SASS")

    # B6's sRGB red / blue tables against the plain version's
    # linearization (ops/color.py on the card) of every (luma, chroma).
    i = torch.arange(65536, device=dev)
    y = (i >> 8).to(torch.float32) * color.recip(255.0)
    c = ((i & 255).to(torch.float32) - 128.0) * color.recip(255.0)
    zero = torch.zeros_like(c)
    red = color.p3_yuv_to_rgb((y, zero, c))[0]
    blue = color.p3_yuv_to_rgb((y, c, zero))[2]
    want = torch.stack([color.srgb_inv_oetf(red), color.srgb_inv_oetf(blue)])
    n_off = int((gm.srgb_rb_tables(dev) != want).sum())
    log(f"B6 sRGB tables: {n_off} of {want.numel()} entries differ from the "
        f"plain version's linearization")
    require(n_off == 0, "B6's sRGB tables differ from the plain version")

    x = torch.rand(1 << 24, generator=torch.Generator().manual_seed(SEED),
                   dtype=torch.float32).to(dev) * 0.91 + 0.09
    a, b = gm.pow_probe(x, 2.4), gm.pow_probe(x, 2.4, exact=False)
    require(torch.equal(a, b), "pow_probe's pow_exact differs from its "
            "pow_rn")
    log(f"pow_probe = color.pow_rn (torch's float64 pow on the card): "
        f"{torch.equal(a, color.pow_rn(x, 2.4))}")
    ms = {k: graph_ms(lambda e=e: gm.pow_probe(x, 2.4, exact=e), 10)
          for k, e in (("pow_exact", True), ("pow_rn", False))}
    log(f"pow on 2^24 floats in [0.09, 1] (x^2.4): pow_exact "
        f"{ms['pow_exact']:.4f} ms, pow_rn {ms['pow_rn']:.4f} ms by CUDA "
        f"graph ({ms['pow_exact'] * 1e6 / (1 << 24):.4f} vs "
        f"{ms['pow_rn'] * 1e6 / (1 << 24):.4f} ns a pow)")


def b3_phase(dev, results: dict):
    """B3 (restart-interval Huffman encode) against its plain version on
    B2's coefficients of both configurations, and the finalized JPEG/R
    bytes against the host-Huffman route of the same coefficients."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de
    from libultrahdr_dev_tpu_torch.parallel import batched

    r = batched.RST_INTERVAL
    kept = {}
    for i, (gamut, tf) in enumerate(CONFIGS):
        y_np, uv_np = synth_p010(FRAMES, H, W, SEED + 10 + i)
        coefs = batched.encode_coefs_stage(
            batched.p010_to_device(y_np, dev),
            batched.p010_to_device(uv_np, dev), gamut, tf, 95)
        yz, uz, vz, gz = coefs
        base = de.encode_ycbcr_rst_stream(yz, uz, vz, W // 16, H // 16, r)
        gmap = de.encode_gray_rst_stream(gz, r)
        pbase = de.encode_ycbcr_rst_stream_plain(yz, uz, vz, W // 16,
                                                 H // 16, r)
        pgmap = de.encode_gray_rst_stream_plain(gz, r)
        for name, got, want in (("base", base, pbase), ("gain map", gmap,
                                                        pgmap)):
            require(torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1]),
                    f"B3 {gamut}/{tf} {name}: stream or chunk bits differ "
                    f"from the plain version")
        streams = batched.DeviceStreams(W, H, *base, *gmap)
        blobs = batched.assemble_api0(streams, gamut, tf, 95)[0]
        host = batched.assemble_api0_host_huffman(coefs, W, H, gamut, tf,
                                                  95)
        require(blobs == host, f"B3 {gamut}/{tf}: JPEG/R bytes differ from "
                f"the host-Huffman route")
        log(f"B3 {gamut}/{tf}: stream {base[0].numel()} + "
            f"{gmap[0].numel()} bytes and chunk bits equal the plain "
            f"version; JPEG/R bytes equal the host-Huffman route "
            f"({sum(map(len, blobs))} bytes)")
        kept[gamut, tf] = (coefs, base, gmap, blobs)

    coefs, base, gmap, _ = kept[CONFIGS[0]]
    yz, uz, vz, gz = coefs
    # Intervals of 43 and 300 MCUs on the same batch: chunks longer than
    # a tile (parts of 256 blocks, chunks crossing tiles), short last
    # chunks, frames of a block count no tile count divides.
    for rr in (43, 300):
        for name, got, want in (
                ("base", de.encode_ycbcr_rst_stream(yz, uz, vz, W // 16,
                                                    H // 16, rr),
                 de.encode_ycbcr_rst_stream_plain(yz, uz, vz, W // 16,
                                                  H // 16, rr)),
                ("gain map", de.encode_gray_rst_stream(gz, rr),
                 de.encode_gray_rst_stream_plain(gz, rr))):
            require(torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1]),
                    f"B3 r={rr} {name}: stream or chunk bits differ from "
                    f"the plain version")
        log(f"B3 r={rr}: base and gain map streams and chunk bits equal the "
            f"plain version (tiling {de.rst_tiling(W * H // 256, rr, 6)} "
            f"and {de.rst_tiling(W * H // 1024, rr, 1)})")

    def kernel():
        return (de.encode_ycbcr_rst_stream(yz, uz, vz, W // 16, H // 16, r),
                de.encode_gray_rst_stream(gz, r))

    def plain():
        return (de.encode_ycbcr_rst_stream_plain(yz, uz, vz, W // 16,
                                                 H // 16, r),
                de.encode_gray_rst_stream_plain(gz, r))

    results["B3"] = dict(
        err=0, ms=cuda_ms(kernel, 5) / FRAMES,
        plain_ms=cuda_ms(plain, 1) / FRAMES,
        bytes=nbytes(*coefs, *base, *gmap) / FRAMES, library_ms=None)
    log_breakdown(f"B3 base + gain map ({W}x{H}, batch {FRAMES}, r={r})",
                  kernel, 5, results["B3"]["ms"] * FRAMES)
    return kept


def sdr_rendition(y_np, uv_np, sdr_gamut: str, dev):
    """The SDR frame of an API-1 input: the top 8 bits of the seeded HDR
    frame, re-encoded from BT.2100 YUV to the SDR gamut's with the
    port's plain conversion. numpy uint8 (n, h, w), (n, h/2, w/2)."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    top = [torch.from_numpy((a >> 8).astype(np.uint8)).to(dev)
           for a in (y_np, uv_np[..., 0::2], uv_np[..., 1::2])]
    return [p.cpu().numpy()
            for p in gm.convert_yuv_encoding_plain(*top, "bt2100", sdr_gamut)]


def b9_check(planes, sg: str, hg: str, tf: str, what: str):
    """B9 against its plain version: gain codes <= 1 apart on <= 1e-4 of
    samples, base planes bit-exact. Returns (its outputs, the gain
    codes' |diff|)."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    got = gm.encode_front_api1(*planes, sg, hg, tf)
    ref = gm.encode_front_api1_plain(*planes, sg, hg, tf)
    d = (got[0].to(torch.int32) - ref[0].to(torch.int32)).abs()
    n_off = int((d > 0).sum())
    log(f"B9 encode_front_api1 {what} {sg}/{hg}/{tf}: max |diff| gain "
        f"{int(d.max())} on {n_off} of {d.numel()} samples; base planes "
        f"{'equal' if all(map(torch.equal, got[1:], ref[1:])) else 'DIFFER'}")
    require(int(d.max()) <= 1 and n_off <= 1e-4 * d.numel(),
            f"B9 {what} {sg}/{hg}/{tf} gain codes disagree with the plain "
            f"version")
    require(all(map(torch.equal, got[1:], ref[1:])),
            f"B9 {what} {sg}/{hg}/{tf} base planes differ from the plain "
            f"version")
    return got, d


def b9_phase(dev, results: dict):
    """B9 (API-1 front end) against its plain version for both API-1
    configurations (gain codes <= 1 apart on <= 1e-4 of samples, base
    planes bit-exact), also at B1's edge width, and the API-1 JPEG/R
    bytes through B2 and B3 against the host-Huffman route of the same
    coefficients."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    def api1_planes(y_np, uv_np, sg):
        return ([batched.p010_to_device(a, dev) for a in (y_np, uv_np)]
                + [torch.from_numpy(p).to(dev)
                   for p in sdr_rendition(y_np, uv_np, sg, dev)])

    for i, (sg, hg, tf) in enumerate(API1_CONFIGS):
        b9_check(api1_planes(*synth_p010(FRAMES, H, B1_EDGE_W,
                                         SEED + 25 + i), sg),
                 sg, hg, tf, f"{B1_EDGE_W}x{H}")
        y_np, uv_np = synth_p010(FRAMES, H, W, SEED + 20 + i)
        planes = api1_planes(y_np, uv_np, sg)
        got, d = b9_check(planes, sg, hg, tf, f"{W}x{H}")
        coefs = batched.encode_coefs_stage_api1(*planes, sg, hg, tf, 95)
        streams = batched.encode_device_stage_api1(*planes, sg, hg, tf, 95)
        blobs = batched.assemble_api0(streams, sg, tf, 95)[0]
        host = batched.assemble_api0_host_huffman(coefs, W, H, sg, tf, 95)
        require(blobs == host, f"B9 {sg}/{hg}/{tf}: API-1 JPEG/R bytes "
                f"differ from the host-Huffman route")
        log(f"B9 {sg}/{hg}/{tf}: API-1 JPEG/R bytes through B3 equal the "
            f"host-Huffman route ({sum(map(len, blobs))} bytes)")
        if i:
            continue
        samples = ops(f"B9 map {tf}", (H // 4) * (W // 4))
        quads = ops("B9 quad", (H // 2) * (W // 2))
        results["B9"] = dict(
            err=int(d.max()),
            ms=cuda_ms(lambda: gm.encode_front_api1(*planes, sg, hg, tf),
                       20) / FRAMES,
            plain_ms=cuda_ms(lambda: gm.encode_front_api1_plain(
                *planes, sg, hg, tf), 3) / FRAMES,
            bytes=nbytes(*planes, *got) / FRAMES, library_ms=None,
            flops=samples["flops"] + quads["flops"],
            dflops=samples["dflops"])


def b10_phase(dev, results: dict):
    """B10a (tonemap) and B10c (BT.601 re-encode) bit-exact with their
    plain versions, and B10b (gain map) in five variants within B1's and
    B9's bar (codes <= 1 apart on <= 1e-4 of samples, equal elsewhere),
    at the 4000x3000 shapes of the general routes' main path."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import color, gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 40)
    y, uv = (batched.p010_to_device(a, dev) for a in (y_np, uv_np))
    tm = gm.tonemap_p010(y, uv)
    require(all(map(torch.equal, tm, gm.tonemap_p010_plain(y, uv))),
            "B10a differs from the plain version")
    results["B10a"] = dict(
        err=0, ms=graph_ms(lambda: gm.tonemap_p010(y, uv), 20),
        enqueue_ms=cuda_ms(lambda: gm.tonemap_p010(y, uv), 20),
        plain_ms=cuda_ms(lambda: gm.tonemap_p010_plain(y, uv), 5),
        bytes=nbytes(y, uv, *tm), library_ms=None)
    conv = gm.convert_yuv_encoding(*tm, "bt2100", "p3")
    require(all(map(torch.equal, conv, gm.convert_yuv_encoding_plain(
        *tm, "bt2100", "p3"))), "B10c differs from the plain version")
    results["B10c"] = dict(
        err=0, ms=graph_ms(lambda: gm.convert_yuv_encoding(
            *tm, "bt2100", "p3"), 20),
        enqueue_ms=cuda_ms(lambda: gm.convert_yuv_encoding(
            *tm, "bt2100", "p3"), 20),
        plain_ms=cuda_ms(lambda: gm.convert_yuv_encoding_plain(
            *tm, "bt2100", "p3"), 5),
        bytes=nbytes(*tm, *conv), library_ms=None,
        flops=ops("B9 quad", (GH // 2) * (GW // 2))["flops"])
    log(f"B10a tonemap_p010, B10c convert_yuv_encoding: bit-exact with "
        f"the plain versions ({GW}x{GH}); kernel ms/frame by CUDA graph "
        f"{results['B10a']['ms']:.4f}, {results['B10c']['ms']:.4f}, "
        f"launched one by one {results['B10a']['enqueue_ms']:.4f}, "
        f"{results['B10c']['enqueue_ms']:.4f}")

    sdr709, sdr601 = ([torch.from_numpy(p).to(dev)
                       for p in sdr_rendition(y_np, uv_np, g, dev)]
                      for g in ("bt709", "p3"))
    variants = (
        ("tonemapped bt2100/hlg (API-0)", tm, "bt2100", "hlg", False, False),
        ("bt709 + bt2100/pq (API-1)", sdr709, "bt709", "pq", False, False),
        ("sdr_is_601 p3 + bt2100/hlg (API-3)", sdr601, "p3", "hlg", True,
         False),
        ("use_luts bt2100/hlg", tm, "bt2100", "hlg", False, True),
        ("use_luts bt709 + bt2100/pq", sdr709, "bt709", "pq", False, True))
    worst, rows = 0, {}
    for label, sdr, sg, tf, is601, luts in variants:
        kw = dict(sdr_gamut=sg, hdr_gamut="bt2100", hdr_tf=tf,
                  sdr_is_601=is601, use_luts=luts)
        got, md = gm.generate_gainmap(*sdr, y, uv, **kw)
        ref, md_ref = gm.generate_gainmap_plain(*sdr, y, uv, **kw)
        d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        n_off = int((d > 0).sum())
        log(f"B10b generate_gainmap {label}: max |diff| {int(d.max())} on "
            f"{n_off} of {d.numel()} samples")
        require(md == md_ref and int(d.max()) <= 1
                and n_off <= 1e-4 * d.numel(),
                f"B10b {label} disagrees with the plain version")
        worst = max(worst, int(d.max()))
        tables = 0
        if luts:
            tables = nbytes(color.lut_tensor("srgb_inv", dev),
                            color.lut_tensor(f"{tf}_inv", dev))
        row = dict(
            ms=graph_ms(lambda: gm.generate_gainmap(*sdr, y, uv, **kw), 20),
            enqueue_ms=cuda_ms(lambda: gm.generate_gainmap(*sdr, y, uv,
                                                           **kw), 20),
            plain_ms=cuda_ms(lambda: gm.generate_gainmap_plain(
                *sdr, y, uv, **kw), 3),
            bytes=nbytes(*sdr, y, uv, got) + tables,
            **ops("B10b lut" if luts else f"B9 map {tf}",
                  (GH // 4) * (GW // 4)))
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 row["dflops"])
        rows[label] = row
        log(f"B10b {label}: kernel {row['ms']:.4f} ms/frame (CUDA graph; "
            f"{row['enqueue_ms']:.4f} launched one by one), plain "
            f"{row['plain_ms']:.3f} ms/frame, bound {row['bound_ms']:.4f} "
            f"ms/frame ({row['bound_by']}, {row['bytes'] / 1e6:.2f} MB)")
    # The kernels line reports the API-0 variant (the general window's
    # first encode).
    results["B10b"] = dict(rows[variants[0][0]], err=worst, library_ms=None)


def _b12_inputs(ds, dev):
    """B4's and B5's inputs for one parsed stream, on the device (as
    jpeg/device_decode.py:decode_stream_device lays them out)."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    ln = dd.pack_streams([ds])
    q = np.stack([t.reshape(64) for t in ds.qtables]).astype(np.int32)
    return ds, batched._upload([ln.src, ln.frames, ln.lanes, ln.tables, q],
                               dev)


def _b12(inputs, plain=False, mode="dense"):
    """B4 (B22 with mode "log") then B5 per plane (their plain versions
    with plain): the uncropped planes."""
    from libultrahdr_dev_tpu_torch.jpeg import dct
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    ds, (src, frames, lanes, tabs, qd) = inputs
    b4 = dd.decode_rst_chunks_plain if plain else dd.decode_rst_chunks
    b5 = dct.dequant_idct_plain if plain else dct.dequant_idct
    grids = b4(src, frames, lanes, tabs, ds.gray, ds.sampling, ds.mcus_x,
               ds.mcus_y, emit_mode=mode)
    return [b5(g, qd[k:k + 1], bh, bw) for k, (g, (bh, bw)) in enumerate(
        zip(grids, dd.plane_shapes(ds.gray, ds.sampling, ds.mcus_x,
                                   ds.mcus_y)))]


def b12_phase(dev, results: dict, kept: dict):
    """B12's decode half, decode_jpeg's device route (B4 then B5), on
    4000x3000 JPEGs that encode_jpeg wrote (gray, 4:2:0, 4:2:2, 4:4:4,
    restart-less) and on the 4:2:0 primary of a device-route JPEG/R
    (restart markers): the kernels' planes bitwise equal to the plain
    versions', and decode_jpeg's planes bitwise equal to the host-Huffman
    + B5 route's."""
    import torch

    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import codec, dct
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 50)
    streams = {name: codec.encode_jpeg(p, 90, device=dev) for name, (p, _)
               in _yuv_variants(y_np[0], uv_np[0]).items()}
    streams["4:2:0 with restarts (4080x3072 JPEG/R primary)"] = \
        mux.extract_primary_and_gainmap(kept[CONFIGS[0]][3][0])[0]
    for name, data in streams.items():
        ds = dd.parse_device_stream(data)
        require(ds is not None and (ds.start_bits is None) ==
                ("restarts" in name), f"B12 {name}: not on the device route")
        inputs = _b12_inputs(ds, dev)
        got = _b12(inputs)
        require(all(map(torch.equal, got, _b12(inputs, plain=True))),
                f"B12 {name}: kernels differ from the plain versions")
        require(all(map(torch.equal, got, _b12(inputs, mode="log"))),
                f"B12 {name}: B22 then B5 differ from B4 then B5")
        dec = codec.decode_jpeg(data, dev)
        host = codec.decode_jpeg_coefs(data)
        for plane, g, (grid, q, ch, cw, _) in zip(dec.planes, got,
                                                    host.comps):
            hp = dct.dequant_idct(
                torch.from_numpy(grid.reshape(1, -1, 64)).to(dev),
                torch.from_numpy(q.reshape(1, 64).astype(np.int32)).to(dev),
                grid.shape[0], grid.shape[1])[0, :ch, :cw]
            require(torch.equal(plane, hp) and torch.equal(
                plane, g[0, :ch, :cw]), f"B12 {name}: decode_jpeg differs "
                f"from the host-Huffman route")
        log(f"B12 {name}: {len(data)} bytes, {ds.n_lanes} lanes; kernels = "
            f"plain = host-Huffman + B5 route (B4 and B22), planes "
            f"{[tuple(p.shape) for p in dec.planes]}")
    inputs = _b12_inputs(dd.parse_device_stream(streams["4:2:0"]), dev)
    out = _b12(inputs)
    results["B12"] = dict(
        err=0, **_timed("B12-dec 4:2:0 restart-less (B4 + carry + B5)",
                        lambda: _b12(inputs), per=1, iters=10),
        plain_ms=cuda_ms(lambda: _b12(inputs, plain=True), 1),
        bytes=nbytes(*inputs[1], *out), library_ms=None)


def _b4_inputs(frames, dev):
    """Packed B4 inputs of host-parsed frames (base and gain map), on
    the device."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    out = []
    for k in (0, 1):
        ln = dd.pack_streams([f.streams[k] for f in frames])
        arrays = batched._upload([ln.src, ln.frames, ln.lanes, ln.tables],
                                 dev)
        out.append((ln, arrays))
    return out


def _b4(inputs, plain=False, mode="dense"):
    """B4 (B22 with mode "log") on packed inputs, or its plain version."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    fn = dd.decode_rst_chunks_plain if plain else dd.decode_rst_chunks
    return [fn(*arrays, ln.gray, ln.sampling, ln.mcus_x, ln.mcus_y,
               emit_mode=mode) for ln, arrays in inputs]


def _host_coefs(blob):
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import codec

    return [[c[0].reshape(-1, 64) for c in codec.decode_jpeg_coefs(p).comps]
            for p in mux.extract_primary_and_gainmap(blob)]


def _check_b4(inputs, blobs, what: str):
    """Kernel = plain = host decode, for every image of every frame."""
    import torch

    got, want = _b4(inputs), _b4(inputs, plain=True)
    for g_img, w_img in zip(got, want):
        for g, w_ in zip(g_img, w_img):
            require(torch.equal(g, w_), f"B4 {what}: kernel differs from "
                    f"the plain version")
    for f, blob in enumerate(blobs):
        for k, host in enumerate(_host_coefs(blob)):
            for plane, h_ in zip(got[k], host):
                require(np.array_equal(plane[f].cpu().numpy(), h_),
                        f"B4 {what}: frame {f} image {k} differs from the "
                        f"host decode")
    return got


def b4_phase(dev, results: dict, kept: dict):
    """B4 (parallel Huffman decode) against its plain version and the
    host decoder: on the streams B3 wrote, on the restart-less reference
    goldens (host-scanned lanes, DC carry), and on garbage windows."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import codec
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    coefs, _, _, blobs = kept[CONFIGS[0]]
    frames = batched.decode_host_stage(blobs)
    require(all(f.streams is not None for f in frames),
            "the port's own blobs did not take the device route")
    inputs = _b4_inputs(frames, dev)
    got = _check_b4(inputs, blobs, "own streams")
    for plane, c in zip(got[0] + got[1], coefs):
        require(torch.equal(plane, c), "B4 did not give back B2's "
                "coefficients")
    log(f"B4 own streams: kernel = plain = host decode = B2's "
        f"coefficients ({inputs[0][0].lanes.shape[0]} + "
        f"{inputs[1][0].lanes.shape[0]} lanes)")
    src_bytes = sum(nbytes(*a) for _, a in inputs)
    out_bytes = sum(nbytes(*g) for g in got)
    results["B4"] = dict(
        err=0, **_timed(f"B4 ({W}x{H}, batch {FRAMES})",
                        lambda: _b4(inputs), iters=10),
        plain_ms=cuda_ms(lambda: _b4(inputs, plain=True), 1) / FRAMES,
        bytes=(src_bytes + out_bytes) / FRAMES, library_ms=None)

    for name in [g[0] for g in GOLDEN_F16] + GOLDEN_OTHER:
        blob = open(os.path.join(GOLDENS, name), "rb").read()
        gframes = batched.decode_host_stage([blob])
        require(gframes[0].streams is not None and all(
            s.start_bits is not None for s in gframes[0].streams),
            f"{name}: not decoded as host-scanned restart-less lanes")
        _check_b4(_b4_inputs(gframes, dev), [blob], name)
    log(f"B4 goldens: kernel = plain = host decode on "
        f"{len(GOLDEN_F16) + len(GOLDEN_OTHER)} restart-less JPEG/Rs "
        f"(DC carry)")

    garbage = _garbage_b4_inputs(dev)
    g, = _b4(garbage)
    require(all(map(torch.equal, g, _b4(garbage, plain=True)[0])),
            "B4 garbage windows: kernel differs from the plain version")
    log(f"B4 garbage: kernel = plain on 256 random windows "
        f"({sum(int((a != 0).sum()) for a in g)} nonzero coefficients)")

    # The redesign's edges: lanes at every start byte mod 4 and start
    # bit, windows that end mid-word and at the stream's end; DHTs with
    # 1- and 16-bit codes (the fast, second-level and search lookups);
    # two frames with different DHTs in one launch.
    for gray in (False, True):
        n, nz = _check_b4_b22(_edge_garbage_b4_inputs(dev, gray),
                              f"edge windows ({'gray' if gray else 'color'})")
        log(f"B4 = plain, B22 = plain = B4 on 256 garbage lanes at every "
            f"start byte mod 4 and start bit, windows ending mid-word "
            f"and at the stream's end ({'gray' if gray else 'color'}, "
            f"{n} coefficients, {nz} nonzero)")
    long_jpeg, annex_jpeg = _long_code_jpegs()
    for what, jpegs in (("1- and 16-bit codes", [long_jpeg]),
                        ("two frames, two DHT sets, one launch",
                         [long_jpeg, annex_jpeg])):
        streams = [dd.parse_device_stream(j) for j in jpegs]
        require(all(s is not None for s in streams),
                f"B4 {what}: not on the device route")
        inputs = _stream_inputs(streams, dev)
        ln = inputs[0][0]
        fast = dd.fast_lookup_table(ln.tables)
        n, _ = _check_b4_b22(inputs, what)
        got, = _b4(inputs)
        for f, j in enumerate(jpegs):
            host = [c[0].reshape(-1, 64)
                    for c in codec.decode_jpeg_coefs(j).comps]
            require(all(np.array_equal(p[f].cpu().numpy(), h_)
                        for p, h_ in zip(got, host)),
                    f"B4 {what}: frame {f} differs from the host decode")
        log(f"B4 {what}: B4 = plain = host decode, B22 = plain = B4 "
            f"({ln.lanes.shape[0]} lanes, {n} coefficients; 9-bit "
            f"prefixes that straddle entries, a frame: "
            f"{(fast == dd.FAST_SEARCH).reshape(len(jpegs), -1).sum(1)} "
            f"of {fast.size // len(jpegs)})")


def _garbage_b4_inputs(dev, win: int = 384, seed: int = SEED + 3):
    """B4's garbage windows (b4_phase): 256 lanes of random bytes in
    windows of `win` bytes, 2 MCUs (12 blocks) each, random start bits.
    In 20-byte windows most lanes run out of bits before their last
    block, so they are cut short and leave blocks they never enter."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    rng = np.random.default_rng(seed)
    nl, mx, my = 256, 64, 8   # 512 MCUs, 2 per lane
    src = rng.integers(0, 256, nl * win, dtype=np.uint8)
    rows = np.asarray([dd.frame_row(0, src.size, win, 2, 0, nl, False, 2)],
                      np.int32)
    lanes = np.stack([np.arange(nl) * win, rng.integers(0, 8, nl)],
                     1).astype(np.int32)
    ln = dd.Lanes(src, rows, lanes, dd.decode_tables(dd.ANNEX_K_COLOR)[None],
                  False, (2, 2), mx, my)
    return [(ln, batched._upload([ln.src, ln.frames, ln.lanes, ln.tables],
                                 dev))]


def _edge_garbage_b4_inputs(dev, gray: bool):
    """256 lanes of random bytes, 2 MCUs each: lane i starts at byte
    i * 388 + i % 4 and bit (i // 4) % 8, its window of 385 bytes ends
    mid-word, and the stream ends 5 bytes before the buffer, inside the
    last lanes' windows."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    rng = np.random.default_rng(SEED + 4)
    nl, stride, win = 256, 388, 385
    src = rng.integers(0, 256, nl * stride + 3, dtype=np.uint8)
    i = np.arange(nl)
    lanes = np.stack([i * stride + i % 4, (i // 4) % 8], 1).astype(np.int32)
    rows = np.asarray([dd.frame_row(0, src.size - 5, win, 2, 0, nl, False,
                                    2)], np.int32)
    specs = dd.ANNEX_K_GRAY if gray else dd.ANNEX_K_COLOR
    ln = dd.Lanes(src, rows, lanes, dd.decode_tables(specs)[None], gray,
                  (1, 1) if gray else (2, 2), 64 if gray else 32,
                  8 if gray else 16)
    return [(ln, batched._upload([ln.src, ln.frames, ln.lanes, ln.tables],
                                 dev))]


# DHTs with 1-bit and 16-bit codes: symbol 0 (DC size 0, AC EOB) at 1
# bit; the rest of the DC sizes at 16 bits; 100 AC symbols at 10 bits
# and 61 at 16. The fast table serves the 1-bit codes; the 51 9-bit
# prefixes of an AC table that hold several codes each straddle
# entries, so a frame's first 32 such prefixes get second-level tables
# and the rest go to the binary search.
LONG_DC = ([1] + [0] * 14 + [11], list(range(12)))


def _long_code_jpegs():
    """A 1024x768 4:2:0 JPEG with restart interval 4 Huffman-coded by the
    host coder with the LONG_DC / long AC tables, and the same blocks
    with the Annex K tables."""
    from libultrahdr_dev_tpu_torch.jpeg import codec, tables

    long_ac = ([1] + [0] * 8 + [100] + [0] * 5 + [61],
               [0] + [s for s in tables.AC_LUMA_VALS if s != 0])
    w, h = 1024, 768
    nm = (w // 16) * (h // 16)
    rng = np.random.default_rng(SEED + 5)
    blocks = np.zeros((nm * 6, 64), np.int16)
    blocks[:, 0] = rng.integers(-300, 300, len(blocks))
    nz = rng.random((len(blocks), 63)) < 0.12
    blocks[:, 1:] = np.where(nz, rng.integers(-60, 61, nz.shape), 0)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), nm)
    annex = ((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
             (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
             (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
             (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 90)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, 90)
    m = codec._marker
    out = []
    for dc_l, ac_l, dc_c, ac_c in ((LONG_DC, long_ac, LONG_DC, long_ac),
                                   annex):
        scan = codec.entropy_encode(blocks, comp, [0, 1, 1], [0, 1, 1],
                                    [dc_l, dc_c], [ac_l, ac_c], 4, 6)
        out.append(
            b"\xff\xd8" + codec._jfif_app0()
            + m(0xDB, codec._dqt(0, ql)) + m(0xDB, codec._dqt(1, qc))
            + m(0xC0, codec._sof0(w, h, [(1, 2, 2, 0), (2, 1, 1, 1),
                                         (3, 1, 1, 1)]))
            + b"".join(m(0xC4, codec._dht(c, t, *spec)) for c, t, spec in
                       ((0, 0, dc_l), (1, 0, ac_l), (0, 1, dc_c),
                        (1, 1, ac_c)))
            + m(0xDD, (4).to_bytes(2, "big"))
            + m(0xDA, codec._sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]))
            + scan + b"\xff\xd9")
    return out


def _check_b4_b22(inputs, what: str) -> tuple[int, int]:
    """B4 kernel = B4 plain, and B22 kernel = B22 plain = B4, bitwise;
    returns the counts of coefficients compared and of nonzero ones."""
    import torch

    got, want = _b4(inputs), _b4(inputs, plain=True)
    for g_img, w_img in zip(got, want):
        require(all(map(torch.equal, g_img, w_img)),
                f"B4 {what}: kernel differs from the plain version")
    _check_b22(inputs, what, got)
    return (sum(g.numel() for img in got for g in img),
            sum(int((g != 0).sum()) for img in got for g in img))


def _handoff_b4_inputs(kept, dev):
    """B4h's inputs: lanes over B3's chunk buffers of the first
    configuration (base and gain map), read in place."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    _, base, gmap, _ = kept[CONFIGS[0]]
    out = []
    for (chunks, bits), specs, gray, (mx, my) in (
            (base, dd.ANNEX_K_COLOR, False, (W // 16, H // 16)),
            (gmap, dd.ANNEX_K_GRAY, True,
             (-(-(W // 4) // 8), -(-(H // 4) // 8)))):
        rows, lanes, tabs = batched._handoff_lanes(bits.cpu().numpy(), specs)
        ln = dd.Lanes(None, rows, lanes, tabs, gray,
                      (1, 1) if gray else (2, 2), mx, my)
        out.append((ln, [chunks] + batched._upload([rows, lanes, tabs], dev)))
    return out


def _check_b22(inputs, what: str, want=None):
    """B22 kernel = B22 plain = B4 kernel (and = `want`, when given),
    bitwise; returns B22's grids."""
    import torch

    got = _b4(inputs, mode="log")
    for name, other in (("its plain version", _b4(inputs, True, "log")),
                        ("B4", _b4(inputs)), ("the expected grids", want)):
        if other is None:
            continue
        for g_img, o_img in zip(got, other):
            require(all(map(torch.equal, g_img, o_img)),
                    f"B22 {what}: kernel differs from {name}")
    return got


def _stream_inputs(streams, dev):
    """Packed B4 inputs of parsed streams of one geometry."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    ln = dd.pack_streams(streams)
    return [(ln, batched._upload([ln.src, ln.frames, ln.lanes, ln.tables],
                                 dev))]


def _flat_jpegs(dev) -> dict:
    """GW x GH 4:2:0 JPEGs of flat 8x8 blocks (random levels: DC only,
    one log entry a block), restart-less and at restart interval 4."""
    from libultrahdr_dev_tpu_torch.jpeg import codec

    rng = np.random.default_rng(SEED + 7)

    def flat(h, w):
        lvl = rng.integers(0, 256, (-(-h // 8), -(-w // 8)), dtype=np.uint8)
        return np.kron(lvl, np.ones((8, 8), np.uint8))[:h, :w]

    planes = {"y": flat(GH, GW), "u": flat(GH // 2, GW // 2),
              "v": flat(GH // 2, GW // 2)}
    return {r: codec.encode_jpeg(planes, 90, restart_interval=r, device=dev)
            for r in (0, 4)}


def b22_phase(dev, results: dict, kept: dict):
    """B22 (the decode's log emission) on B4's phase's inputs: the
    streams B3 wrote (4080x3072, batch 2), the handoff (B3's chunk
    buffers read in place), the restart-less goldens (DC carry), the
    garbage windows, garbage lanes cut short (blocks they never enter),
    a truncated stream and flat (DC-only) content: B22 kernel = B22
    plain = B4 kernel, bitwise. Times B22 beside B4 on the own streams,
    in turns (B4, B22, B22, B4), splits B22's device time by pass, and
    counts the coefficients B22's log holds."""
    import copy

    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    coefs, _, _, blobs = kept[CONFIGS[0]]
    frames = batched.decode_host_stage(blobs)
    inputs = _b4_inputs(frames, dev)
    got = _check_b22(inputs, "own streams")
    log(f"B22 own streams: kernel = plain = B4 ({W}x{H}, batch {FRAMES})")
    _check_b22(_handoff_b4_inputs(kept, dev), "handoff",
               [coefs[:3], coefs[3:]])
    log("B22 handoff: kernel = plain = B4 = B2's coefficients")
    for name in [g[0] for g in GOLDEN_F16] + GOLDEN_OTHER:
        blob = open(os.path.join(GOLDENS, name), "rb").read()
        _check_b22(_b4_inputs(batched.decode_host_stage([blob]), dev), name)
    log(f"B22 goldens: kernel = plain = B4 on "
        f"{len(GOLDEN_F16) + len(GOLDEN_OTHER)} restart-less JPEG/Rs "
        f"(DC carry)")
    g = _check_b22(_garbage_b4_inputs(dev), "garbage windows")
    log(f"B22 garbage: kernel = plain = B4 on 256 random windows "
        f"({sum(int((a != 0).sum()) for a in g[0])} nonzero coefficients)")
    n, nz = _check_b4_b22(_garbage_b4_inputs(dev, 20, SEED + 6),
                          "short windows")
    log(f"B22 garbage lanes cut short (20-byte windows, 12 blocks a lane): "
        f"B4 = plain, B22 = plain = B4 ({n} coefficients, {nz} nonzero)")
    cut = copy.copy(frames[0].streams[0])
    cut.dest = cut.dest[:cut.dest.size * 3 // 5].copy()
    n, nz = _check_b4_b22(_stream_inputs([cut], dev), "truncated stream")
    log(f"B22 truncated stream (frame 0's base cut to 3/5 of its "
        f"{frames[0].streams[0].dest.size} bytes): B4 = plain, B22 = plain "
        f"= B4 ({nz} nonzero coefficients)")
    for r, jpeg in _flat_jpegs(dev).items():
        n, nz = _check_b4_b22(_stream_inputs([dd.parse_device_stream(jpeg)],
                                             dev), f"flat r={r}")
        log(f"B22 flat DC-only 4:2:0 {GW}x{GH}, restart interval {r}: B4 = "
            f"plain, B22 = plain = B4 ({n // 64} blocks, {nz} nonzero "
            f"coefficients)")

    emitted = sum(int(dd._decode_rst_chunks_log(
        *arrays, ln.gray, ln.sampling, ln.mcus_x, ln.mcus_y)[1].sum())
        for ln, arrays in inputs)
    nonzero = sum(int((p != 0).sum()) for img in got for p in img)
    blocks = sum(p.shape[0] * p.shape[1] for img in got for p in img)
    b4_ms = [graph_ms(lambda: _b4(inputs), 10) / FRAMES]
    b22_ms = [graph_ms(lambda: _b4(inputs, mode="log"), 10) / FRAMES
              for _ in range(2)]
    b4_ms.append(graph_ms(lambda: _b4(inputs), 10) / FRAMES)
    b22_events = cuda_ms(lambda: _b4(inputs, mode="log"), 10) / FRAMES
    src_bytes = sum(nbytes(*a) for _, a in inputs)
    out_bytes = sum(nbytes(*img) for img in got)
    log(f"B22 vs B4 ({W}x{H}, batch {FRAMES}, in turns, CUDA graph): B4 "
        f"{b4_ms[0]:.4f}, B22 {b22_ms[0]:.4f}, B22 {b22_ms[1]:.4f}, B4 "
        f"{b4_ms[1]:.4f} ms/frame (B22 by CUDA events {b22_events:.4f}); "
        f"{emitted / FRAMES:.0f} coefficients "
        f"emitted a frame ({nonzero / FRAMES:.0f} nonzero), log "
        f"{4 * emitted / FRAMES / 1e6:.1f} MB and block starts "
        f"{4 * blocks / FRAMES / 1e6:.1f} MB a frame")
    split = {k: v / FRAMES for k, v in device_ms_by_kernel(
        lambda: _b4(inputs, mode="log"), 10).items()}
    log(f"B22 pass split ({W}x{H}, batch {FRAMES}; device ms/frame, "
        f"profiler): pass 1 (log_kernel) "
        f"{split.get('log_kernel', float('nan')):.4f}, pass 2 "
        f"(rebuild_kernel) {split.get('rebuild_kernel', float('nan')):.4f}, "
        f"tables {split.get('table_kernel', float('nan')):.4f}, carry scan "
        f"{split.get('carry_scan_kernel', float('nan')):.4f}")
    log_breakdown(f"B22 ({W}x{H}, batch {FRAMES})",
                  lambda: _b4(inputs, mode="log"), 5, b22_events * FRAMES)
    results["B22"] = dict(
        err=0, ms=min(b22_ms),
        plain_ms=cuda_ms(lambda: _b4(inputs, True, "log"), 1) / FRAMES,
        bytes=(src_bytes + out_bytes) / FRAMES,
        library_ms=None)


def psnr_f16(ours, ref_gz) -> float:
    want = np.frombuffer(gzip.open(os.path.join(GOLDENS, ref_gz)).read(),
                         np.uint16).reshape(720, 1280, 4)
    a = ours.view(np.float16)[..., :3].astype(np.float64)
    b = want[..., :3].view(np.float16).astype(np.float64)
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def reset_counts():
    """Zero every kernel launch counter and the host Huffman call
    counters (after the work queued before is done)."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import codec

    torch.cuda.synchronize()
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    codec.entropy_encode.calls = codec.entropy_decode.calls = 0


def decode_key() -> str:
    """The Huffman-decode kernel the device decodes run: B22 when the
    decode's emission default is "log" (UHDR_DECODE_EMIT=log, or the
    log-emission window), else B4."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    return "B22" if dd._DEFAULT_EMIT == "log" else "B4"


def read_counts(label: str, need) -> dict:
    """Read the counters after a path ran: each kernel in `need` must
    have launched (B4 read as decode_key()), and host Huffman must have
    coded and decoded nothing."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import codec

    need = [decode_key() if k == "B4" else k for k in need]
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    host = (codec.entropy_encode.calls, codec.entropy_decode.calls)
    log(f"{label}: kernel launches {launches}, host Huffman encode/decode "
        f"calls {host}")
    require(all(launches[k] > 0 for k in need),
            f"{label}: a kernel of the path never launched: {launches}")
    require(host == (0, 0), f"{label}: host Huffman calls {host}")
    return launches


def main_path(dev, smi: str):
    """The API-0 round trip through the entry points a user calls, the
    encode -> decode handoff, and the decode of the reference goldens;
    for each, every launch counter and the host Huffman call counters
    are zeroed just before and read just after."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrDecoder,
                                           UhdrEncoder)
    from libultrahdr_dev_tpu_torch.api import HDR_IMG
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.parallel import batched

    inputs = {cfg: synth_p010(FRAMES, H, W, SEED + 1 + i)
              for i, cfg in enumerate(CONFIGS)}
    goldens = {n: open(os.path.join(GOLDENS, n), "rb").read()
               for n in [g[0] for g in GOLDEN_F16] + GOLDEN_OTHER}
    boosts = {g[0]: g[2] for g in GOLDEN_F16}

    reset_counts()
    t0 = time.perf_counter()
    blobs, outs, handoffs = {}, {}, {}
    for (gamut, tf), (y, uv) in inputs.items():
        blobs[gamut, tf], handoffs[gamut, tf] = batched.batched_encode_api0(
            y, uv, gamut=gamut, hdr_tf=tf, quality=95, device=dev,
            return_handoff=True)
        for fmt in ("hdr_linear", f"hdr_{tf}"):
            outs[gamut, tf, fmt] = batched.batched_decode(
                blobs[gamut, tf], fmt, device=dev).cpu()
    gamut, tf = CONFIGS[0]
    y, uv = inputs[CONFIGS[0]]
    raw = RawImage(fmt=PixelFormat.P010, width=W, height=H,
                   gamut=ColorGamut(gamut), transfer=ColorTransfer(tf),
                   planes={"y": y[0], "uv": uv[0]})
    jr = JpegR(dev)
    jr_blob = jr.encode_api0(raw, ColorTransfer(tf), 95)
    jr_img = jr.decode(jr_blob, OutputFormat.HDR_HLG).image
    api_blob = UhdrEncoder(dev).set_raw_image(raw, HDR_IMG).encode().data
    api_img = UhdrDecoder(dev).set_image(api_blob).decode()
    b20, b20_md = batched.batched_encode_device_stage(y, uv, gamut, tf, 95,
                                                      device=dev)
    counts = [read_counts(f"round trip ({time.perf_counter() - t0:.1f} s)",
                          API0_KERNELS)]
    require(b20_md == batched.api0_metadata(tf) and all(map(
        torch.equal, b20, batched.encode_coefs_stage(
            batched.p010_to_device(y, dev), batched.p010_to_device(uv, dev),
            gamut, tf, 95))),
        "batched_encode_device_stage differs from B1 + B2 of the batch")

    reset_counts()
    hand = {fmt: batched.batched_decode_from_handoff(
        handoffs[gamut, tf], fmt).cpu() for fmt in ("hdr_linear", "hdr_hlg")}
    counts.append(read_counts("handoff decode", ("B4", "B5", "B6")))

    reset_counts()
    golden_out = {n: jr.decode(b, OutputFormat.HDR_LINEAR,
                               max_display_boost=boosts.get(n, math.inf))
                  .image.planes["rgba"] for n, b in goldens.items()}
    counts.append(read_counts("golden decodes", ("B4", "B5", "B6")))
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}

    # What came out: containers, shapes, finite values, luminance,
    # handoff = blob decode, goldens vs the reference's decodes.
    for key, bl in blobs.items():
        for b in bl + [jr_blob, api_blob]:
            info = jr.get_info(b)
            require((info.width, info.height, info.gainmap_width,
                     info.gainmap_height) == (W, H, W // 4, H // 4),
                    f"{key}: bad JPEG/R geometry")
            mux.extract_primary_and_gainmap(b)
    require(jr_blob == blobs[CONFIGS[0]][0] == api_blob,
            "JpegR / UhdrEncoder bytes differ from the batched encode")
    require(np.array_equal(jr_img.planes["rgba"],
                           outs[gamut, tf, f"hdr_{tf}"][0].numpy().view(
                               np.uint32)),
            "JpegR decode differs from the batched decode")
    require(api_img.planes["rgba"].shape == (H, W, 4),
            "UhdrDecoder output has the wrong shape")
    for fmt, got in hand.items():
        require(torch.equal(got, outs[gamut, tf, fmt]),
                f"handoff decode ({fmt}) differs from the blob decode")
    log("handoff: pixels bitwise equal to the blob decode (F16, HLG "
        "1010102)")
    for name, ref, _ in GOLDEN_F16:
        p = psnr_f16(golden_out[name], ref)
        log(f"golden {name}: F16 PSNR {p:.2f} dB against {ref}")
        require(p >= 55.0, f"{name}: F16 PSNR {p:.2f} dB < 55")
    for (gamut, tf), (y, uv) in inputs.items():
        f16 = outs[gamut, tf, "hdr_linear"].numpy().view(np.float16)
        require(f16.shape == (FRAMES, H, W, 4), "F16 output shape")
        require(bool(np.isfinite(f16).all()), "non-finite F16 output")
        # Decoded linear output is normalized to the HDR peak white.
        sub = (slice(None), slice(0, H, 4), slice(0, W, 4))
        want, white, k = hdr_nits_reference(y, uv, gamut, tf)
        rgb = f16[sub].astype(np.float64)
        got = (k[0] * rgb[..., 0] + k[1] * rgb[..., 1]
               + k[2] * rgb[..., 2]) * white
        want = want[sub]
        keep = (want > 1.0) & (got > 0)
        med = float(np.median(np.abs(np.log2(got[keep] / want[keep]))))
        log(f"{gamut}/{tf}: median |log2(decoded/input luminance)| "
            f"{med:.4f} over {int(keep.sum())} pixels")
        require(med <= 0.1, f"{gamut}/{tf} luminance round trip off")
        words = outs[gamut, tf, f"hdr_{tf}"].numpy().view(np.uint32)
        require(bool(((words >> 30) == 3).all()), "1010102 alpha bits")
    return launches, inputs, blobs, handoffs


def main_path_api1(dev, smi: str):
    """API-1 through the entry points a user calls, in three windows,
    each with every launch counter and the host Huffman call counters
    zeroed just before and read just after: (1) the API-1 encode
    (batched, JpegR, UhdrEncoder with HDR and SDR raw intents) and the
    HDR decode of its blobs; (2) the SDR decode (batched, handoff,
    JpegR, UhdrDecoder RGBA8888 + sRGB), which decodes the base alone;
    (3) the use_luts decode (HLG and PQ, batched and JpegR)."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrDecoder,
                                           UhdrEncoder)
    from libultrahdr_dev_tpu_torch.api import HDR_IMG, SDR_IMG
    from libultrahdr_dev_tpu_torch.ops import color, gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    inputs = {}
    for i, (sg, hg, tf) in enumerate(API1_CONFIGS):
        y, uv = synth_p010(FRAMES, H, W, SEED + 30 + i)
        inputs[sg, hg, tf] = (y, uv, *sdr_rendition(y, uv, sg, dev))
    key = API1_CONFIGS[0]
    sg, hg, tf = key
    y, uv, sy, su, sv = inputs[key]
    hdr = RawImage(fmt=PixelFormat.P010, width=W, height=H,
                   gamut=ColorGamut(hg), transfer=ColorTransfer(tf),
                   planes={"y": y[0], "uv": uv[0]})
    sdr = RawImage(fmt=PixelFormat.YUV420, width=W, height=H,
                   gamut=ColorGamut(sg),
                   planes={"y": sy[0], "u": su[0], "v": sv[0]})
    jr = JpegR(dev)

    reset_counts()
    t0 = time.perf_counter()
    blobs, handoffs, outs = {}, {}, {}
    for k, (y_, uv_, *sdr_) in inputs.items():
        blobs[k], handoffs[k] = batched.batched_encode_api1(
            y_, uv_, *sdr_, sdr_gamut=k[0], hdr_gamut=k[1], hdr_tf=k[2],
            quality=95, device=dev, return_handoff=True)
        for fmt in ("hdr_linear", f"hdr_{k[2]}"):
            outs[k, fmt] = batched.batched_decode(blobs[k], fmt,
                                                  device=dev).cpu()
    jr_blob = jr.encode_api1(hdr, sdr, ColorTransfer(tf), 95)
    api_blob = (UhdrEncoder(dev).set_raw_image(hdr, HDR_IMG)
                .set_raw_image(sdr, SDR_IMG).encode().data)
    counts = [read_counts(f"API-1 encode + HDR decode "
                          f"({time.perf_counter() - t0:.1f} s)",
                          ("B9", "B2", "B3", "B3g", "B4", "B5", "B6"))]
    require(counts[0]["B1"] == 0, "API-1 encode launched B1")
    require(jr_blob == blobs[key][0] == api_blob,
            "API-1: JpegR / UhdrEncoder bytes differ from the batched encode")

    reset_counts()
    t0 = time.perf_counter()
    sdr_b = batched.batched_decode(blobs[key], "sdr", device=dev).cpu()
    sdr_h = batched.batched_decode_from_handoff(handoffs[key], "sdr").cpu()
    sdr_j = jr.decode(blobs[key][0], OutputFormat.SDR).image.planes["rgba"]
    dec = UhdrDecoder(dev).set_image(blobs[key][0])
    dec.set_out_img_format(PixelFormat.RGBA8888)
    dec.set_out_color_transfer(ColorTransfer.SRGB)
    sdr_a = dec.decode().planes["rgba"]
    c = read_counts(f"SDR decode ({time.perf_counter() - t0:.1f} s)",
                    ("B4", "B5", "B7"))
    # Four decodes of the base alone: one B4 call and three B5 calls
    # each, and no gain-map apply.
    require(c["B6"] == c["B11"] == 0, "SDR decode ran the gain-map apply")
    require(c[decode_key()] == 4 and c["B5"] == 12,
            f"SDR decode decoded more than the base: {c}")
    counts.append(c)
    require(torch.equal(sdr_b, sdr_h), "SDR: handoff differs from batched")
    for other, name in ((sdr_j, "JpegR"), (sdr_a, "UhdrDecoder")):
        require(np.array_equal(other, sdr_b[0].numpy().view(np.uint32)),
                f"SDR: {name} differs from the batched decode")

    reset_counts()
    t0 = time.perf_counter()
    lut = {}
    for k in API1_CONFIGS:
        fmt = f"hdr_{k[2]}"
        lut[k] = batched.batched_decode(blobs[k], fmt, device=dev,
                                        use_luts=True).cpu()
        lut_j = jr.decode(blobs[k][0], OutputFormat(fmt),
                          use_luts=True).image.planes["rgba"]
        require(np.array_equal(lut_j, lut[k][0].numpy().view(np.uint32)),
                f"use_luts {fmt}: JpegR differs from the batched decode")
    c = read_counts(f"use_luts decode ({time.perf_counter() - t0:.1f} s)",
                    ("B4", "B5", "B11"))
    require(c["B6"] == 0, "use_luts decode ran the computed apply")
    counts.append(c)
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}

    # What came out: geometry, finite F16, luminance against the input
    # (taken in the SDR gamut, as the gain map takes it), the SDR decode
    # against the SDR input, the table decode against the computed one.
    for k, bl in blobs.items():
        for b in bl:
            info = jr.get_info(b)
            require((info.width, info.height, info.gainmap_width,
                     info.gainmap_height) == (W, H, W // 4, H // 4),
                    f"{k}: bad JPEG/R geometry")
        f16 = outs[k, "hdr_linear"].numpy().view(np.float16)
        require(f16.shape == (FRAMES, H, W, 4) and
                bool(np.isfinite(f16).all()), f"{k}: bad F16 output")
        y_, uv_ = inputs[k][:2]
        sub = (slice(None), slice(0, H, 4), slice(0, W, 4))
        want, white, _ = hdr_nits_reference(y_, uv_, k[1], k[2])
        kw = color.LUMINANCE[k[0]]
        rgb = f16[sub].astype(np.float64)
        got = (kw[0] * rgb[..., 0] + kw[1] * rgb[..., 1]
               + kw[2] * rgb[..., 2]) * white
        want = want[sub]
        keep = (want > 1.0) & (got > 0)
        med = float(np.median(np.abs(np.log2(got[keep] / want[keep]))))
        log(f"API-1 {'/'.join(k)}: median |log2(decoded/input luminance)| "
            f"{med:.4f} over {int(keep.sum())} pixels")
        require(med <= 0.1, f"API-1 {k} luminance round trip off")
        dl = code_diff(lut[k], outs[k, f"hdr_{k[2]}"], f"hdr_{k[2]}")
        log(f"API-1 {'/'.join(k)}: use_luts vs computed decode, max |diff| "
            f"{int(dl.max())} codes, {float((dl == 0).double().mean()):.6f} "
            f"equal")
    sdr_in = [torch.from_numpy(p).to(dev) for p in inputs[key][2:]]
    ref = gm.yuv420_to_rgba8888_plain(*gm.convert_yuv_encoding_plain(
        *sdr_in, sg, "p3")).cpu()
    a, b = (t.numpy().view(np.uint8).reshape(FRAMES, H, W, 4)[..., :3]
            .astype(np.float64) for t in (sdr_b, ref))
    psnr = 10 * math.log10(255.0 ** 2 / max(float(np.mean((a - b) ** 2)),
                                            1e-12))
    log(f"SDR decode of API-1 {sg}/{hg}/{tf} vs the SDR input: PSNR "
        f"{psnr:.2f} dB")
    require(psnr >= 30.0, f"SDR decode PSNR {psnr:.2f} dB < 30")
    return launches, inputs, blobs, handoffs


def _median_log2(f16, y, uv, hdr_gamut: str, tf: str, sdr_gamut: str):
    """Median |log2(decoded / input luminance)| over every 4th pixel of
    an F16 decode (linear RGB in the SDR gamut, as the gain map takes
    it) against the P010 input."""
    from libultrahdr_dev_tpu_torch.ops import color

    sub = (slice(0, None, 4), slice(0, None, 4))
    want, white, _ = hdr_nits_reference(y, uv, hdr_gamut, tf)
    kw = color.LUMINANCE[sdr_gamut]
    rgb = f16[sub].astype(np.float64)
    got = (kw[0] * rgb[..., 0] + kw[1] * rgb[..., 1]
           + kw[2] * rgb[..., 2]) * white
    want = want[sub]
    keep = (want > 1.0) & (got > 0)
    return float(np.median(np.abs(np.log2(got[keep] / want[keep])))), \
        int(keep.sum())


def main_path_general(dev, smi: str):
    """The general encode routes at 4000x3000 through the entry points a
    user calls, in one window with every launch counter and the host
    Huffman call counters zeroed just before and read just after: API-0
    BT.2100 HLG with EXIF (JpegR and UhdrEncoder.set_exif_data), API-1
    BT.709 SDR + PQ with EXIF, a Display-P3 base by encode_jpeg with its
    ICC, API-3 (HLG) from it, API-2 (HLG, the base's raw P3 planes) and
    API-4 through UhdrEncoder, API-x (HLG, BT.709)
    through JpegR (the stable API has no API-x route), the P3 base again
    with a restart interval (encode_jpeg's B12-enc), then every output
    decoded on the card to F16, HLG and SDR. B19 codes each restart-less
    JPEG the route generates (the JAX package Huffman-codes them on the
    host, to the same bytes), none for API-4; host Huffman codes and
    decodes nothing."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer,
                                           CompressedImage, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrEncoder)
    from libultrahdr_dev_tpu_torch.api import BASE_IMG, HDR_IMG, SDR_IMG
    from libultrahdr_dev_tpu_torch.container import icc as icc_mod
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import codec, headers
    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 60)
    y, uv = y_np[0], uv_np[0]

    def p010(tf):
        return RawImage(fmt=PixelFormat.P010, width=GW, height=GH,
                        gamut=ColorGamut.BT2100, transfer=ColorTransfer(tf),
                        planes={"y": y, "uv": uv})

    def yuv420(gamut):
        py, pu, pv = (p[0] for p in sdr_rendition(y_np, uv_np, gamut, dev))
        return RawImage(fmt=PixelFormat.YUV420, width=GW, height=GH,
                        gamut=ColorGamut(gamut),
                        planes={"y": py, "u": pu, "v": pv})

    hlg, pq = p010("hlg"), p010("pq")
    sdr709, sdr_p3 = yuv420("bt709"), yuv420("p3")
    # API-x's raw gain map: B10b's of the BT.709 SDR against the HLG HDR.
    gmap_t, md_x = gm.generate_gainmap(
        *(torch.from_numpy(sdr709.planes[k][None]).to(dev)
          for k in ("y", "u", "v")),
        *(batched.p010_to_device(a[None], dev) for a in (y, uv)),
        sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg")
    gmap_x = gmap_t[0].cpu().numpy()
    jr = JpegR(dev)
    calls: dict = {}
    out: dict = {}

    def b19_launches():
        return de.encode_ycbcr_stream.launches + de.encode_gray_stream.launches

    def encode(label, fn):
        c0 = b19_launches()
        blob = fn()
        calls[label] = b19_launches() - c0
        return blob

    reset_counts()
    t0 = time.perf_counter()
    out["API-0"] = encode("API-0", lambda: jr.encode_api0(
        hlg, ColorTransfer.HLG, 95, exif=EXIF))
    api0_enc = encode("API-0 UhdrEncoder", lambda: UhdrEncoder(dev)
                      .set_raw_image(hlg, HDR_IMG).set_exif_data(EXIF)
                      .encode().data)
    out["API-1"] = encode("API-1", lambda: jr.encode_api1(
        pq, sdr709, ColorTransfer.PQ, 95, exif=EXIF))
    base = encode("P3 base", lambda: codec.encode_jpeg(
        {k: sdr_p3.planes[k] for k in ("y", "u", "v")}, 95,
        icc=icc_mod.write_icc_profile("srgb", "p3"), device=dev))
    rst_base = encode("P3 base, restart interval 4", lambda: codec.encode_jpeg(
        {k: sdr_p3.planes[k] for k in ("y", "u", "v")}, 95,
        icc=icc_mod.write_icc_profile("srgb", "p3"), restart_interval=4,
        device=dev))
    out["API-3"] = encode("API-3", lambda: jr.encode_api3(
        hlg, base, ColorTransfer.HLG))
    out["API-2"] = encode("API-2", lambda: UhdrEncoder(dev)
                          .set_raw_image(hlg, HDR_IMG)
                          .set_raw_image(sdr_p3, SDR_IMG)
                          .set_compressed_image(CompressedImage(base),
                                                SDR_IMG).encode().data)
    gm_jpeg = mux.extract_primary_and_gainmap(out["API-3"])[1]
    md3 = jr.get_info(out["API-3"]).metadata
    out["API-4"] = encode("API-4", lambda: UhdrEncoder(dev)
                          .set_compressed_image(CompressedImage(base),
                                                BASE_IMG)
                          .set_gainmap_image(CompressedImage(gm_jpeg), md3)
                          .set_exif_data(EXIF).encode().data)
    out["API-x"] = encode("API-x", lambda: jr.encode_apix(
        sdr709, gmap_x, md_x, 95, exif=EXIF))
    t_enc = time.perf_counter() - t0
    decoded = {k: {fmt: jr.decode(b, fmt).image.planes["rgba"]
                   for fmt in (OutputFormat.HDR_LINEAR, OutputFormat.HDR_HLG,
                               OutputFormat.SDR)}
               for k, b in out.items()}
    rst_planes = codec.decode_jpeg(rst_base, dev).planes
    base_planes = codec.decode_jpeg(base, dev).planes
    c = read_counts(f"general routes ({t_enc:.1f} s encode, "
                    f"{time.perf_counter() - t0 - t_enc:.1f} s decode)",
                    ("B10a", "B10b", "B10c", "B2", "B4", "B5", "B6", "B7",
                     "B12", "B12e", "B19"))
    log(f"general routes: B19 launches per call {calls}")
    require(c["B1"] == c["B9"] == 0, "the general routes launched B1 or B9")
    require(c["B3"] + c["B3g"] == c["B12e"] == 1,
            "B3 ran other than as encode_jpeg's B12-enc")
    # Two JPEGs (base and gain map) per generated encode; API-2 and API-3
    # code the gain map alone, the P3 base is one JPEG (B12-enc codes it
    # with restart intervals), API-4 codes none.
    want = {"API-0": 2, "API-0 UhdrEncoder": 2, "API-1": 2, "P3 base": 1,
            "P3 base, restart interval 4": 0, "API-3": 1, "API-2": 1,
            "API-4": 0, "API-x": 2}
    require(calls == want, f"B19 launches per call {calls}, expected {want}")
    require(b"\xff\xdd" in rst_base and b"\xff\xd0" in rst_base and all(
        map(torch.equal, rst_planes, base_planes)),
        "encode_jpeg with restart intervals: not the restart-less base's "
        "planes")
    require(api0_enc == out["API-0"],
            "API-0: UhdrEncoder bytes differ from JpegR's")

    def scan(jpeg):
        return jpeg[headers.read_headers(jpeg).sos_end:]

    for k in ("API-2", "API-3", "API-4"):
        require(scan(mux.extract_primary_and_gainmap(out[k])[0])
                == scan(base), f"{k}: the primary is not the given base")
    info = {k: jr.get_info(b) for k, b in out.items()}
    require(info["API-0"].primary.exif is not None, "API-0 lost its EXIF")
    # (HDR transfer, SDR gamut) each output was made from.
    made = {"API-0": ("hlg", "bt2100"), "API-1": ("pq", "bt709"),
            "API-3": ("hlg", "p3"), "API-2": ("hlg", "p3"),
            "API-4": ("hlg", "p3"), "API-x": ("hlg", "bt709")}
    for k, (tf, sg) in made.items():
        require((info[k].width, info[k].height, info[k].gainmap_width,
                 info[k].gainmap_height) == (GW, GH, GW // 4, GH // 4),
                f"{k}: bad JPEG/R geometry")
        f16 = decoded[k][OutputFormat.HDR_LINEAR].view(np.float16)
        words = decoded[k][OutputFormat.HDR_HLG]
        sdr = decoded[k][OutputFormat.SDR]
        require(f16.shape == (GH, GW, 4) and bool(np.isfinite(f16).all()),
                f"{k}: bad F16 decode")
        require(words.shape == (GH, GW) and bool(((words >> 30) == 3).all()),
                f"{k}: bad HLG decode")
        require(sdr.shape == (GH, GW) and bool(((sdr >> 24) == 255).all()),
                f"{k}: bad SDR decode")
        med, n = _median_log2(f16, y, uv, "bt2100", tf, sg)
        log(f"general {k} ({len(out[k])} bytes): median |log2(decoded/input "
            f"luminance)| {med:.4f} over {n} pixels")
        require(med <= 0.1, f"general {k}: luminance round trip off")
    return c, dict(y=y, uv=uv, base=base)


def main_path_dense(dev, smi: str):
    """Dense content through the entry points a user calls, in one window
    with every launch counter and the host Huffman call counters zeroed
    just before and read just after: a 4080x3072 batch of 2 at quality
    100 whose second frame holds a 256x256 patch of uniform noise
    (DENSE_PATCH; its
    blocks pass the JAX encoder's 608-bit buffer) through
    batched_encode_api0, and that frame with its BT.709 SDR rendition
    through JpegR.encode_api1, each blob decoded to F16. As the JAX
    package writes them: B3's count pass flags the batch and its write
    pass never runs, API-0 writes the whole batch restart-less with B19
    and hands off None, API-1 takes the general route (B10b, B10c, B2,
    B19)."""
    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage)
    from libultrahdr_dev_tpu_torch.container import icc as icc_mod
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import codec
    from libultrahdr_dev_tpu_torch.parallel import batched
    from libultrahdr_dev_tpu_torch.types import MAP_COMPRESS_QUALITY

    y, uv = synth_p010(FRAMES, H, W, SEED + 100)
    p = DENSE_PATCH
    r0, c0 = H // 32 * 16, W // 32 * 16
    ny, nuv = dense_p010(1, p, p, SEED + 101)
    y[1, r0:r0 + p, c0:c0 + p] = ny[0]
    uv[1, r0 // 2:(r0 + p) // 2, c0:c0 + p] = nuv[0]
    sy, su, sv = (p[1] for p in sdr_rendition(y, uv, "bt709", dev))
    hdr = RawImage(fmt=PixelFormat.P010, width=W, height=H,
                   gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                   planes={"y": y[1], "uv": uv[1]})
    sdr = RawImage(fmt=PixelFormat.YUV420, width=W, height=H,
                   gamut=ColorGamut.BT709, planes={"y": sy, "u": su, "v": sv})
    jr = JpegR(dev)

    reset_counts()
    t0 = time.perf_counter()
    blobs, handoff = batched.batched_encode_api0(
        y, uv, gamut="bt2100", hdr_tf="hlg", quality=100, device=dev,
        return_handoff=True)
    api1 = jr.encode_api1(hdr, sdr, ColorTransfer.HLG, 100)
    f16 = [jr.decode(b, OutputFormat.HDR_LINEAR).image.planes["rgba"]
           for b in blobs + [api1]]
    c = read_counts(f"dense content ({time.perf_counter() - t0:.1f} s)",
                    ("B1", "B2", "B3", "B9", "B10b", "B10c", "B19", "B4",
                     "B5", "B6"))
    require(c["B3w"] == c["B3gw"] == 0,
            "B3's write pass ran on content it flagged")
    require(c["B19"] + c["B19g"] == 4 and c["B10a"] == 0,
            f"dense content: B19 {c['B19'] + c['B19g']} launches (want 4: "
            f"API-0's base and gain map, API-1's general route), B10a "
            f"{c['B10a']}")
    require(handoff is None, "dense API-0 gave a handoff")
    require(not any(bytes([0xFF, 0xD0 + k]) in b for b in blobs + [api1]
                    for k in range(8)), "a dense blob has restart markers")

    # The host-Huffman route of the same restart-less blobs.
    coefs = [t.cpu().numpy() for t in batched.encode_coefs_stage(
        batched.p010_to_device(y, dev), batched.p010_to_device(uv, dev),
        "bt2100", "hlg", 100)]
    base_hdr = codec.yuv420_jpeg_headers(
        W, H, 100, icc=icc_mod.write_icc_profile("srgb", "bt2100"))
    gm_hdr = codec.gray_jpeg_headers(W // 4, H // 4, MAP_COMPRESS_QUALITY)
    for f in range(FRAMES):
        want = mux.append_gainmap(
            base_hdr + codec.encode_yuv420_scan(*(a[f] for a in coefs[:3]),
                                                W, H, 0) + b"\xff\xd9",
            gm_hdr + codec.encode_gray_scan(coefs[3][f], 0) + b"\xff\xd9",
            batched.api0_metadata("hlg"))
        require(blobs[f] == want, f"dense API-0 frame {f}: bytes differ "
                f"from the host-Huffman restart-less blob")
    for i, (sg, label) in enumerate((("bt2100", "API-0 frame 0"),
                                     ("bt2100", "API-0 frame 1"),
                                     ("bt709", "API-1"))):
        k = min(i, 1)
        out = f16[i].view(np.float16)
        require(out.shape == (H, W, 4) and bool(np.isfinite(out).all()),
                f"dense {label}: bad F16 decode")
        med, n = _median_log2(out, y[k], uv[k], "bt2100", "hlg", sg)
        log(f"dense {label} ({len((blobs + [api1])[i])} bytes, no RSTn): "
            f"median |log2(decoded/input luminance)| {med:.4f} over {n} "
            f"pixels")
        require(med <= 0.1, f"dense {label}: luminance round trip off")
    return c


def _log_window_jpegs(dev) -> dict:
    """decode_jpeg's inputs of the log-emission window: 4000x3000 JPEGs
    that encode_jpeg wrote (gray, 4:2:0, 4:2:2, 4:4:4, restart-less)."""
    from libultrahdr_dev_tpu_torch.jpeg import codec

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 60)
    return {name: codec.encode_jpeg(p, 90, device=dev) for name, (p, _)
            in _yuv_variants(y_np[0], uv_np[0]).items()}


def _decode_calls(dev, blobs, handoff, jpegs) -> dict:
    """The log-emission window's decodes, through the entry points a
    user calls; every output on the host."""
    from libultrahdr_dev_tpu_torch import JpegR, OutputFormat
    from libultrahdr_dev_tpu_torch.jpeg import codec
    from libultrahdr_dev_tpu_torch.parallel import batched

    out = {f"batched {fmt}": batched.batched_decode(blobs, fmt, device=dev)
           .cpu() for fmt in ("hdr_hlg", "hdr_linear", "sdr")}
    out["JpegR HLG"] = JpegR(dev).decode(blobs[0], OutputFormat.HDR_HLG) \
        .image.planes["rgba"]
    for fmt in ("hdr_hlg", "sdr"):
        out[f"handoff {fmt}"] = batched.batched_decode_from_handoff(
            handoff, fmt).cpu()
    for name, data in jpegs.items():
        for k, p in enumerate(codec.decode_jpeg(data, dev).planes):
            out[f"decode_jpeg {name} plane {k}"] = p.cpu()
    return out


def _same(a, b) -> bool:
    import torch

    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return torch.equal(a, b)


def main_path_log(dev, smi: str, blobs, handoffs):
    """The log-emission window: the emission default set to "log" for its
    length (as UHDR_DECODE_EMIT=log sets it at import) and restored
    after. The API-0 blob decodes (batched HLG, F16 and SDR, JpegR HLG),
    the handoff decode (HLG, SDR) and decode_jpeg at 4000x3000 (gray,
    4:2:0, 4:2:2, 4:4:4) with every launch counter zeroed just before
    and read just after: B22 launched, B4 not; then the same calls with
    dense emission, each output bitwise equal. Then the decode stages'
    times under both emissions, in turns."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.parallel import batched

    key = CONFIGS[0]
    jpegs = _log_window_jpegs(dev)
    saved = dd._DEFAULT_EMIT
    try:
        dd._DEFAULT_EMIT = "log"
        reset_counts()
        t0 = time.perf_counter()
        got = _decode_calls(dev, blobs[key], handoffs[key], jpegs)
        c = read_counts(f"log-emission window "
                        f"({time.perf_counter() - t0:.1f} s)",
                        ("B22", "B5", "B6", "B7", "B12"))
        require(c["B4"] == 0, f"log-emission window launched B4: {c}")
        dd._DEFAULT_EMIT = "dense"
        want = _decode_calls(dev, blobs[key], handoffs[key], jpegs)
        for name, a in got.items():
            require(_same(a, want[name]), f"log-emission window: {name} "
                    f"differs from the dense route")
        log(f"log-emission window: {len(got)} outputs bitwise equal to the "
            f"dense route's ({', '.join(got)})")

        frames = batched.decode_host_stage(blobs[key])
        ds = dd.parse_device_stream(jpegs["4:2:0"])

        def stages():
            def dec_dev():
                batched.decode_device_stage(frames, "hdr_hlg", math.inf, dev)
                torch.cuda.synchronize()

            def hand():
                batched.batched_decode_from_handoff(handoffs[key], "hdr_hlg")
                torch.cuda.synchronize()

            def dec_jpeg():
                dd.decode_stream_device(ds, dev)
                torch.cuda.synchronize()

            return (host_ms(dec_dev, 5) / FRAMES, host_ms(hand, 5) / FRAMES,
                    host_ms(dec_jpeg, 5))

        times = {}
        for mode in ("dense", "log", "log", "dense"):
            dd._DEFAULT_EMIT = mode
            times.setdefault(mode, []).append(stages())
    finally:
        dd._DEFAULT_EMIT = saved
    for i, name in enumerate((
            f"decode device HLG (H2D + B4|B22 + B5 + B6; {W}x{H}, batch "
            f"{FRAMES})", f"handoff decode HLG (B4|B22 + B5 + B6; {W}x{H}, "
            f"batch {FRAMES})", f"decode_jpeg device 4:2:0 (H2D + B4|B22 + "
            f"B5; {GW}x{GH}, batch 1)")):
        log(f"stage {name}: dense {times['dense'][0][i]:.3f}, "
            f"{times['dense'][1][i]:.3f}; log {times['log'][0][i]:.3f}, "
            f"{times['log'][1][i]:.3f} ms/frame ({smi})")
    return c


def stage_times(dev, smi: str, inputs, blobs, handoffs, api1):
    """Warm per-frame times of the stages (batch of FRAMES, first
    configuration of each route), each ending synchronized. `api1` is
    (inputs, blobs) of main_path_api1."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import batched

    gamut, tf = CONFIGS[0]
    y, uv = inputs[CONFIGS[0]]
    yd, uvd = (batched.p010_to_device(a, dev) for a in (y, uv))
    fmt = f"hdr_{tf}"

    def enc_dev():
        s = batched.encode_device_stage(yd, uvd, gamut, tf, 95)
        torch.cuda.synchronize()
        return s

    streams = enc_dev()
    frames = batched.decode_host_stage(blobs[gamut, tf])

    def dec_dev():
        batched.decode_device_stage(frames, fmt, math.inf, dev)
        torch.cuda.synchronize()

    def hand():
        batched.batched_decode_from_handoff(handoffs[gamut, tf], fmt)
        torch.cuda.synchronize()

    k1 = API1_CONFIGS[0]
    planes1 = ([batched.p010_to_device(a, dev) for a in api1[0][k1][:2]]
               + [torch.from_numpy(p).to(dev) for p in api1[0][k1][2:]])

    def enc_dev_api1():
        batched.encode_device_stage_api1(*planes1, *k1, 95)
        torch.cuda.synchronize()

    frames_sdr = batched.decode_host_stage(api1[1][k1], "sdr")

    def dec_dev_sdr():
        batched.decode_device_stage(frames_sdr, "sdr", math.inf, dev)
        torch.cuda.synchronize()

    stages = {
        "encode_device (B1+B2+B3)": host_ms(enc_dev, 5),
        "encode_host (D2H+finalize+mux)": host_ms(
            lambda: batched.assemble_api0(streams, gamut, tf, 95), 3),
        "decode_host (parse+destuff)": host_ms(
            lambda: batched.decode_host_stage(blobs[gamut, tf]), 3),
        "decode_device (H2D+B4+B5+B6)": host_ms(dec_dev, 5),
        "handoff_decode (B4+B5+B6)": host_ms(hand, 5),
    }
    for k, v in stages.items():
        log(f"stage {k}: {v / FRAMES:.3f} ms/frame ({W}x{H}, batch "
            f"{FRAMES}, {gamut}/{tf} -> {fmt}, {smi})")
    for k, v in {"encode_device API-1 (B9+B2+B3)": host_ms(enc_dev_api1, 5),
                 "decode_device SDR (H2D+B4+B5+B7)": host_ms(dec_dev_sdr, 5),
                 }.items():
        log(f"stage {k}: {v / FRAMES:.3f} ms/frame ({W}x{H}, batch "
            f"{FRAMES}, {'/'.join(k1)}, {smi})")


def host_huffman_general(c, exif: bytes) -> bytes:
    """The general route's JPEG/R from its device stage's blocks by the
    host Huffman coder (the JAX package's route, codec.py:375-393): each
    JPEG's blocks to the host in one copy, entropy.cpp, markers, mux.
    The reference B19's route is held against and timed beside."""
    import torch

    from libultrahdr_dev_tpu_torch.container import icc as icc_mod
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import codec

    def jpeg(j, icc):
        flat = torch.cat([t.reshape(-1) for t in j.coefs]).cpu().numpy()
        blocks = np.split(flat.reshape(-1, 64),
                          np.cumsum([t.shape[1] for t in j.coefs])[:-1])
        if j.sampling is None:
            return (codec.gray_jpeg_headers(j.width, j.height, j.quality, icc)
                    + codec.encode_gray_scan(blocks[0], 0) + b"\xff\xd9")
        return (codec.ycbcr_jpeg_headers(j.width, j.height, j.quality,
                                         j.sampling, icc)
                + codec.encode_ycbcr_scan(*blocks, *_mcus(j), j.sampling, 0)
                + b"\xff\xd9")

    return mux.append_gainmap(
        jpeg(c.base, icc_mod.write_icc_profile("srgb", c.gamut)),
        jpeg(c.gainmap, None), c.metadata, exif=exif)


def stage_times_general(dev, smi: str, general: dict):
    """Warm times of the general route's stages (one 4000x3000 frame,
    API-0 BT.2100 HLG with EXIF) and of decode_jpeg's device stage on
    the general window's P3 base, each ending synchronized."""
    import torch

    from libultrahdr_dev_tpu_torch import jpegr
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    yd, uvd = jpegr.upload_frame(general["y"], general["uv"], None, dev)

    def enc_dev():
        c = jpegr.general_device_stage(yd, uvd, None, "bt2100", "bt2100",
                                       "hlg", 95)
        torch.cuda.synchronize()
        return c

    coefs = enc_dev()
    ds = dd.parse_device_stream(general["base"])

    def dec_dev():
        dd.decode_stream_device(ds, dev)
        torch.cuda.synchronize()

    blob = jpegr.general_host_stage(coefs, EXIF)
    require(host_huffman_general(coefs, EXIF) == blob,
            "general route: B19's JPEG/R differs from the host-Huffman one")
    for k, v in {
            "encode general API-0 device (B10a+B10b+B10c+B2)":
                host_ms(enc_dev, 5),
            "encode general host (B19 + D2H of the streams + finalize + "
            "mux)": host_ms(lambda: jpegr.general_host_stage(coefs, EXIF), 5),
            "encode general host, host-Huffman reference (D2H of the "
            "blocks + entropy.cpp + mux)": host_ms(
                lambda: host_huffman_general(coefs, EXIF), 3),
            "decode_jpeg device 4:2:0 (H2D + B4 + B5)": host_ms(dec_dev, 5),
            }.items():
        log(f"stage {k}: {v:.3f} ms/frame ({GW}x{GH}, batch 1, {smi})")


def converter_chain():
    """The converter window's effect chain on a 4000x3000 frame: crop to
    rows 376-2624, rotate 90 degrees, mirror, resize to 1080x1920. Its
    gain map (1000x750, the chain scaled by 4) ends at 270x480, an
    integer 4:1 ratio to the SDR."""
    from libultrahdr_dev_tpu_torch.ops import editor

    return [editor.CropEffect(0, GW, *CONV_ROWS), editor.RotateEffect(90),
            editor.MirrorEffect("horizontal"), editor.ResizeEffect(*CONV_SIZE)]


def _touched(img, effects) -> int:
    """Distinct source bytes a chain reads: the plain chain run over
    planes that hold their own element indices."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import editor

    idx = {k: torch.arange(p.numel(), dtype=torch.int32,
                           device=p.device).reshape(p.shape)
           for k, p in img.planes.items()}
    out = editor.apply_effects_plain(
        type(img)(img.fmt, img.width, img.height, planes=idx), effects)
    return sum(int(torch.unique(p).numel()) for p in out.planes.values())


def _library_calls(img, e):
    """One PyTorch call per plane computing effect `e` (the yardstick):
    a sliced .contiguous() for crop, torch.flip, torch.rot90(p,
    k).contiguous(), an advanced-index gather for resize."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import editor

    calls = []
    for name, ((kind, h, w, a, b, c, d),) in editor.plan_effects(
            img, [e])[2].items():
        p = img.planes[name]
        if kind == editor.CROP:
            calls.append(lambda p=p, a=a, b=b, c=c, d=d:
                         p[a:a + c, b:b + d].contiguous())
        elif kind == editor.MIRROR:
            calls.append(lambda p=p, a=a: torch.flip(p, (1 if a else 0,)))
        elif kind == editor.ROTATE:
            k = {90: 3, 180: 2, 270: 1}[a]
            calls.append(lambda p=p, k=k: torch.rot90(p, k).contiguous())
        else:
            rows = (torch.arange(c, device=p.device) * h // c)[:, None]
            cols = (torch.arange(d, device=p.device) * w // d)[None, :]
            calls.append(lambda p=p, r=rows, q=cols: p[r, q])
    return lambda: [f() for f in calls]


def b13_phase(dev, results: dict):
    """B13 (the effect chain) bitwise equal to its plain version on a
    4000x3000 YUV420 frame: each single effect (timed beside one PyTorch
    call per plane), the converter's 4-step chain on the frame and its
    1000x750 gain map (the kernels line's row; one launch per image),
    a 22-step chain that takes two launches, and the edges of the
    kernel's tiles (b13_edges)."""
    import torch

    from libultrahdr_dev_tpu_torch import PixelFormat, RawImage
    from libultrahdr_dev_tpu_torch.ops import editor

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 70)
    planes = [(a >> 8).astype(np.uint8) for a in
              (y_np[0], uv_np[0, :, 0::2], uv_np[0, :, 1::2])]
    frame = RawImage(fmt=PixelFormat.YUV420, width=GW, height=GH,
                     planes={k: torch.from_numpy(p).to(dev)
                             for k, p in zip("yuv", planes)})
    gmap = RawImage(fmt=PixelFormat.MONOCHROME, width=GW // 4,
                    height=GH // 4, planes={"y": torch.from_numpy(
                        np.ascontiguousarray(planes[0][::4, ::4])).to(dev)})

    chain = converter_chain()
    # The single crop cuts columns too: a crop of whole rows is a view in
    # PyTorch, and its .contiguous() copies nothing.
    crop = editor.CropEffect(GW // 20, GW - GW // 20, *CONV_ROWS)
    singles = {f"crop {crop.right - crop.left}x{crop.bottom - crop.top}":
               crop,
               "mirror horizontal": chain[2],
               "rotate 90": chain[1],
               "rotate 180": editor.RotateEffect(180),
               "resize {}x{}".format(*CONV_SIZE): chain[3]}
    rows = {}
    for label, e in singles.items():
        got = b13_check(f"B13 {label}", frame, [e], launches=1)
        row = dict(
            ms=graph_ms(lambda: editor.apply_effects(frame, [e]), 20),
            plain_ms=cuda_ms(lambda: editor.apply_effects_plain(frame, [e]),
                             5),
            library_ms=graph_ms(_library_calls(frame, e), 20),
            bytes=_touched(frame, [e]) + nbytes(*got.planes.values()))
        row["bound_ms"], row["bound_by"] = bound(row["bytes"])
        rows[label] = row
        log(f"B13 {label}: bitwise = plain; kernel {row['ms']:.4f} ms "
            f"(1 launch, CUDA graph; parent, PR 14, 3 launches: "
            f"{PARENT_MS.get('B13 ' + label, 'not recorded')}), library "
            f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bytes'] / 1e6:.2f} MB)")

    gchain = editor.scale_effects(chain, 4)

    def run():
        return (editor.apply_effects(frame, chain),
                editor.apply_effects(gmap, gchain))

    got = (b13_check("B13 converter chain, frame", frame, chain, launches=1),
           b13_check("B13 converter chain, gain map", gmap, gchain,
                     launches=1))
    cw, ch = CONV_SIZE
    require((got[0].width, got[0].height, got[1].width, got[1].height) ==
            (cw, ch, cw // 4, ch // 4), "B13 converter chain: bad geometry")
    long_chain = [editor.RotateEffect(90), editor.MirrorEffect("vertical"),
                  editor.RotateEffect(270),
                  editor.MirrorEffect("horizontal")] * 5 + chain[:2]
    require(len(long_chain) > editor.MAX_STEPS,
            "B13: the long chain fits one launch")
    b13_check("B13 22-step chain", frame, long_chain, launches=2)
    results["B13"] = dict(
        err=0, ms=graph_ms(run, 20), enqueue_ms=cuda_ms(run, 20),
        plain_ms=cuda_ms(lambda: (editor.apply_effects_plain(frame, chain),
                                  editor.apply_effects_plain(gmap, gchain)),
                         5),
        bytes=(_touched(frame, chain) + _touched(gmap, gchain)
               + nbytes(*got[0].planes.values(), *got[1].planes.values())),
        library_ms=None, rows=rows)
    r = results["B13"]
    log(f"B13 converter chain (frame + gain map, 2 launches): bitwise = "
        f"plain; kernel {r['ms']:.4f} ms by CUDA graph ({r['enqueue_ms']:.4f}"
        f" launched one by one; parent, PR 14, 4 launches: "
        f"{PARENT_MS['B13 converter chain']:.4f} by graph, 0.136 one by "
        f"one), plain {r['plain_ms']:.3f} ms, {r['bytes'] / 1e6:.2f} MB")
    b13_edges(dev, frame, gmap)


def b13_check(label: str, img, effects, launches: int):
    """apply_effects on `img` bitwise equal to the plain version, in
    `launches` B13 launches (all planes of the image in each)."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import editor

    before = editor.apply_effects.launches
    got = editor.apply_effects(img, effects)
    n = editor.apply_effects.launches - before
    want = editor.apply_effects_plain(img, effects)
    require((got.width, got.height) == (want.width, want.height) and all(
        torch.equal(got.planes[k], want.planes[k]) for k in want.planes),
        f"{label}: kernel differs from the plain version")
    require(n == launches, f"{label}: {n} B13 launches, not {launches}")
    log(f"{label}: {got.width}x{got.height}, bitwise = plain in {n} "
        f"launch{'es' if n > 1 else ''}")
    return got


def b13_edges(dev, frame, gmap):
    """B13 at the edges of its tiles and chunks, bitwise: a 4001x2999
    frame (2001x1500 chroma) through each effect; a crop to an odd width
    at a left edge that is no multiple of 16; a 2x resize up; quarter
    turns of a plane whose sides are no multiple of the 64-row tile; the
    monochrome gain map through each effect."""
    import torch

    from libultrahdr_dev_tpu_torch import PixelFormat, RawImage
    from libultrahdr_dev_tpu_torch.ops import editor

    rng = np.random.default_rng(SEED + 71)
    h, w = 2999, 4001
    odd = RawImage(fmt=PixelFormat.YUV420, width=w, height=h, planes={
        k: torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
        for k, s in (("y", (h, w)), ("u", ((h + 1) // 2, (w + 1) // 2)),
                     ("v", ((h + 1) // 2, (w + 1) // 2)))})
    require(tuple(odd.planes["u"].shape) == (1500, 2001),
            "B13: bad odd chroma")
    effects = (editor.CropEffect(6, 1087, 3, 2501),
               editor.MirrorEffect("horizontal"),
               editor.MirrorEffect("vertical"), editor.RotateEffect(90),
               editor.RotateEffect(180), editor.RotateEffect(270),
               editor.ResizeEffect(1082, 1924))
    for e in effects:
        b13_check(f"B13 {w}x{h} {e}", odd, [e], launches=1)
    b13_check(f"B13 {GW}x{GH} crop to 1081 wide at left 6", frame,
              [editor.CropEffect(6, 1087, 10, 2011)], launches=1)
    b13_check(f"B13 {GW}x{GH} resize up 2x", frame,
              [editor.ResizeEffect(2 * GW, 2 * GH)], launches=1)
    b13_check(f"B13 {w}x{h} crop, rotate 270, resize, mirror", odd,
              [editor.CropEffect(2, 3001, 1, 2800),
               editor.RotateEffect(270), editor.ResizeEffect(1500, 2000),
               editor.MirrorEffect("horizontal")], launches=1)
    for e in effects[1:] + (editor.CropEffect(5, gmap.width - 99, 3,
                                              gmap.height - 50),
                            editor.ResizeEffect(2000, 1500)):
        b13_check(f"B13 monochrome {gmap.width}x{gmap.height} {e}", gmap,
                  [e], launches=1)


def _b19_check(label: str, kernel, plain, host_scans):
    """B19 kernel vs plain (stream bytes and bits equal) and each frame's
    finalized scan vs the host coder's restart-less scan."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de

    got, want = kernel(), plain()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"B19 {label}: stream or bits differ from the plain version")
    data, bits = got[0].cpu().numpy(), got[1].cpu().numpy()
    span = de.stream_spans(bits)
    for f, scan in enumerate(host_scans):
        require(de.finalize_stream(data[span[f]:span[f + 1]], bits[f])
                == scan, f"B19 {label} frame {f}: the finalized scan "
                f"differs from the host coder's")
    log(f"B19 {label}: {got[0].numel()} stream bytes and bits {bits.tolist()}"
        f" = plain; finalized scans = the host coder's")
    return got


def _yuv_variants(y_np, uv_np):
    """u8 planes of one P010 frame's top bits: y and the 4:2:0, 4:2:2 and
    4:4:4 chroma planes."""
    y8 = (y_np >> 8).astype(np.uint8)
    u8, v8 = ((uv_np[:, k::2] >> 8).astype(np.uint8) for k in (0, 1))
    u2, v2 = (np.repeat(c, 2, 0) for c in (u8, v8))
    u4, v4 = (np.repeat(c, 2, 1) for c in (u2, v2))
    return {"gray": ({"y": y8}, None),
            "4:2:0": ({"y": y8, "u": u8, "v": v8}, (2, 2)),
            "4:2:2": ({"y": y8, "u": u2, "v": v2}, (2, 1)),
            "4:4:4": ({"y": y8, "u": u4, "v": v4}, (1, 1))}


def _host_blocks(c):
    return [t[0].cpu().numpy() for t in c.coefs]


def _mcus(c):
    hs, vs = c.sampling
    return -(-c.width // (8 * hs)), -(-c.height // (8 * vs))


EDGE_RUNS = (15, 16, 17, 31, 32, 47, 48)


def edge_blocks(nb: int, seed: int) -> np.ndarray:
    """(nb, 64) int16 zigzag blocks that walk the Huffman unit sequence's
    edges: zero runs of each EDGE_RUNS length before a nonzero (from the
    DC or from another nonzero), a nonzero at 63 (no EOB), all-zero
    blocks, full blocks, and DCs that swing by ~4000 between
    neighbours; values within +-2000 (tests/test_torch_restartless.py
    holds the same kind against JAX)."""
    rng = np.random.default_rng(seed)
    b = np.zeros((nb, 64), np.int16)

    def nz(n):
        return (rng.integers(1, 2001, n) * rng.choice([-1, 1], n)).astype(
            np.int16)

    for i in range(nb):
        kind = i % 8
        if kind == 0:
            continue                       # all zero, DC included
        b[i, 0] = (2000 if i % 2 else -2000) - int(rng.integers(0, 8))
        if kind == 1:
            b[i, 1:] = nz(63)              # full: 63 AC units, no EOB
        elif kind == 2:
            b[i, 63] = nz(1)[0]            # a run of 62, then 63
        elif kind == 3:
            b[i, [1, 63]] = nz(2)          # 61 zeros between, no EOB
        else:
            run = EDGE_RUNS[(i // 8 + kind) % len(EDGE_RUNS)]
            first = 1 + run if kind == 4 else int(rng.integers(1, 63 - run))
            b[i, first] = nz(1)[0]
            if kind != 4 and first + run + 1 <= 63:
                b[i, first + run + 1] = nz(1)[0]
    return b


def dense_p010(n: int, h: int, w: int, seed: int):
    """Uniform noise in every P010 sample: at quality 100 every block is
    far past the JAX encoder's 608-bit buffer, and the upload's segment
    pack cannot shrink it (it goes dense)."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 1024, (n, h, w)) << 6).astype(np.uint16),
            (rng.integers(0, 1024, (n, h // 2, w)) << 6).astype(np.uint16))


def b19_phase(dev, results: dict):
    """B19 (restart-less Huffman encode) against its plain version and
    the host coder (entropy.cpp, no restart interval): on the general
    route's 4000x3000 base (4:2:0) and gain map (gray), on encode_jpeg's
    4:2:2 and 4:4:4 blocks of the same frame, and on a dense 4080x3072
    batch of 2 (uniform noise P010, quality 100) that B3's count pass
    flags."""
    import torch

    from libultrahdr_dev_tpu_torch import jpegr
    from libultrahdr_dev_tpu_torch.jpeg import codec
    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 90)
    yd, uvd = jpegr.upload_frame(y_np[0], uv_np[0], None, dev)
    g = jpegr.general_device_stage(yd, uvd, None, "bt2100", "bt2100", "hlg",
                                   95)
    yz, uz, vz = g.base.coefs
    (gz,) = g.gainmap.coefs
    mx, my = _mcus(g.base)
    base = _b19_check(
        f"general base 4:2:0 ({GW}x{GH})",
        lambda: de.encode_ycbcr_stream(yz, uz, vz, mx, my),
        lambda: de.encode_ycbcr_stream_plain(yz, uz, vz, mx, my),
        [codec.encode_ycbcr_scan(*_host_blocks(g.base), mx, my, (2, 2), 0)])
    gmap = _b19_check(
        f"general gain map ({GW // 4}x{GH // 4})",
        lambda: de.encode_gray_stream(gz),
        lambda: de.encode_gray_stream_plain(gz),
        [codec.encode_gray_scan(_host_blocks(g.gainmap)[0], 0)])
    for name, (planes, samp) in _yuv_variants(y_np[0], uv_np[0]).items():
        if name not in ("4:2:2", "4:4:4"):
            continue
        c = codec.jpeg_coefs(planes, 90, device=dev)
        cx, cy = _mcus(c)
        _b19_check(f"encode_jpeg {name}",
                   lambda: de.encode_ycbcr_stream(*c.coefs, cx, cy, samp),
                   lambda: de.encode_ycbcr_stream_plain(*c.coefs, cx, cy,
                                                        samp),
                   [codec.encode_ycbcr_scan(*_host_blocks(c), cx, cy, samp,
                                            0)])

    # The unit sequence's edges at a size that spans several 256-block
    # tiles: 3 frames of 858 (4:2:0) and 701 (gray) blocks, not
    # multiples of 256, the frames of different bit lengths.
    ex, ey, enb = 13, 11, 701
    e = [np.stack([edge_blocks(k, SEED + 10 * c + f) for f in range(3)])
         for c, k in enumerate((4 * ex * ey, ex * ey, ex * ey, enb))]
    e[0][1] //= 3
    e[3][2] //= 7
    et = [torch.from_numpy(a).to(dev) for a in e]
    _b19_check("edge blocks 4:2:0, 3 frames",
               lambda: de.encode_ycbcr_stream(*et[:3], ex, ey),
               lambda: de.encode_ycbcr_stream_plain(*et[:3], ex, ey),
               [codec.encode_ycbcr_scan(e[0][f], e[1][f], e[2][f], ex, ey,
                                        (2, 2), 0) for f in range(3)])
    _b19_check("edge blocks gray, 3 frames",
               lambda: de.encode_gray_stream(et[3]),
               lambda: de.encode_gray_stream_plain(et[3]),
               [codec.encode_gray_scan(e[3][f], 0) for f in range(3)])
    log(f"B19 edge blocks: {3 * (6 * ex * ey + enb)} blocks in "
        f"{3 * (-(-6 * ex * ey // 256) + -(-enb // 256))} tiles checked")

    def kernel():
        return (de.encode_ycbcr_stream(yz, uz, vz, mx, my),
                de.encode_gray_stream(gz))

    def plain():
        return (de.encode_ycbcr_stream_plain(yz, uz, vz, mx, my),
                de.encode_gray_stream_plain(gz))

    results["B19"] = dict(
        err=0, ms=cuda_ms(kernel, 10), plain_ms=cuda_ms(plain, 2),
        bytes=nbytes(yz, uz, vz, gz, *base, *gmap), library_ms=None)

    yn, uvn = dense_p010(FRAMES, H, W, SEED + 91)
    coefs = batched.encode_coefs_stage(batched.p010_to_device(yn, dev),
                                       batched.p010_to_device(uvn, dev),
                                       "bt2100", "hlg", 100)
    dy, du, dv, dg = coefs
    require(de.encode_ycbcr_rst_stream(dy, du, dv, W // 16, H // 16,
                                       batched.RST_INTERVAL,
                                       block_cap=de.BLOCK_BIT_CAP) is None,
            "B3's count pass did not flag the dense batch")
    host = [c.cpu().numpy() for c in coefs]
    dense = [_b19_check(
        f"dense {W}x{H} base, batch {FRAMES}",
        lambda: de.encode_ycbcr_stream(dy, du, dv, W // 16, H // 16),
        lambda: de.encode_ycbcr_stream_plain(dy, du, dv, W // 16, H // 16),
        [codec.encode_yuv420_scan(host[0][f], host[1][f], host[2][f], W, H,
                                  0) for f in range(FRAMES)]),
        _b19_check(f"dense {W // 4}x{H // 4} gain map, batch {FRAMES}",
                   lambda: de.encode_gray_stream(dg),
                   lambda: de.encode_gray_stream_plain(dg),
                   [codec.encode_gray_scan(host[3][f], 0)
                    for f in range(FRAMES)])]
    r = results["B19"]
    r["dense_ms"] = cuda_ms(lambda: (
        de.encode_ycbcr_stream(dy, du, dv, W // 16, H // 16),
        de.encode_gray_stream(dg)), 5) / FRAMES
    r["dense_bytes"] = nbytes(*coefs, *dense[0], *dense[1]) / FRAMES
    log(f"B19 general base + gain map ({GW}x{GH}): kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, {r['bytes'] / 1e6:.2f} MB; dense "
        f"{W}x{H} q100: kernel {r['dense_ms']:.4f} ms/frame, "
        f"{r['dense_bytes'] / 1e6:.2f} MB/frame")
    log_breakdown(f"B19 general base + gain map ({GW}x{GH})", kernel, 10,
                  r["ms"])


# B12-enc's restart intervals (MCUs): tiles of whole intervals (1, 4,
# 17) and intervals longer than a tile at every sampling (86, 300).
B12E_INTERVALS = (1, 4, 17, 86, 300)


def b12e_phase(dev, results: dict):
    """B12-enc (encode_jpeg with restart intervals: B3 at the image's
    sampling) on 4000x3000 gray, 4:2:0, 4:2:2 and 4:4:4 blocks at
    the intervals B12E_INTERVALS: the kernel's stream and chunk bits
    equal the plain
    version's, and its finalized scan the host coder's with RSTn
    markers; encode_jpeg's 4:2:0 bytes are the headers with a DRI, that
    scan and EOI."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import codec
    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 95)
    kept = {}
    for name, (planes, samp) in _yuv_variants(y_np[0], uv_np[0]).items():
        c = codec.jpeg_coefs(planes, 90, device=dev)
        hb = _host_blocks(c)
        for r in B12E_INTERVALS:
            got = codec.entropy_stage(c, r)
            if samp is None:
                want = de.encode_gray_rst_stream_plain(c.coefs[0], r)
                host = codec.encode_gray_scan(hb[0], r)
            else:
                cx, cy = _mcus(c)
                want = de.encode_ycbcr_rst_stream_plain(*c.coefs, cx, cy, r,
                                                        samp)
                host = codec.encode_ycbcr_scan(*hb, cx, cy, samp, r)
            require(torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1]),
                    f"B12-enc {name} r={r}: stream or chunk bits differ "
                    f"from the plain version")
            require(de.finalize_rst_stream(got[0].cpu().numpy(),
                                           got[1][0].cpu().numpy()) == host,
                    f"B12-enc {name} r={r}: scan differs from the host "
                    f"coder's")
            kept[name, r] = host
        log(f"B12-enc {name}: r = {B12E_INTERVALS} kernel = plain = host "
            f"coder with RSTn markers ({len(kept[name, 4])} bytes at r=4)")
    planes, samp = _yuv_variants(y_np[0], uv_np[0])["4:2:0"]
    blob = codec.encode_jpeg(planes, 90, restart_interval=4, device=dev)
    require(blob == codec.ycbcr_jpeg_headers(GW, GH, 90, samp,
                                             restart_interval=4)
            + kept["4:2:0", 4] + b"\xff\xd9",
            "encode_jpeg(restart_interval=4) differs from the host route")
    c = codec.jpeg_coefs(planes, 90, device=dev)
    cx, cy = _mcus(c)
    out = codec.entropy_stage(c, 4)
    results["B12e"] = dict(
        err=0, ms=cuda_ms(lambda: codec.entropy_stage(c, 4), 10),
        plain_ms=cuda_ms(lambda: de.encode_ycbcr_rst_stream_plain(
            *c.coefs, cx, cy, 4, samp), 2),
        bytes=nbytes(*c.coefs, *out), library_ms=None)
    log_breakdown(f"B12-enc 4:2:0 r=4 ({GW}x{GH})",
                  lambda: codec.entropy_stage(c, 4), 10,
                  results["B12e"]["ms"])


def main_path_converter(dev, smi: str):
    """The UltraHdr converter at 4000x3000 through the entry points a user
    calls, in one window with every launch counter and the host Huffman
    call counters zeroed just before and read just after: a JPEG/R of
    the general route (API-0 HLG + EXIF, encoded before the window) is
    added to a session and converted to a JPEG/R through the 4-step
    chain, the result decoded by UhdrDecoder to F16 with its gain-map
    image, and the session converted to YUV420, RGBA8888 and 10-bit
    planar RGB through the same chain. B19 codes the two JPEGs of the
    one generated JPEG/R; host Huffman codes and decodes nothing."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrDecoder, UltraHdr,
                                           UltraHdrConfig)
    from libultrahdr_dev_tpu_torch.ops import editor

    y_np, uv_np = synth_p010(1, GH, GW, SEED + 80)
    hlg = RawImage(fmt=PixelFormat.P010, width=GW, height=GH,
                   gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                   planes={"y": y_np[0], "uv": uv_np[0]})
    jr = JpegR(dev)
    blob = jr.encode_api0(hlg, ColorTransfer.HLG, 95, exif=EXIF)
    unedited = jr.decode(blob, OutputFormat.HDR_LINEAR).image.planes["rgba"]
    chain = converter_chain()
    raw_fmts = (PixelFormat.YUV420, PixelFormat.RGBA8888,
                PixelFormat.RGB_10BIT_PLANAR)

    reset_counts()
    t0 = time.perf_counter()
    session = UltraHdr(dev).add_image(blob)
    out = session.convert(UltraHdrConfig("jpeg_r", effects=chain))
    t_conv = time.perf_counter() - t0
    dec = UhdrDecoder(dev).set_image(out)
    f16 = dec.decode().planes["rgba"]
    gm_image = dec.get_gain_map_image()
    raws = {f: session.convert_to_raw(UltraHdrConfig(
        effects=chain, output_pixel_format=f)) for f in raw_fmts}
    c = read_counts(f"converter ({t_conv:.2f} s convert, "
                    f"{time.perf_counter() - t0 - t_conv:.2f} s decode and "
                    f"raw outputs)",
                    ("B2", "B4", "B5", "B6", "B6r", "B7", "B12", "B13",
                     "B19"))
    require(all(c[k] == 0 for k in ("B1", "B3", "B3g", "B9", "B10a", "B10b",
                                     "B10c", "B11")),
            f"the converter launched a kernel off its path: {c}")
    require(c["B19"] + c["B19g"] == 2,
            f"the converter's JPEG/R took {c['B19'] + c['B19g']} B19 "
            f"launches, not 2")

    info = jr.get_info(out)
    cw, ch = CONV_SIZE
    require((info.width, info.height, info.gainmap_width,
             info.gainmap_height) == (cw, ch, cw // 4, ch // 4),
            "converter: bad JPEG/R geometry")
    require(info.primary.exif is not None, "converter: EXIF lost")
    require(gm_image.shape == (ch // 4, cw // 4) and
            gm_image.dtype == np.uint8, "converter: bad gain-map image")
    require(f16.shape == (ch, cw, 4) and
            bool(np.isfinite(f16.view(np.float16)).all()),
            "converter: bad F16 decode")
    yuv = raws[PixelFormat.YUV420]
    ref = editor.apply_effects_plain(session.sdr_raw, chain)
    require(all(np.array_equal(yuv.planes[k], ref.planes[k].cpu().numpy())
                for k in ("y", "u", "v")),
            "converter: YUV420 output differs from the plain editor")
    rgba = raws[PixelFormat.RGBA8888].planes["rgba"]
    require(rgba.shape == (ch, cw) and bool(((rgba >> 24) == 255).all()),
            "converter: bad RGBA8888 output")
    rgb10 = raws[PixelFormat.RGB_10BIT_PLANAR].planes["rgba"]
    require(rgb10.shape == (3, ch, cw) and int(rgb10.max()) <= 1023,
            "converter: bad 10-bit planar output")

    # The edited decode's luminance against the plain editor applied to
    # the unedited decode's luminance (BT.2100 weights; both in the
    # base's gamut).
    def lum(rgba16):
        x = torch.from_numpy(rgba16.view(np.float16)[..., :3]
                             .astype(np.float32)).to(dev)
        return 0.2627 * x[..., 0] + 0.6780 * x[..., 1] + 0.0593 * x[..., 2]

    want = editor.apply_effects_plain(RawImage(
        fmt=PixelFormat.MONOCHROME, width=GW, height=GH,
        planes={"y": lum(unedited)}), chain).planes["y"]
    got = lum(f16)
    keep = (want > 1e-3) & (got > 1e-3)
    med = float(torch.median(torch.abs(torch.log2(got[keep] / want[keep]))))
    log(f"converter: {len(blob)} -> {len(out)} bytes; median |log2(edited "
        f"decode / plain-edited unedited decode)| {med:.4f} over "
        f"{int(keep.sum())} pixels")
    require(med <= 0.1, "converter: edited luminance off")
    return c, dict(blob=blob, chain=chain)


def stage_times_converter(dev, smi: str, conv: dict):
    """Warm times of one converter call (4000x3000 JPEG/R in, the 4-step
    chain, JPEG/R out) and of its three stages, each ending
    synchronized: decode (the gain map at add_image, the base at first
    use: B12 twice), effects (B13 on SDR and gain map), encode (API-x:
    padding, B2, B19, D2H of the streams, finalize, mux)."""
    import torch

    from libultrahdr_dev_tpu_torch import JpegR, UltraHdr, UltraHdrConfig

    blob, chain = conv["blob"], conv["chain"]
    cfg = UltraHdrConfig("jpeg_r", effects=chain)

    def decode():
        s = UltraHdr(dev).add_image(blob)
        s._maybe_decode_jpeg_sdr()
        torch.cuda.synchronize()
        return s

    s = decode()

    def effects():
        edited = s._edited(chain)
        torch.cuda.synchronize()
        return edited

    sdr, gmap = effects()
    for k, v in {
            "converter call (decode + effects + encode)": host_ms(
                lambda: UltraHdr(dev).add_image(blob).convert(cfg), 3),
            "converter decode (B12 base + gain map)": host_ms(decode, 3),
            "converter effects (B13 x 2)": host_ms(effects, 5),
            "converter encode (API-x: B2, B19, D2H, finalize, mux)": host_ms(
                lambda: JpegR(dev).encode_apix(sdr, gmap, s.metadata, 95,
                                               exif=s.exif), 3),
            }.items():
        log(f"stage {k}: {v:.3f} ms/frame ({GW}x{GH} -> "
            f"{CONV_SIZE[0]}x{CONV_SIZE[1]}, batch 1, {smi})")


def _decoded_planes(dev, y_np, uv_np):
    """The u8 planes a decode of the batch gives (B1, B2, then B5 through
    batched._planes, row-strided crops as the decode hands them to B6
    and B18), with the HLG apply scalars of each frame."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import batched

    n = y_np.shape[0]
    coefs = batched.encode_coefs_stage(batched.p010_to_device(y_np, dev),
                                       batched.p010_to_device(uv_np, dev),
                                       "bt2100", "hlg", 95)
    q = np.broadcast_to(np.stack([t.reshape(64) for t in
                                  batched.quant_tables(95)]),
                        (n, 3, 64)).astype(np.int32)
    planes = batched._planes(coefs, torch.from_numpy(q.copy()).to(dev),
                             (W, H, W // 4, H // 4))
    sc = np.stack([batched.apply_scalars(batched.api0_metadata("hlg"),
                                         1000 / 203)] * n)
    return planes, sc


def _rice_edge_batch(bits: int, n: int, h: int, w: int, kind: str,
                     rng) -> np.ndarray:
    """A readback source at the edges B15, B16 and B17 branch on: an (n,
    3h, w) u8 composite (bits 8), (n, h, w) RGBA1010102 words with alpha 3
    (bits 10) or (n, h, w, 4) F16 halves with alpha 1.0 (bits 16), of
    `kind` "smooth" (a random walk along rows), "zero", "noise" (full
    range: the unary cap and the largest k), "carry" (noise but for the
    first 64 columns, which vary by 1 from row to row: a few narrow
    segments among wide ones) or "k15" (bits 16: G - R and G - B flipping
    by 2^15 from row to row, whose best k is 15)."""
    top = 1 << bits
    shape = (n, 3 * h, w) if bits == 8 else (n, h, w, 3)
    if kind == "zero":
        ch = np.zeros(shape, np.int64)
    elif kind in ("noise", "carry"):
        ch = rng.integers(0, top, shape)
        if kind == "carry":
            ch[:, :, :64] = top // 2 + rng.integers(0, 2, ch[:, :, :64].shape)
    elif kind == "k15":
        g = rng.integers(0, top, shape[:3])
        flip = (np.arange(h) % 2 * 0x8000)[None, :, None]
        ch = np.stack([g ^ flip, g, g ^ flip ^ 0x8000], axis=-1)
    else:
        ch = np.clip(np.cumsum(rng.integers(-3, 4, shape), axis=2)
                     + top // 2, 0, top - 1)
    if bits == 8:
        return ch.astype(np.uint8)
    if bits == 10:
        return (ch[..., 0] | (ch[..., 1] << 10) | (ch[..., 2] << 20)
                | (3 << 30)).astype(np.uint32).view(np.int32)
    alpha = np.full(shape[:3] + (1,), 0x3C00, np.int64)
    return np.concatenate([ch, alpha], axis=-1).astype(np.uint16) \
        .view(np.int16)


#: (label, n, h, w, kind) of the B15/B16 edge inputs: one partial
#: segment a row, w = 257, nh = 40 (the three planes reset at different
#: rows), an all-zero batch (every segment in the zero rank, an empty
#: remainder family) and full-range noise.
RICE_EDGES = (("w 100", 2, 24, 100, "smooth"), ("w 257", 1, 33, 257, "smooth"),
              ("nh 40", 1, 40, 300, "smooth"), ("all zero", 1, 40, 300, "zero"),
              ("noise", 2, 40, 300, "noise"))
#: B16's order tile (kernels/csrc/packio.cu kOrderTile).
RICE_ORDER_TILE = 2048


def rice_edge_checks(dev, bits: int, seed: int):
    """B15 (vertical, MED, both) and B16 (two-phase on the host plan,
    fused on the plan's paddings (fit) and on one row a bucket (no fit))
    against their plain versions, bitwise, at `bits` on RICE_EDGES (and,
    at 16 bits, samples whose best k is 15), the native host unpack of
    each two-phase blob = the source; then B16's order and emit on
    synthetic maps of nseg one below, at and one above the order's tile
    and over several tiles, with ties in every rank of both families."""
    import torch

    from libultrahdr_dev_tpu_torch.kernels import build
    from libultrahdr_dev_tpu_torch.parallel import packio

    rng = np.random.default_rng(seed)
    edges = RICE_EDGES + ((("k15", 1, 40, 300, "k15"),) if bits == 16
                         else ())
    nk = len(packio._kset(bits))
    for label, n, h, w, kind in edges:
        xh = _rice_edge_batch(bits, n, h, w, kind, rng)
        x = torch.from_numpy(xh).to(dev)
        for schemes in ((False,), (True,), (False, True)):
            zg, mg = packio.rice_stats(x, schemes)
            zr, mr = packio.rice_stats_plain(x, schemes)
            require(all(map(torch.equal, zg, zr)) and torch.equal(mg, mr),
                    f"B15 {bits}-bit {label} {schemes} differs from its "
                    f"plain version")
        maps = mg.cpu().numpy()
        fits, ks = [], []
        for pick, med in ((0, False), (1, True)):
            _, _, rp, up, offs, _ = packio._rice_host_plan(
                maps[2 * pick], maps[2 * pick + 1], 10**15, bits)
            kuw = mg[2 * pick:2 * pick + 2]
            blob = packio.rice_pack(zg[pick], kuw, offs, rp, up, bits)
            require(torch.equal(blob, packio.rice_pack_plain(
                zg[pick], kuw, offs, rp, up)),
                f"B16 {bits}-bit {label} two-phase differs from its plain "
                f"version")
            for pads in ((rp, up), ((1,) * nk, (1,) * 7)):
                fg = packio.rice_fused(x, med, *pads)
                require(torch.equal(fg, packio.rice_fused_plain(x, med,
                                                                *pads)),
                        f"B16 {bits}-bit {label} fused differs from its "
                        f"plain version")
                fits.append(int(fg[packio._fused_blob_words(*pads)]))
            out = packio._host_unpack_rice(
                blob.cpu().numpy().view(np.uint32), maps[2 * pick],
                maps[2 * pick + 1], rp, up, n, h, w, med, bits)
            require(np.array_equal(out.view(xh.dtype), xh),
                    f"{bits}-bit {label} host unpack != the source")
            ks.append(sorted(set(maps[2 * pick].tolist())))
        log(f"B15/B16 {bits}-bit edge {label} ({n}x{h}x{w}, {mg.shape[1]} "
            f"segments): kernels = plain for every scheme, two-phase and "
            f"fused (fit flags {fits}), host unpack = source; k codes "
            f"vertical {ks[0]}, MED {ks[1]}")
    zc = packio._zero_code(nk)
    t = RICE_ORDER_TILE
    def scratch(nseg):
        return build.host_call("uhdr_rice_order_scratch", nseg)

    require(scratch(t) < scratch(t + 1), f"{t} is not B16's order tile")
    for nseg in (t - 1, t, t + 1, 3 * t + 517):
        kc = rng.integers(0, nk + 1, nseg)
        kc[kc == nk] = zc
        uw = np.where(kc == zc, 0, rng.integers(8, 25, nseg))
        kuw_h = np.stack([kc, uw]).astype(np.uint8)
        zs_h = rng.integers(0, 1 << 12, (nseg, RICE_L)).astype(np.int16)
        _, _, rp, up, offs, _ = packio._rice_host_plan(kuw_h[0], kuw_h[1],
                                                       10**15, bits)
        kuw = torch.from_numpy(kuw_h).to(dev)
        zs = torch.from_numpy(zs_h).to(dev)
        require(torch.equal(packio.rice_pack(zs, kuw, offs, rp, up, bits),
                            packio.rice_pack_plain(zs, kuw, offs, rp, up)),
                f"B16 {bits}-bit order/emit at nseg {nseg} differs from "
                f"its plain version")
        sidx = torch.empty((2, nseg), dtype=torch.int32, device=dev)
        packio._rice_order(kuw, sidx, nk=nk)
        k32 = kuw.to(torch.int32)
        want = (packio._stable_order(torch.where(k32[0] == zc, nk, k32[0]),
                                     0),
                packio._stable_order(packio._urank(k32[0], k32[1], zc), 0))
        require(all(torch.equal(sidx[f].long(), want[f]) for f in (0, 1)),
                f"B16 {bits}-bit order at nseg {nseg} differs from the "
                f"stable sort")
    log(f"B16 {bits}-bit order and emit = plain at nseg {t - 1}, {t}, "
        f"{t + 1} and {3 * t + 517} (tile {t}; ties in every rank)")


#: (label, n, h, w, row padding, column offset) of the B18 edge inputs:
#: odd widths (cw and wc not multiples of 16, misaligned output rows),
#: h + ch + gh not a multiple of 3, planes given as strided views of
#: padded planes at an odd column offset, batches of 1 and 4.
B18_EDGES = (("w 4001, batch 1", 1, 3001, 4001, 0, 0),
             ("w 245, batch 4", 4, 123, 245, 0, 0),
             ("views at offset 3, batch 4", 4, 3072, 4080, 16, 3),
             ("views at offset 5, w 1001, batch 1", 1, 777, 1001, 6, 5))


def b18_edges(dev, seed: int):
    """B18 bitwise = its plain version on B18_EDGES: each plane (Y, U, V
    and a quarter-size gain map) of random bytes, as a strided view of a
    larger plane where a padding or an offset is given."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    rng = np.random.default_rng(seed)
    for label, n, h, w, pad, off in B18_EDGES:
        ch, cw = (h + 1) // 2, (w + 1) // 2
        planes = []
        for ph, pw in ((h, w), (ch, cw), (ch, cw), (h // 4, w // 4)):
            big = torch.from_numpy(rng.integers(
                0, 256, (n, ph + pad, pw + pad + off), dtype=np.uint8)).to(dev)
            planes.append(big[:, pad // 2:pad // 2 + ph, off:off + pw])
        comp = gm.planes_composite(*planes)
        require(torch.equal(comp, gm.planes_composite_plain(*planes)),
                f"B18 {label} differs from its plain version")
        rows = h + ch + h // 4
        log(f"B18 edge {label}: kernel = plain, {tuple(comp.shape)} u8 "
            f"(h + ch + gh = {rows}, {rows % 3} mod 3; wc {comp.shape[2]}, "
            f"{comp.shape[2] % 16} mod 16; Y row stride "
            f"{planes[0].stride(1)}, column offset {off})")


#: (label, n, h, w, kind) of the B17 edge inputs (kinds of
#: _rice_edge_batch): an all-zero batch (every segment rank 0: the
#: buckets hold only padding rows), uniform noise (one bucket holds
#: nearly all), nseg not a multiple of the order's 2048-segment tile
#: (one tile; 30 segments; a last tile of one segment), several tiles,
#: the carry case (narrow buckets whose padding rows take width-10
#: segments, whose slots carry into their neighbours), and a width that
#: is not a multiple of 8 with nh % 32 != 0 (the widths pass's clamped
#: loads, its planes' groups starting at different rows).
B17_EDGES = (("all zero", 1, 40, 600, "zero"),
             ("noise", 1, 37, 600, "noise"),
             ("one tile", 1, 37, 600, "smooth"),
             ("nseg 30", 2, 5, 64, "smooth"),
             ("nseg 2049", 1, 683, 64, "smooth"),
             ("several tiles", 2, 96, 1000, "smooth"),
             ("carry", 2, 40, 640, "carry"),
             ("w 1001", 1, 37, 1001, "smooth"))


def b17_check(x, label: str):
    """B17 (widths, the order alone, the pack) on the (n, h, w) RGBA1010102
    batch x against the plain versions, bitwise, the order's rank totals
    against the host's counts and its places against the stable sort,
    the host unpack = x. -> (zs, bc, offs, npads, blob, counts, carry)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    n, h, w = x.shape
    zs, bc = packio.rct_widths(x)
    zp, bp = packio.rct_widths_plain(x)
    require(torch.equal(zs, zp) and torch.equal(bc, bp),
            f"B17 {label}: widths differ from the plain version")
    bm = bc.cpu().numpy()
    flat = bm.reshape(-1)
    counts = np.bincount(packio.FINE_RANK[flat], minlength=9)
    npads = tuple(packio._pow2_pad(max(int(c), 1), floor=32)
                  for c in counts[1:])
    offs = np.cumsum(counts[:8]).astype(np.int32)
    sidx = torch.empty(flat.size, dtype=torch.int32, device=x.device)
    totals = torch.empty(9, dtype=torch.int32, device=x.device)
    packio._rct_order(bc, sidx, totals)
    require(np.array_equal(totals.cpu().numpy(), counts),
            f"B17 {label}: the order's rank totals differ from the host's "
            f"counts")
    rank = torch.from_numpy(packio.FINE_RANK).to(x.device)[bc.reshape(-1)
                                                           .long()]
    require(torch.equal(sidx.long(), packio._stable_order(rank, 0)),
            f"B17 {label}: the order differs from the stable sort")
    blob = packio.rct_pack(zs, bc, offs, npads)
    require(torch.equal(blob, packio.rct_pack_plain(zs, bc, offs, npads)),
            f"B17 {label}: the pack differs from the plain version")
    out = packio._host_unpack_rct(blob.cpu().numpy().view(np.uint32), bm,
                                  npads, n, h, w)
    require(np.array_equal(out, x.cpu().numpy().view(np.uint32)),
            f"B17 {label}: host unpack != the pixels")
    carry = any(c < p and o + c < flat.size
                for c, p, o in zip(counts[1:], npads, offs))
    return zs, bc, offs, npads, blob, counts, carry


def b17_edges(dev, seed: int):
    """b17_check on B17_EDGES; the all-zero batch must put every segment
    in rank 0, the noise nearly all in one bucket, and some input must
    put wider segments in a bucket's padding rows."""
    import torch

    rng = np.random.default_rng(seed)
    carried = False
    for label, n, h, w, kind in B17_EDGES:
        x = torch.from_numpy(_rice_edge_batch(10, n, h, w, kind, rng)).to(dev)
        counts, carry = b17_check(x, label)[5:]
        nseg = int(counts.sum())
        if kind == "zero":
            require(counts[0] == nseg, "B17 all zero: not every segment in "
                    "rank 0")
        if kind == "noise":
            require(counts.max() >= 0.9 * nseg, "B17 noise: no bucket holds "
                    "nearly all segments")
        carried = carried or carry
        log(f"B17 edge {label} ({n}x{h}x{w}, {nseg} segments, "
            f"{-(-nseg // RICE_ORDER_TILE)} order tiles, rank counts "
            f"{counts.tolist()}, padding rows with wider segments: {carry})"
            f": kernels = plain, order = stable sort, totals = counts, "
            f"host unpack = pixels")
    require(carried, "no B17 edge input put wider segments in padding rows")


#: (label, h, w, kind) of the B21a edge planes, at card size: rows that
#: are not 16-byte aligned with a partial last segment (w 1001), less
#: than one segment (w 200), a partial last group (h 37, h 12291), an
#: all-zero plane (every width code 0) and full-range 10-bit noise (every
#: width code 10).
B21_EDGES = (("w 1001", 12288, 1001, "smooth"),
             ("w 200", 12288, 200, "smooth"),
             ("h 37", 37, 4080, "smooth"),
             ("h 12291", 12291, 4080, "smooth"),
             ("all zero", 12288, 4080, "zero"),
             ("noise", 12288, 4080, "noise"))


def b21_edge_plane(h: int, w: int, kind: str, seed: int) -> np.ndarray:
    """An (h, w) int16 plane of 10-bit codes: 16-row bands with small
    noise, all zero, or full-range noise."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((h, w), np.int16)
    if kind == "noise":
        return rng.integers(0, 1024, (h, w)).astype(np.int16)
    base = np.kron(rng.integers(0, 1024, (h // 16 + 1, w // 64 + 1)),
                   np.ones((16, 64), np.int64))[:h, :w]
    # Noise below 1, 2 or 6 by 256-column segment: rows of width codes
    # 0, 2 and 5 beside the 10-bit rows where a band or a group starts.
    amp = np.array([1, 2, 6])[np.arange(w) // 256 % 3]
    noise = (rng.random((h, w)) * amp).astype(np.int64)
    return ((base + noise) % 1024).astype(np.int16)


def b21_check(plane, label: str):
    """B21a on the (h, w) int16 plane, through plane_widths, bitwise
    against the plain version. -> (zs, bc)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    zp, bp = packio.plane_widths_plain(plane)
    zs, bc = packio.plane_widths(plane)
    require(torch.equal(zs, zp) and torch.equal(bc, bp),
            f"B21a {label} differs from the plain version")
    return zs, bc


def b21_edges(dev, seed: int):
    """b21_check on B21_EDGES; the all-zero plane must give width code 0
    everywhere, the noise code 10."""
    import torch

    for i, (label, h, w, kind) in enumerate(B21_EDGES):
        plane = torch.from_numpy(b21_edge_plane(h, w, kind, seed + i)).to(dev)
        bc = b21_check(plane, label)[1]
        codes = sorted(torch.unique(bc).tolist())
        if kind == "zero":
            require(codes == [0], f"B21a all zero: codes {codes}")
        if kind == "noise":
            require(codes == [10], f"B21a noise: codes {codes}")
        log(f"B21a edge {label} ({h}x{w}, {bc.numel()} segments, width "
            f"codes {codes}): kernel = plain")


#: (label, n, h, w, kind) of the B14 edge inputs, each packed by the
#: host's segment pack directly (seg mode whatever the content): every
#: segment all zero (every perm entry 0), full-range noise (every segment
#: in the 10-bit bucket), one partial segment of a width that is not a
#: multiple of 8, the y/uv split inside a launch at group 2, three frames
#: of a width that is no multiple of 256, and bench content with bands
#: of small noise (groups that mix zero segments and all three buckets).
B14_EDGES = (("all zero", 2, 128, 512, "zero"),
             ("noise", 2, 64, 512, "noise"),
             ("w 250", 1, 64, 250, "bench"),
             ("split at group 2", 1, 64, 4080, "bench"),
             ("3 frames, w 1000", 3, 128, 1000, "bench"),
             ("mixed buckets", 2, 128, 4080, "mixed"))


def b14_input(n: int, h: int, w: int, kind: str, seed: int):
    """P010 frames (y (n, h, w), uv (n, h/2, w) uint16) of a B14_EDGES
    kind; "mixed": bench content whose first quarter of luma rows carries
    noise in {0, 1} (2-bit segments) and second quarter noise in 0..7
    (5-bit segments)."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return (np.zeros((n, h, w), np.uint16),
                np.zeros((n, h // 2, w), np.uint16))
    if kind == "noise":
        return (rng.integers(0, 1024, (n, h, w)).astype(np.uint16) << 6,
                rng.integers(0, 1024, (n, h // 2, w)).astype(np.uint16) << 6)
    y, uv = synth_p010(n, h, w, seed)
    if kind == "mixed":
        for rows, top in ((slice(0, h // 4), 2), (slice(h // 4, h // 2), 8)):
            y[:, rows] += rng.integers(0, top, y[:, rows].shape).astype(
                np.uint16) << 6
    return y, uv


def b14_pack(y, uv):
    """The host's segment pack of the P010 frames (y, uv): the tall plane
    of y's and uv's 10-bit codes, packed in seg mode whatever the
    content."""
    from libultrahdr_dev_tpu_torch.parallel import packio

    n, h, w = y.shape
    return packio.pack_plane_host(np.concatenate(
        [(y >> 6).reshape(n * h, w), (uv >> 6).reshape(n * h // 2, w)]))


def b14_check(dev, packed, y, uv, label: str, unpacks=None):
    """B14 on `packed`, the segment pack of (y, uv): plain = the input and
    each of `unpacks` ({name: unpack_plane_device}, by default this
    tree's) = plain, bitwise. -> (blob on the device, plan, the counts of
    zero segments and of each bucket's segments)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    n, h, _ = y.shape
    blob = torch.from_numpy(packed.to_blob().view(np.int32)).to(dev)
    ref = packio.unpack_plane_device_plain(blob, packed.plan, n, h)
    require(np.array_equal(ref[0].cpu().numpy().view(np.uint16), y)
            and np.array_equal(ref[1].cpu().numpy().view(np.uint16), uv),
            f"plain B14 {label} does not rebuild the input")
    for name, unpack in (unpacks or {"this tree": packio.unpack_plane_device
                                     }).items():
        got = unpack(blob, packed.plan, n, h)
        require(all(map(torch.equal, got, ref)), f"{name}: B14 {label} "
                f"differs from its plain version")
    n2, n5 = packed.plan[3:5]
    perm = packed.perm
    kinds = (int((perm == 0).sum()), int(((perm > 0) & (perm <= n2)).sum()),
             int(((perm > n2) & (perm <= n2 + n5)).sum()),
             int((perm > n2 + n5).sum()))
    return blob, packed.plan, kinds


def b14_edges(dev, seed: int):
    """b14_check on B14_EDGES; the all-zero plane must give only zero
    segments, the noise only 10-bit ones, and the mixed content all four
    kinds."""
    for i, (label, n, h, w, kind) in enumerate(B14_EDGES):
        y, uv = b14_input(n, h, w, kind, seed + i)
        _, plan, kinds = b14_check(dev, b14_pack(y, uv), y, uv, label)
        nseg = sum(kinds)
        if kind == "zero":
            require(kinds[0] == nseg, "B14 all zero: a nonzero segment")
        if kind == "noise":
            require(kinds[3] == nseg, "B14 noise: a segment below 10 bits")
        if kind == "mixed":
            require(min(kinds) > 0, f"B14 mixed: zero/2/5/10-bit segments "
                    f"{kinds}")
        log(f"B14 edge {label} ({n}x{h}x{w}, {plan[0]} rows, "
            f"zero/2/5/10-bit segments {kinds}): kernel = plain = input")


def packio_phase(dev, results: dict, kept: dict):
    """B0, B14, B18, B15 and B16 against their plain versions at the
    serving loop's shapes (4080x3072, batch SERVE_FRAMES), bitwise: the
    upload's B14 on bench content (seg mode) and B0 on uniform noise
    (dense mode), each also equal to the input; B18 over a decoded
    batch's planes and at its edges (b18_edges); B15 (vertical, MED,
    both) and B16 (two-phase on the host plan, fused on the same paddings
    and on tight ones) over that composite, then at the edges
    (rice_edge_checks); B16's order and emit timed apart, B15's load and
    residuals apart from its reduction (rice_parts). Keeps the planes and
    composite for the stage times."""
    import torch

    from libultrahdr_dev_tpu_torch.device import upload
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import link, packio

    n = SERVE_FRAMES

    def per_frame(ms):
        return ms / n

    # B14: the segment-packed upload of bench content (the serving loop's
    # pack, seg mode), then its edges.
    y_np, uv_np = synth_p010(n, H, W, SEED + 200)
    pre = link.pack_p010_batch_host(y_np, uv_np)
    require(pre[0] == "seg", f"bench content packed {pre[0]}, not seg")
    blob14, plan14, kinds = b14_check(dev, pre[1], y_np, uv_np, "4080x3072")
    log(f"B14 p010_seg_unpack: kernel = plain = input "
        f"({nbytes(blob14) / 1e6:.2f} MB blob for "
        f"{(y_np.nbytes + uv_np.nbytes) / 1e6:.1f} MB of u16, "
        f"{plan14[3]}/{plan14[4]}/{plan14[5]} rows in the 2/5/10-bit "
        f"buckets, zero/2/5/10-bit segments {kinds})")
    b14_edges(dev, SEED + 206)
    b14 = lambda: packio.unpack_plane_device(blob14, plan14, n, H)  # noqa
    b14_events = per_frame(cuda_ms(b14, 20))
    results["B14"] = dict(
        err=0, ms=per_frame(graph_ms(b14, 20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.unpack_plane_device_plain(
            blob14, plan14, n, H), 3)),
        bytes=(nbytes(blob14) + y_np.nbytes + uv_np.nbytes) / n,
        library_ms=None)
    log(f"B14: {b14_events:.4f} ms/frame by events (parent: "
        f"{PARENT_MS['B14']:.4f} by events), {results['B14']['ms']:.4f} by "
        f"graph (the kernels line's ms)")

    # B0: the dense upload of uniform noise.
    ny, nuv = dense_p010(n, H, W, SEED + 201)
    pre_d = link.pack_p010_batch_host(ny, nuv)
    require(pre_d[0] == "dense", f"noise packed {pre_d[0]}, not dense")
    parts = upload(list(pre_d[1] + pre_d[2]), dev)
    got = packio.unpack_p010_dense(*parts)
    ref = packio.unpack_p010_dense_plain(*parts)
    require(all(map(torch.equal, got, ref)), "B0 differs from its plain "
            "version")
    require(np.array_equal(got[0].cpu().numpy().view(np.uint16), ny)
            and np.array_equal(got[1].cpu().numpy().view(np.uint16), nuv),
            "B0 does not rebuild the uploaded planes")
    log("B0 p010_dense_unpack: kernel = plain = input (uniform noise)")
    results["B0"] = dict(
        err=0, ms=per_frame(cuda_ms(lambda: packio.unpack_p010_dense(*parts),
                                    20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.unpack_p010_dense_plain(
            *parts), 3)), bytes=nbytes(*parts, *got) / n, library_ms=None)
    kept["upload"] = (y_np, uv_np)

    # B18 over a decoded batch's planes.
    planes, sc = _decoded_planes(dev, y_np, uv_np)
    comp = gm.planes_composite(*planes)
    require(torch.equal(comp, gm.planes_composite_plain(*planes)),
            "B18 differs from its plain version")
    log(f"B18 planes_composite: kernel = plain, {tuple(comp.shape)} u8")
    b18_events = per_frame(cuda_ms(lambda: gm.planes_composite(*planes), 20))
    results["B18"] = dict(
        err=0, ms=per_frame(graph_ms(lambda: gm.planes_composite(*planes),
                                     20)),
        plain_ms=per_frame(cuda_ms(lambda: gm.planes_composite_plain(
            *planes), 3)),
        bytes=(sum(p.shape[0] * p.shape[1] * p.shape[2] for p in planes)
               + nbytes(comp)) / n, library_ms=None)
    log(f"B18: {results['B18']['ms']:.4f} ms/frame by graph, {b18_events:.4f}"
        f" by events (parent: {PARENT_MS['B18']:.4f} by events)")
    b18_edges(dev, SEED + 205)
    kept["planes"], kept["scalars"], kept["comp"] = planes, sc, comp

    # B15 on that composite: each scheme and both.
    for schemes in ((False,), (True,), (False, True)):
        zg, mg = packio.rice_stats(comp, schemes)
        zr, mr = packio.rice_stats_plain(comp, schemes)
        require(all(map(torch.equal, zg, zr)) and torch.equal(mg, mr),
                f"B15 {schemes} differs from its plain version")
    nseg = mg.shape[1]
    log(f"B15 rice_stats: zs and maps = plain for vertical, MED and both "
        f"({nseg} segments)")
    require(all(map(torch.equal, packio._rice_residuals(comp, (False, True)),
                    zg)), "B15's residuals-only launch differs")
    row = {}
    for label, schemes in (("one", (True,)), ("both", (False, True))):
        row[label] = dict(
            ms=per_frame(cuda_ms(lambda: packio.rice_stats(comp, schemes),
                                 20)),
            plain_ms=per_frame(cuda_ms(lambda: packio.rice_stats_plain(
                comp, schemes), 3)),
            bytes=(nbytes(comp) + len(schemes) * nseg * (RICE_L * 2 + 2)) / n)
        log(f"B15 {label} scheme(s): kernel {row[label]['ms']:.4f} ms/frame, "
            f"plain {row[label]['plain_ms']:.3f} ms/frame, "
            f"{row[label]['bytes'] / 1e6:.1f} MB/frame")
    results["B15"] = dict(row["both"], err=0, library_ms=None)

    # B16, two-phase on each scheme's host plan, fused on the same
    # paddings (fit) and on tight ones (no fit).
    maps = mg.cpu().numpy()
    zss = zg
    b16 = {}
    for pick, med in ((0, False), (1, True)):
        plan = packio._rice_host_plan(maps[2 * pick], maps[2 * pick + 1],
                                      10**15)
        _, _, rp, up, offs, _ = plan
        kuw = mg[2 * pick:2 * pick + 2]
        got = packio.rice_pack(zss[pick], kuw, offs, rp, up)
        require(torch.equal(got, packio.rice_pack_plain(zss[pick], kuw, offs,
                                                        rp, up)),
                f"B16 two-phase ({'MED' if med else 'vertical'}) differs "
                f"from its plain version")
        for pads in ((rp, up), ((32,) * 10, (32,) * 7)):
            fg = packio.rice_fused(comp, med, *pads)
            require(torch.equal(fg, packio.rice_fused_plain(comp, med, *pads)),
                    f"B16 fused ({'MED' if med else 'vertical'}) differs "
                    f"from its plain version")
        log(f"B16 rice_pack {'MED' if med else 'vertical'}: two-phase and "
            f"fused = plain; blob {got.numel() * 4 / 1e6:.2f} MB for "
            f"{nbytes(comp) / 1e6:.1f} MB raw, fit flag on the tight plan "
            f"{int(fg[packio._fused_blob_words(*pads)])}")
        b16[med] = (zss[pick], kuw, offs, rp, up, got)
    zs, kuw, offs, rp, up, blob16 = b16[True]
    sidx = torch.empty((2, nseg), dtype=torch.int32, device=dev)
    offs_dev = torch.from_numpy(np.asarray(offs, np.int32)).to(dev)
    out = torch.empty_like(blob16)
    order_ms = cuda_ms(lambda: packio._rice_order(kuw, sidx), 20)
    emit_ms = cuda_ms(lambda: packio._rice_emit(zs, kuw, sidx, offs_dev, rp,
                                                up, out), 20)
    require(torch.equal(out, blob16), "B16's timed launches differ")
    log(f"B16 MED: order (count, scan, place) {order_ms:.4f} ms, emit "
        f"{emit_ms:.4f} ms per batch of {n}")
    rice_edge_checks(dev, 8, SEED + 210)
    results["B16"] = dict(
        err=0, ms=per_frame(order_ms + emit_ms),
        plain_ms=per_frame(cuda_ms(lambda: packio.rice_pack_plain(
            zs, kuw, offs, rp, up), 3)),
        bytes=(nbytes(zs, kuw) + nbytes(blob16)) / n, library_ms=None,
        order_ms=per_frame(order_ms))

    # Device time by kernel against the wall time of each wrapper call
    # (per batch): what of each time is the kernel, what the host around
    # it.
    for label, fn, key in (
            ("B0", lambda: packio.unpack_p010_dense(*parts), "B0"),
            ("B14", b14, "B14"),
            ("B18", lambda: gm.planes_composite(*planes), "B18"),
            ("B15 both schemes", lambda: packio.rice_stats(
                comp, (False, True)), "B15")):
        log_breakdown(f"{label} (batch of {n})", fn, 10,
                      results[key]["ms"] * n)
    rice_parts(comp, "B15", results["B15"]["ms"] * n, n)


def rice_parts(x, label: str, full_ms: float, n: int):
    """B15's two parts on x (both schemes): the load and residuals (the
    kernel without its per-segment reduction and maps) and, by
    difference from the whole kernel's full_ms, the reduction and pick of
    k; with the residuals-only launch's device time."""
    from libultrahdr_dev_tpu_torch.parallel import packio

    run = lambda: packio._rice_residuals(x, (False, True))  # noqa: E731
    res_ms = cuda_ms(run, 20)
    log(f"{label} parts (batch of {n}): load + residuals "
        f"{res_ms / n:.4f} ms/frame, reduction + pick of k "
        f"{(full_ms - res_ms) / n:.4f} ms/frame (of {full_ms / n:.4f})")
    log_breakdown(f"{label} load + residuals only (batch of {n})", run, 10,
                  res_ms)


def _decoded_pixels(dev, kept: dict) -> dict:
    """The decoded batch of packio_phase through B6: HLG RGBA1010102
    words, linear F16 halves and the 10-bit planar codes, on the
    device."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    sc = torch.from_numpy(kept["scalars"]).to(dev)
    return {fmt: gm.apply_gainmap(*kept["planes"], sc, fmt)
            for fmt in ("hdr_hlg", "hdr_linear", "hdr_linear_rgb_10bit")}


def readback_phase(dev, results: dict, kept: dict):
    """B15 and B16 at 10 and 16 bits, B17 and B21 against their plain
    versions on a decoded 4080x3072 batch of SERVE_FRAMES, bitwise: B15
    for vertical, MED and both schemes on the HLG and F16 pixels; B16
    two-phase on each scheme's host plan and fused on the same paddings
    (fit) and on tight ones (no fit), the native host unpack of each
    two-phase blob = the device pixels; B17's widths, order and pack on
    the HLG pixels and at its edges (b17_check, b17_edges), its host
    unpack = the pixels; B21's widths and pack on the
    10-bit planar pixels, unpack_plane_host = the plane. B15 and B16 at
    each width also at the edges (rice_edge_checks), with B16's order
    and emit timed apart and B15's two parts (rice_parts)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    n = SERVE_FRAMES

    def per_frame(ms):
        return ms / n

    pix = _decoded_pixels(dev, kept)
    kept["pixels"] = pix
    for bits, fmt in ((10, "hdr_hlg"), (16, "hdr_linear")):
        x = pix[fmt]
        xh = x.cpu().numpy().view(np.uint32 if bits == 10 else np.uint16)
        for schemes in ((False,), (True,), (False, True)):
            zg, mg = packio.rice_stats(x, schemes)
            zr, mr = packio.rice_stats_plain(x, schemes)
            require(all(map(torch.equal, zg, zr)) and torch.equal(mg, mr),
                    f"B15 {bits}-bit {schemes} differs from its plain "
                    f"version")
        nseg = mg.shape[1]
        require(all(map(torch.equal, packio._rice_residuals(
            x, (False, True)), zg)), f"B15 {bits}-bit residuals-only launch "
            f"differs")
        results[f"B15/{bits}"] = dict(
            err=0, library_ms=None,
            ms=per_frame(cuda_ms(lambda: packio.rice_stats(
                x, (False, True)), 20)),
            plain_ms=per_frame(cuda_ms(lambda: packio.rice_stats_plain(
                x, (False, True)), 2)),
            bytes=(nbytes(x) + 2 * nseg * (RICE_L * 2 + 2)) / n)
        maps = mg.cpu().numpy()
        for pick, med in ((0, False), (1, True)):
            plan = packio._rice_host_plan(maps[2 * pick], maps[2 * pick + 1],
                                          10**15, bits)
            _, _, rp, up, offs, _ = plan
            kuw = mg[2 * pick:2 * pick + 2]
            blob = packio.rice_pack(zg[pick], kuw, offs, rp, up, bits)
            require(torch.equal(blob, packio.rice_pack_plain(
                zg[pick], kuw, offs, rp, up)),
                f"B16 {bits}-bit two-phase ({'MED' if med else 'vertical'}) "
                f"differs from its plain version")
            for pads in ((rp, up), ((32,) * len(rp), (32,) * 7)):
                fg = packio.rice_fused(x, med, *pads)
                require(torch.equal(fg, packio.rice_fused_plain(x, med,
                                                                *pads)),
                        f"B16 {bits}-bit fused ({'MED' if med else 'vert'}) "
                        f"differs from its plain version")
            out = packio._host_unpack_rice(
                blob.cpu().numpy().view(np.uint32), maps[2 * pick],
                maps[2 * pick + 1], rp, up, n, H, W, med, bits)
            require(np.array_equal(out, xh), f"{bits}-bit host unpack "
                    f"({'MED' if med else 'vertical'}) != device pixels")
            log(f"B15/B16 {bits}-bit {'MED' if med else 'vertical'}: "
                f"kernels = plain (two-phase, fused fit and no fit), host "
                f"unpack = device pixels; blob {blob.numel() * 4 / 1e6:.2f} "
                f"MB for {nbytes(x) / 1e6:.1f} MB raw ({nseg} segments)")
        zs, kuw = zg[1], mg[2:4]
        results[f"B16/{bits}"] = dict(
            err=0, library_ms=None,
            ms=per_frame(cuda_ms(lambda: packio.rice_pack(
                zs, kuw, offs, rp, up, bits), 20)),
            plain_ms=per_frame(cuda_ms(lambda: packio.rice_pack_plain(
                zs, kuw, offs, rp, up), 2)),
            bytes=(nbytes(zs, kuw) + nbytes(blob)) / n)
        log_breakdown(f"B16 {bits}-bit MED (batch of {n})",
                      lambda: packio.rice_pack(zs, kuw, offs, rp, up, bits),
                      10, results[f"B16/{bits}"]["ms"] * n)
        sidx = torch.empty((2, nseg), dtype=torch.int32, device=dev)
        offs_dev = torch.from_numpy(np.asarray(offs, np.int32)).to(dev)
        out = torch.empty_like(blob)
        order_ms = cuda_ms(lambda: packio._rice_order(kuw, sidx, nk=len(rp)),
                           20)
        emit_ms = cuda_ms(lambda: packio._rice_emit(zs, kuw, sidx, offs_dev,
                                                    rp, up, out), 20)
        require(torch.equal(out, blob), f"B16 {bits}-bit timed launches "
                f"differ")
        log(f"B16 {bits}-bit MED: order (count, scan, place) "
            f"{order_ms:.4f} ms, emit {emit_ms:.4f} ms per batch of {n}")
        log_breakdown(f"B15 {bits}-bit both schemes (batch of {n})",
                      lambda: packio.rice_stats(x, (False, True)), 10,
                      results[f"B15/{bits}"]["ms"] * n)
        rice_parts(x, f"B15 {bits}-bit", results[f"B15/{bits}"]["ms"] * n, n)
        rice_edge_checks(dev, bits, SEED + 211 + bits)

    # B17 on the HLG pixels: kernels = plain, the order alone = the stable
    # sort with the host's counts; then the edges.
    x = pix["hdr_hlg"]
    zs, bc, offs, npads, blob, counts, _ = b17_check(x, "4080x3072")
    log(f"B17 rct_widths + rct_pack: kernels = plain, order totals = host "
        f"counts {counts.tolist()}, host unpack = device pixels; blob "
        f"{blob.numel() * 4 / 1e6:.2f} MB for {nbytes(x) / 1e6:.1f} MB raw "
        f"({bc.numel()} segments)")
    b17_edges(dev, SEED + 212)
    b17a = lambda: packio.rct_widths(x)  # noqa: E731
    b17a_events = per_frame(cuda_ms(b17a, 20))
    results["B17a"] = dict(
        err=0, library_ms=None, ms=per_frame(graph_ms(b17a, 20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.rct_widths_plain(x), 2)),
        bytes=nbytes(x, zs, bc) / n)
    log(f"B17a: {b17a_events:.4f} ms/frame by events (parent: "
        f"{PARENT_MS['B17a']:.4f} by events), {results['B17a']['ms']:.4f} by "
        f"graph (the kernels line's ms)")
    b17b = lambda: packio.rct_pack(zs, bc, offs, npads)  # noqa: E731
    sidx = torch.empty(bc.numel(), dtype=torch.int32, device=dev)
    order = lambda: packio._rct_order(bc, sidx)  # noqa: E731
    results["B17b"] = dict(
        err=0, library_ms=None, ms=per_frame(cuda_ms(b17b, 20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.rct_pack_plain(
            zs, bc, offs, npads), 2)),
        bytes=nbytes(zs, bc, blob) / n)
    order_ms = per_frame(cuda_ms(order, 20))
    graph = per_frame(graph_ms(b17b, 20))
    order_graph = per_frame(graph_ms(order, 20))
    log(f"B17b: {results['B17b']['ms']:.4f} ms/frame by events ({graph:.4f}"
        f" by graph): order (count, scan, place) {order_ms:.4f} "
        f"({order_graph:.4f}), pack {results['B17b']['ms'] - order_ms:.4f} "
        f"({graph - order_graph:.4f}) (parent: "
        f"{PARENT_MS['B17b']:.4f} by events)")
    log_breakdown(f"B17 pack (batch of {n})", b17b, 10,
                  results["B17b"]["ms"] * n)

    # B21 on the 10-bit planar pixels, one (3 * n * H, W) plane, then
    # B21a's edges.
    plane = pix["hdr_linear_rgb_10bit"].reshape(-1, W)
    zs, bc = b21_check(plane, f"{W}x{H}")
    b21_edges(dev, SEED + 213)
    _, gidx = packio._plane_plan(bc.cpu().numpy().reshape(-1))
    sizes = tuple(g.size for g in gidx)
    gd = torch.from_numpy(np.concatenate(gidx)).to(dev)
    blob = packio.plane_pack(zs, gd, sizes)
    require(torch.equal(blob, packio.plane_pack_plain(zs, gd, sizes)),
            "B21 pack differs from the plain version")
    pk = packio.pack_plane_device(plane)
    require(np.array_equal(packio.unpack_plane_host(pk),
                           plane.cpu().numpy().view(np.uint16)),
            "B21 unpack_plane_host != the device plane")
    log(f"B21 plane_widths + plane_pack: kernels = plain, unpack = device "
        f"plane; blob {blob.numel() * 4 / 1e6:.2f} MB for "
        f"{nbytes(plane) / 1e6:.1f} MB raw (buckets {sizes})")
    b21a = lambda: packio.plane_widths(plane)  # noqa: E731
    results["B21a"] = dict(
        err=0, library_ms=None, ms=per_frame(cuda_ms(b21a, 20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.plane_widths_plain(plane),
                                   2)),
        bytes=nbytes(plane, zs, bc) / n)
    log(f"B21a: {results['B21a']['ms']:.4f} ms/frame by events (parent: "
        f"{PARENT_MS['B21a']:.4f} by events), "
        f"{per_frame(graph_ms(b21a, 20)):.4f} by graph")
    results["B21b"] = dict(
        err=0, library_ms=None,
        ms=per_frame(cuda_ms(lambda: packio.plane_pack(zs, gd, sizes), 20)),
        plain_ms=per_frame(cuda_ms(lambda: packio.plane_pack_plain(
            zs, gd, sizes), 2)),
        bytes=(nbytes(gd, blob) + sum(sizes) * RICE_L * 2) / n)


def plain_calls() -> dict:
    """Calls of the new kernels' plain versions (a CUDA main path makes
    none)."""
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import packio

    return {"B0": packio.unpack_p010_dense_plain,
            "B14": packio.unpack_plane_device_plain,
            "B15": packio.rice_stats_plain, "B16": packio.rice_pack_plain,
            "B17a": packio.rct_widths_plain, "B17b": packio.rct_pack_plain,
            "B18": gm.planes_composite_plain,
            "B21a": packio.plane_widths_plain,
            "B21b": packio.plane_pack_plain}


def main_path_serving(dev, smi: str):
    """The serving loop (libultrahdr_dev_tpu_torch/serving.py) at the JAX
    loop's defaults, 4080x3072, batch SERVE_FRAMES, SERVE_ROUNDS rounds,
    HLG, then one --f16 round, then one round of a batch of 2 frames of
    uniform noise (the content rules: a dense upload through B0, a raw
    readback where the Rice pack declines), in one window with every
    launch counter, the plain versions' call counters and the host
    Huffman counters zeroed just before and read just after: the upload
    packs seg (dense for the noise), the fetched composite is bitwise
    the device composite, and the host apply's pixels are within 1
    ten-bit code / 1 F16 ULP of the port's device-apply decode of the
    same blobs."""
    from libultrahdr_dev_tpu_torch import serving
    from libultrahdr_dev_tpu_torch.parallel import batched, packio

    reset_counts()
    for fn in plain_calls().values():
        fn.calls = 0
    t0 = time.perf_counter()
    res = serving.run(SERVE_FRAMES, H, W, SERVE_ROUNDS, device=dev, log=log)
    stages_hlg = dict(packio.LAST_FETCH_STAGES)
    pick_hlg = packio.LAST_PICK
    res16 = serving.run(SERVE_FRAMES, H, W, 1, f16=True, device=dev, log=log)
    stages_f16 = dict(packio.LAST_FETCH_STAGES)
    pick_f16 = packio.LAST_PICK
    resn = serving.run(frames=dense_p010(2, H, W, SEED + 300), rounds=1,
                       device=dev, log=log)
    c = read_counts(f"serving loop ({time.perf_counter() - t0:.1f} s)",
                    SERVE_KERNELS)
    calls = {k: fn.calls for k, fn in plain_calls().items()}
    log(f"serving loop: plain-version calls {calls}; HLG rounds: last pick "
        f"{pick_hlg}, fetch stages {stages_hlg}; F16 round: pick "
        f"{pick_f16}, fetch stages {stages_f16}")
    require(not any(calls.values()), f"plain versions ran: {calls}")
    rounds = ([("HLG", st) for st in res.stats] + [("F16", res16.stats[0]),
                                                    ("noise", resn.stats[0])])
    for r, (label, st) in enumerate(rounds):
        log(f"serving round {r} ({label}): h2d {st['h2d_pack']} "
            f"{st['h2d_bytes']} B, d2h {st['d2h_pack']} {st['d2h_bytes']} B, "
            f"host apply {st['host_apply_ms']} ms")
        want = "dense" if label == "noise" else "seg"
        require(st["h2d_pack"] == want,
                f"round {r} ({label}) uploaded {st['h2d_pack']}, not {want}")
    require(resn.stats[0]["d2h_pack"] == "planes-raw",
            "the noise composite was Rice-packed")
    for label, rr in (("HLG", res), ("F16", res16), ("noise", resn)):
        require(np.array_equal(rr.comp, rr.comp_dev.cpu().numpy()),
                f"{label}: the fetched composite differs from the device's")
    d = []
    for rr in (res, resn):
        dev_hlg = batched.batched_decode(rr.blobs, "hdr_hlg", serving.BOOST,
                                         device=dev).cpu().numpy().view(
                                             np.uint32)
        d.append(np.stack([np.abs(((rr.pixels >> s) & 1023).astype(np.int32)
                                  - ((dev_hlg >> s) & 1023).astype(np.int32))
                           for s in (0, 10, 20)]).reshape(-1))
    d = np.concatenate(d)
    dev_f16 = batched.batched_decode(res16.blobs, "hdr_linear", serving.BOOST,
                                     device=dev).cpu().numpy().view(np.uint16)
    d16 = np.abs(res16.pixels[..., :3].astype(np.int32)
                 - dev_f16[..., :3].astype(np.int32))
    log(f"serving loop: host apply vs device apply of the same blobs: HLG max "
        f"{int(d.max())} code ({float((d == 0).mean()):.6f} exact), F16 max "
        f"{int(d16.max())} ULP ({float((d16 == 0).mean()):.6f} exact)")
    require(int(d.max()) <= 1 and int(d16.max()) <= 1,
            "host apply off the device apply by more than 1 code / ULP")
    iv = res.intervals_ms
    log(f"stage pipelined serving interval: {[round(v, 3) for v in iv]} "
        f"ms/frame (the last a flush), median of the others "
        f"{float(np.median(iv[:-1])):.3f} ({W}x{H}, batch {SERVE_FRAMES}, "
        f"{smi})")
    return c


def main_path_readback(dev, smi: str, kept: dict):
    """The serving loop with --no-hostapply at 4080x3072, batch
    SERVE_FRAMES: READBACK_ROUNDS HLG rounds (the pixels through
    fetch_1010102_packed: B15, B16 at 10 bits, two-phase then fused) and
    two F16 rounds (fetch_f16_packed: B15, B16 at 16 bits); then the
    last HLG batch through the fine-width arm (fetch_rgba1010102_batch:
    B17) and its 10-bit planar decode (B6r) through pack_plane_device
    (B21). One window: every launch counter and the plain versions' call
    counters zeroed just before and read just after. Every fetched batch
    is bitwise the device's."""
    from libultrahdr_dev_tpu_torch import serving
    from libultrahdr_dev_tpu_torch.parallel import batched, packio

    reset_counts()
    for fn in plain_calls().values():
        fn.calls = 0
    t0 = time.perf_counter()
    res = serving.run(SERVE_FRAMES, H, W, READBACK_ROUNDS, device=dev,
                      log=log, hostapply=False)
    stages_hlg, pick_hlg = dict(packio.LAST_FETCH_STAGES), packio.LAST_PICK
    res16 = serving.run(SERVE_FRAMES, H, W, 2, f16=True, device=dev, log=log,
                        hostapply=False)
    stages_f16, pick_f16 = dict(packio.LAST_FETCH_STAGES), packio.LAST_PICK
    fine, fine_bytes = packio.fetch_rgba1010102_batch(res.comp_dev)
    p10 = batched.batched_decode(res.blobs, "hdr_linear_rgb_10bit",
                                 serving.BOOST, device=dev)
    pk = packio.pack_plane_device(p10.reshape(-1, W))
    c = read_counts(f"readback window ({time.perf_counter() - t0:.1f} s)",
                    READBACK_KERNELS)
    calls = {k: fn.calls for k, fn in plain_calls().items()}
    log(f"readback window: plain-version calls {calls}; HLG: last pick "
        f"{pick_hlg}, LAST_FETCH_STAGES {stages_hlg}; F16: last pick "
        f"{pick_f16}, LAST_FETCH_STAGES {stages_f16}")
    require(not any(calls.values()), f"plain versions ran: {calls}")
    for label, rr, packed in (("HLG", res, "rct-rice-auto"),
                              ("F16", res16, "rct-rice16-auto")):
        raw = rr.pixels.nbytes
        for r, st in enumerate(rr.stats):
            log(f"readback round {r} ({label}): d2h_pack {st['d2h_pack']}, "
                f"d2h_bytes {st['d2h_bytes']} of {raw} raw "
                f"({raw / st['d2h_bytes']:.2f}x), stages "
                f"{st.get('d2h_stages')}")
            require(st["d2h_pack"].startswith(packed),
                    f"{label} round {r} read back {st['d2h_pack']}")
        require(np.array_equal(rr.pixels, rr.comp_dev.cpu().numpy().view(
            rr.pixels.dtype)), f"{label}: fetched pixels != the device's")
    require(fine is not None and np.array_equal(
        fine, res.comp_dev.cpu().numpy().view(np.uint32)),
        "fine-width readback != the device pixels")
    require(np.array_equal(packio.unpack_plane_host(pk), p10.reshape(
        -1, W).cpu().numpy().view(np.uint16)),
        "pack_plane_device readback != the device plane")
    log(f"readback window: fine-width arm {fine_bytes} B for "
        f"{res.pixels.nbytes} raw; 10-bit planar plane pack "
        f"{pk.nbytes()} B for {p10.numel() * 2} raw; all = device")
    kept["readback"] = (res.comp_dev, res16.comp_dev, p10)
    return c


def main_path_capi(dev, smi: str):
    """The C-style API (capi.py) and the batched apply in one window, every
    launch counter zeroed just before and read just after: one 4080x3072
    frame through uhdr_create_encoder / uhdr_encode and back through
    uhdr_create_decoder / uhdr_decode to F16, then batched_apply_gainmap
    (B6) over a decoded batch of FRAMES to HLG. Each is held bitwise
    against the direct calls: UhdrEncoder / UhdrDecoder, and
    ops.gainmap.apply_gainmap with the batch's scalars."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer,
                                           PixelFormat, RawImage, UhdrDecoder,
                                           UhdrEncoder, capi)
    from libultrahdr_dev_tpu_torch.api import HDR_IMG
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(FRAMES, H, W, SEED + 40)
    raw = RawImage(fmt=PixelFormat.P010, width=W, height=H,
                   gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                   planes={"y": y_np[0], "uv": uv_np[0]})
    planes, sc = _decoded_planes(dev, y_np, uv_np)
    ok = "UHDR_CODEC_OK"

    reset_counts()
    t0 = time.perf_counter()
    enc = capi.uhdr_create_encoder(dev)
    st = [capi.uhdr_enc_set_raw_image(enc, raw, HDR_IMG),
          capi.uhdr_encode(enc)]
    stream = capi.uhdr_get_encoded_stream(enc)
    dec = capi.uhdr_create_decoder(dev)
    st += [capi.uhdr_dec_set_image(dec, stream.data), capi.uhdr_decode(dec)]
    img = capi.uhdr_get_decoded_image(dec)
    out = batched.batched_apply_gainmap(
        *planes, batched.api0_metadata("hlg"), "hdr_hlg", 1000 / 203,
        device=dev)
    c = read_counts(f"C-style API window ({time.perf_counter() - t0:.2f} "
                    f"s)", ("B1", "B2", "B3", "B4", "B5", "B6"))
    require(all(x["error_code"] == ok for x in st),
            f"C-style calls failed: {st}")
    require(capi.is_uhdr_image(stream.data) == 1, "capi: not a JPEG/R")
    direct = UhdrEncoder(dev)
    direct.set_raw_image(raw, HDR_IMG)
    want = direct.encode().data
    require(stream.data == want, "capi stream != UhdrEncoder's")
    ddec = UhdrDecoder(dev)
    ddec.set_image(want)
    require(np.array_equal(img.planes["rgba"],
                           ddec.decode().planes["rgba"]),
            "capi decode != UhdrDecoder's")
    ref = gm.apply_gainmap(*planes, torch.from_numpy(sc).to(dev), "hdr_hlg")
    require(out.device.type == "cuda" and torch.equal(out, ref),
            "batched_apply_gainmap != apply_gainmap")
    log(f"C-style API window: {len(want)} bytes = UhdrEncoder's, decode = "
        f"UhdrDecoder's; batched_apply_gainmap over {FRAMES} frames = "
        f"apply_gainmap ({W}x{H}, {smi})")
    return c


#: The 8K frame of the HEIF window's grid case (JAX test_heifr.py).
HEIF_GRID = (8192, 4320)


def _plain_shims():
    """(module, name) of the plain versions the HEIF window's wrappers
    would call on a CPU tensor."""
    from libultrahdr_dev_tpu_torch.ops import editor, gainmap as gm

    return [(gm, "tonemap_p010_plain"), (gm, "generate_gainmap_plain"),
            (gm, "apply_gainmap_plain"), (gm, "yuv420_to_rgba8888_plain"),
            (editor, "_plain_planes")]


def counting(targets):
    """Replace each (module, name) by a shim counting its calls in the
    returned dict; -> (calls, restore)."""
    calls, saved, lock = {}, [], threading.Lock()
    for mod, name in targets:
        real = getattr(mod, name)

        def shim(*a, _real=real, _name=name, **kw):
            with lock:   # the progressive scans run on several threads
                calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        saved.append((mod, name, real))
        setattr(mod, name, shim)

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)

    return calls, restore


def main_path_heif(dev, smi: str):
    """The converter's HEIC / AVIF arms (heifr.py, ultrahdr.py) in one
    window, every launch counter zeroed just before and read just after,
    the plain versions of their kernels counted: a 4080x3072 API-0 frame
    to HEIC_R and AVIF_R (B10a, B10b), each decoded to HLG, SDR and F16
    (B6, B7); a 4000x3000 JPEG/R (decoded by B12: B4 + B5) converted to
    AVIF_R through the converter's chain (B13) and to 10-bit HEIC (B6 at
    HLG); and the 8192x4320 grid case to HEIC_R, decoded to SDR. With
    libheif the frames go through HeifR.encode_api0 and HeifR.decode,
    whose device stages and libheif's stages HeifR records apart
    (heifr.STAGES). Where libheif is absent, those entry points raise, so
    the coded-image layer is skipped (logged): HeifR's device stages run
    on the un-coded planes, timed synchronized under the same names, and
    the converter's calls must raise UNSUPPORTED_FEATURE after their
    device work. -> (launches, stage ms)."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrError, UltraHdr,
                                           UltraHdrConfig)
    from libultrahdr_dev_tpu_torch.container import isobmff as iso
    from libultrahdr_dev_tpu_torch.heifr import STAGES, HeifR, heif_available
    from libultrahdr_dev_tpu_torch.ultrahdr import sniff_format
    from libultrahdr_dev_tpu_torch.utils.profiler import StageTimes

    have = heif_available()
    if not have:
        log("HEIF window: libheif absent, its coded-image layer skipped: "
            "HeifR's entry points raise without it, so its device stages "
            "(_api0_planes, _reconstruct) run on un-coded planes, and the "
            "converter's HEIF outputs must raise UNSUPPORTED_FEATURE")

    def p010(n_w, n_h, y, uv):
        return RawImage(fmt=PixelFormat.P010, width=n_w, height=n_h,
                        gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                        planes={"y": y, "uv": uv})

    y_np, uv_np = synth_p010(1, H, W, SEED + 90)
    frame = p010(W, H, y_np[0], uv_np[0])
    gy, guv = synth_p010(1, GH, GW, SEED + 91)
    jr_blob = JpegR(dev).encode_api0(p010(GW, GH, gy[0], guv[0]),
                                     ColorTransfer.HLG, 95, exif=EXIF)
    kw, kh = HEIF_GRID
    ramp = np.linspace(64, 940, kw, dtype=np.float32).astype(np.uint16)
    grid = p010(kw, kh, np.broadcast_to(ramp, (kh, kw)).copy() << 6,
                np.full((kh // 2, kw), 512 << 6, np.uint16))
    stages: dict = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
        return out

    def spans(hr, what):
        """The stages hr recorded (heifr.STAGES), each a call, then a
        fresh StageTimes."""
        for name, tot in hr.times.totals.items():
            stages.setdefault(f"{what} {name}", []).append(tot * 1e3)
        hr.times = StageTimes()

    fmts = (OutputFormat.HDR_HLG, OutputFormat.SDR, OutputFormat.HDR_LINEAR)
    reset_counts()
    calls, restore = counting(_plain_shims())
    t0 = time.perf_counter()
    try:
        decoded = {}
        for codec in ("heic", "avif"):
            hr = HeifR(codec, dev, times=StageTimes())
            if have:
                blob = hr.encode_api0(frame, ColorTransfer.HLG, 95)
                spans(hr, f"{codec.upper()}_R encode_api0:")
                require(sniff_format(blob) == codec, f"{codec}: bad brand")
                for fmt in fmts:
                    decoded[codec, fmt] = hr.decode(
                        blob, fmt, 1000 / 203).image.planes["rgba"]
                    spans(hr, f"{codec.upper()}_R decode {fmt.name}:")
                continue
            # No libheif: HeifR's device stages on un-coded planes.
            y8, u8, v8, gmap, md = timed(
                f"{codec.upper()}_R {STAGES[0]}",
                lambda: hr._api0_planes(frame, ColorTransfer.HLG))
            for fmt in fmts:
                decoded[codec, fmt] = timed(
                    f"{codec.upper()}_R decode {fmt.name}: {STAGES[3]}",
                    lambda: hr._reconstruct(y8, u8, v8, gmap, md, fmt,
                                            1000 / 203).planes["rgba"])
        session = UltraHdr(dev).add_image(jr_blob)
        outs = {}
        for name, cfg in (
                ("avif_r", UltraHdrConfig("avif_r",
                                          effects=converter_chain())),
                ("heic_10bit", UltraHdrConfig(
                    "heic_10bit", transfer=ColorTransfer.HLG,
                    max_display_boost=4.9))):
            if have:
                outs[name] = timed(f"converter {name} (device + libheif)",
                                   lambda: session.convert(cfg))
                continue
            try:
                session.convert(cfg)
                require(False, f"converter {name} did not raise without "
                        f"libheif")
            except UhdrError as e:
                require(e.code == "UHDR_CODEC_UNSUPPORTED_FEATURE",
                        f"converter {name}: {e}")
        hr = HeifR("heic", dev, times=StageTimes())
        if have:
            gblob = hr.encode_api0(grid, ColorTransfer.HLG, 30)
            spans(hr, "8K HEIC_R encode_api0:")
            res = hr.decode(gblob, OutputFormat.SDR, 1000 / 203)
            spans(hr, "8K HEIC_R decode SDR:")
            grid_sdr, gmap8 = res.image.planes["rgba"], res.gainmap
        else:
            gplanes = timed(f"8K HEIC_R {STAGES[0]}",
                            lambda: hr._api0_planes(grid, ColorTransfer.HLG))
            gmap8 = gplanes[3]
            grid_sdr = timed(f"8K HEIC_R decode SDR: {STAGES[3]}",
                             lambda: hr._reconstruct(
                                 *gplanes, OutputFormat.SDR,
                                 1000 / 203).planes["rgba"])
    finally:
        restore()
    c = read_counts(f"HEIF window ({time.perf_counter() - t0:.2f} s, "
                    f"libheif {'present' if have else 'absent'})",
                    ("B10a", "B10b", "B6", "B7", "B13", "B4", "B5", "B12"))
    log(f"HEIF window: plain-version calls {calls}")
    require(not calls, f"plain versions ran in the HEIF window: {calls}")

    for codec in ("heic", "avif"):
        hlg = decoded[codec, OutputFormat.HDR_HLG]
        sdr = decoded[codec, OutputFormat.SDR]
        f16 = decoded[codec, OutputFormat.HDR_LINEAR].view(np.float16)
        require(hlg.shape == (H, W) and bool(((hlg >> 30) == 3).all()),
                f"{codec}: bad HLG decode")
        require(sdr.shape == (H, W) and bool(((sdr >> 24) == 255).all()),
                f"{codec}: bad SDR decode")
        require(f16.shape == (H, W, 4) and bool(np.isfinite(f16).all()),
                f"{codec}: bad F16 decode")
        med, n = _median_log2(f16, y_np[0], uv_np[0], "bt2100", "hlg",
                              "bt2100")
        src = "coded" if have else "un-coded planes"
        log(f"HEIF window {codec.upper()}_R: median |log2(decoded/input "
            f"luminance)| {med:.4f} over {n} pixels ({src})")
        require(med <= 0.1, f"{codec}: luminance round trip off")
    if have:
        cw, ch = CONV_SIZE
        res = HeifR("avif", dev).decode(outs["avif_r"], OutputFormat.HDR_HLG)
        require((res.width, res.height) == (cw, ch) and
                res.gainmap.shape == (ch // 4, cw // 4),
                "converter avif_r: bad geometry")
        require(sniff_format(outs["heic_10bit"]) == "heic",
                "converter heic_10bit: bad brand")
        hp = iso.parse_heif(gblob)
        require(any(it.item_type == "grid" for it in hp.items.values()),
                "8K HEIC_R: no grid item")
        require(gmap8.shape == (kh // 4, kw // 4), "8K: bad gain map")
    require(grid_sdr.shape == (kh, kw), "8K: bad SDR decode")
    log(f"HEIF window: API-0 {W}x{H} to HEIC_R and AVIF_R, decoded to HLG, "
        f"SDR, F16; converter {GW}x{GH} JPEG/R to AVIF_R (chain) and 10-bit "
        f"HEIC; {kw}x{kh} grid: all checks held ({smi})")
    return c, stages


# The off-path window: the committed progressive fixture, the arithmetic
# encode's restart interval (MCUs), its quality and the repeats of each
# of its stage lines.
OFFPATH_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures_torch",
                               "prog_4000x3000_420.jpg")
OFFPATH_RESTART, OFFPATH_Q, OFFPATH_REPS = 4, 90, 3
# Kernels of the device route's Huffman coding, none of which the
# off-path formats may reach.
HUFFMAN_DEVICE_KERNELS = ("B3", "B3g", "B3w", "B3gw", "B4", "B22", "B12",
                          "B12e", "B19", "B19g")


def grids_sha256(grids) -> str:
    """tests/fixtures_torch/prog_fixture.py's digest: each grid's int16
    little-endian bytes in C order, in frame order, through sha256."""
    import hashlib

    h = hashlib.sha256()
    for g in grids:
        h.update(np.ascontiguousarray(g, "<i2").tobytes())
    return h.hexdigest()


def build_multiscan(planes: dict, quality: int, dev) -> bytes:
    """A 3-scan (Y)(Cb)(Cr) non-interleaved baseline 4:2:0 JPEG of
    `planes` (tests/test_jpeg.py's _build_multiscan): the port's
    markers, B2 on each plane at its own size and the host Huffman coder
    (codec.entropy_encode), one call a scan."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import codec, dct, tables

    h, w = planes["y"].shape
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    out = bytearray(b"\xff\xd8")
    out += codec._jfif_app0()
    out += codec._marker(0xDB, codec._dqt(0, ql))
    out += codec._marker(0xDB, codec._dqt(1, qc))
    out += codec._marker(0xC0, codec._sof0(
        w, h, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]))
    luma = ((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
            (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS))
    chroma = ((tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
              (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
    for tid, (dc_t, ac_t) in enumerate((luma, chroma)):
        out += codec._marker(0xC4, codec._dht(0, tid, *dc_t))
        out += codec._marker(0xC4, codec._dht(1, tid, *ac_t))
    for key, q, cid, tid, (dc_t, ac_t) in (
            ("y", ql, 1, 0, luma), ("u", qc, 2, 1, chroma),
            ("v", qc, 3, 1, chroma)):
        zz = dct.fdct_quant(
            torch.from_numpy(np.ascontiguousarray(planes[key]))[None].to(dev),
            torch.from_numpy(q.reshape(64).astype(np.int32)).to(dev))
        zz = zz[0].cpu().numpy()
        out += codec._marker(0xDA, bytes([1, cid, (tid << 4) | tid, 0, 63,
                                          0]))
        dc_tabs, ac_tabs = [None] * 4, [None] * 4
        dc_tabs[tid], ac_tabs[tid] = dc_t, ac_t
        out += codec.entropy_encode(zz, np.zeros(zz.shape[0], np.uint8),
                                    [tid], [tid], dc_tabs, ac_tabs, 0, 1)
    return bytes(out + b"\xff\xd9")


def main_path_offpath(dev, smi: str):
    """The off-path JPEG formats (jpeg/codec.py: progressive, arithmetic
    and multi-scan baseline decode, arithmetic encode) through the entry
    points a user calls, at GW x GH 4:2:0, in one window with every
    launch counter and the host entropy calls zeroed just before and read
    just after: (a) encode_jpeg(arithmetic=True) of a seeded SDR frame
    without and with a restart interval (B2, then the QM coder on the
    host); (b) decode_jpeg of both (host QM decode, then B5); (c) a
    JPEG/R muxed by JpegR.encode_api4 from the arithmetic base and a
    gain map, decoded to HLG, F16 and SDR (B5, B6, B7); (d) the committed
    progressive fixture: its grids at 1 scan thread and at the default
    count, decode_jpeg, and a JPEG/R with it as primary decoded to HLG
    and SDR; (e) a multi-scan baseline file built from per-component
    scans (B2 a plane, host Huffman a scan) and decoded. The device
    route's Huffman kernels must not launch; the host calls each part
    needs are counted and must be exactly those. Checks: arithmetic
    bytes = the plain route's (device="cpu"), its grids = the Huffman
    file's, its planes and JPEG/R pixels = the Huffman file's, bitwise;
    the fixture's grids = its sidecar's digest (the JAX package's), its
    planes = plain B5 on the card (B5's tolerance), its SDR = B7 of its
    planes; the multi-scan planes = the single-scan file's.
    -> (launches, stage ms)."""
    import torch

    from libultrahdr_dev_tpu_torch import JpegR, OutputFormat
    from libultrahdr_dev_tpu_torch.jpeg import arith, codec, dct
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    def grids(res):
        return [c[0] for c in res.comps]

    def same_grids(a, b):
        return len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))

    # Inputs, made before the window: a seeded HDR frame's SDR rendition
    # (the planes), its gain map (B10b, coded by B19) and the Huffman-
    # coded references (B2, B19, decoded on the device route).
    y_np, uv_np = synth_p010(1, GH, GW, SEED + 95)
    sdr = sdr_rendition(y_np, uv_np, "bt709", dev)
    planes = dict(zip("yuv", (p[0] for p in sdr)))
    gmap_t, md = gm.generate_gainmap(
        *(torch.from_numpy(p).to(dev) for p in sdr),
        *(batched.p010_to_device(a, dev) for a in (y_np, uv_np)),
        sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg")
    gm_jpeg = codec.encode_jpeg({"y": gmap_t[0]}, 85, device=dev)
    rst = (0, OFFPATH_RESTART)
    huff = codec.encode_jpeg(planes, OFFPATH_Q, device=dev)
    huff_grids = grids(codec.decode_jpeg_coefs(huff))
    huff_planes = codec.decode_jpeg(huff, dev).planes
    jr = JpegR(dev)
    fmts = (OutputFormat.HDR_HLG, OutputFormat.HDR_LINEAR, OutputFormat.SDR)
    huff_jr = jr.encode_api4(huff, gm_jpeg, md)
    huff_out = {f: jr.decode(huff_jr, f).image.planes["rgba"] for f in fmts}
    fixture = open(OFFPATH_FIXTURE, "rb").read()
    side = json.load(open(OFFPATH_FIXTURE[:-4] + ".json"))
    n_scans = fixture.count(b"\xff\xda")
    scan_env = os.environ.get("UHDR_SCAN_THREADS")

    def scan_threads(n):
        if n is None:
            os.environ.pop("UHDR_SCAN_THREADS", None)
        else:
            os.environ["UHDR_SCAN_THREADS"] = str(n)

    reset_counts()
    calls, restore = counting([(arith, "encode_seq_scan"),
                               (arith, "decode_seq_scan"),
                               (codec, "_run_scan")])
    t0 = time.perf_counter()
    try:
        # (a) arithmetic encode, (b) its decode
        arith_jpg = {r: codec.encode_jpeg(planes, OFFPATH_Q,
                                          restart_interval=r,
                                          arithmetic=True, device=dev)
                     for r in rst}
        arith_grids = {r: grids(codec.decode_jpeg_coefs(b))
                       for r, b in arith_jpg.items()}
        arith_planes = {r: codec.decode_jpeg(b, dev).planes
                        for r, b in arith_jpg.items()}
        # (c) a JPEG/R with the arithmetic primary
        arith_jr = jr.encode_api4(arith_jpg[0], gm_jpeg, md)
        arith_out = {f: jr.decode(arith_jr, f).image.planes["rgba"]
                     for f in fmts}
        # (d) the progressive fixture
        digests = {}
        for n in (1, None):
            scan_threads(n)
            fx_coefs = codec.decode_jpeg_coefs(fixture)
            digests[n] = grids_sha256(grids(fx_coefs))
        scan_threads(scan_env)
        fx = codec.decode_jpeg(fixture, dev)
        fx_jr = jr.encode_api4(fixture, gm_jpeg, md)
        fx_out = {f: jr.decode(fx_jr, f).image.planes["rgba"]
                  for f in (OutputFormat.HDR_HLG, OutputFormat.SDR)}
        # (e) multi-scan baseline
        multi = build_multiscan(planes, OFFPATH_Q, dev)
        multi_planes = codec.decode_jpeg(multi, dev).planes
    finally:
        restore()
        scan_threads(scan_env)
    t_win = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    host = {"entropy_encode": codec.entropy_encode.calls,
            "entropy_decode": codec.entropy_decode.calls,
            "encode_seq_scan": calls.get("encode_seq_scan", 0),
            "decode_seq_scan": calls.get("decode_seq_scan", 0),
            "progressive scans": calls.get("_run_scan", 0)}
    # Host calls by design: 2 arithmetic encodes; 7 arithmetic decodes
    # (2 grids, 2 planes, 3 JPEG/R outputs); the fixture's scans 5 times
    # (2 grids, its planes, 2 JPEG/R outputs); Huffman decodes of the
    # gain map in 3 HDR outputs whose primary took the host route and of
    # the 3 multi-scan scans; 3 Huffman encodes (the multi-scan scans).
    want = {"entropy_encode": 3, "entropy_decode": 6, "encode_seq_scan": 2,
            "decode_seq_scan": 7, "progressive scans": 5 * n_scans}
    log(f"off-path window ({t_win:.2f} s): kernel launches {launches}, "
        f"host entropy calls {host} (expected {want}; {n_scans} scans in "
        f"the progressive fixture)")
    require(all(launches[k] > 0 for k in ("B2", "B5", "B6", "B7")),
            f"off-path window: a kernel of the path never launched: "
            f"{launches}")
    require(all(launches[k] == 0 for k in HUFFMAN_DEVICE_KERNELS),
            f"off-path window: the device route's Huffman kernels ran: "
            f"{launches}")
    require(host == want, f"off-path window: host entropy calls {host}, "
            f"expected {want}")

    # (a)
    for r in rst:
        require(arith_jpg[r][:400].find(b"\xff\xc9") > 0 and
                (b"\xff\xdd" in arith_jpg[r]) == bool(r),
                f"arithmetic encode r={r}: no SOF9 / DRI")
        plain = codec.encode_jpeg(planes, OFFPATH_Q, restart_interval=r,
                                  arithmetic=True, device="cpu")
        require(plain == arith_jpg[r],
                f"arithmetic encode r={r}: bytes differ from the plain "
                f"route's")
        require(same_grids(arith_grids[r], huff_grids),
                f"arithmetic encode r={r}: grids differ from the Huffman "
                f"file's")
        # (b)
        require(all(map(torch.equal, arith_planes[r], huff_planes)),
                f"arithmetic decode r={r}: planes differ from the Huffman "
                f"file's")
    # (c)
    for f in fmts:
        require(np.array_equal(arith_out[f], huff_out[f]),
                f"JPEG/R with arithmetic primary: {f.name} differs from the "
                f"Huffman-based JPEG/R's")
    # (d)
    require(digests[1] == digests[None] == side["sha256"],
            f"progressive fixture: grids digest {digests}, sidecar "
            f"{side['sha256']}")
    up = [torch.from_numpy(g.reshape(1, -1, 64)).to(dev)
          for g in grids(fx_coefs)]
    worst = n_off = n_all = 0
    for k, (g, q, ch, cw, _) in enumerate(fx_coefs.comps):
        qt = torch.from_numpy(q.reshape(1, 64).astype(np.int32)).to(dev)
        want_p = dct.dequant_idct_plain(up[k], qt, g.shape[0], g.shape[1])
        w_, o_ = int_diff(fx.planes[k], want_p[0, :ch, :cw])
        worst, n_off, n_all = max(worst, w_), n_off + o_, n_all + ch * cw
    log(f"progressive fixture: B5 against plain B5 on the card: max |diff| "
        f"{worst} on {n_off} of {n_all} pixels")
    require(worst <= 1 and n_off <= 1e-4 * n_all,
            "progressive fixture: B5 planes disagree with the plain version")
    hlg = fx_out[OutputFormat.HDR_HLG]
    require(hlg.shape == (GH, GW) and bool(((hlg >> 30) == 3).all()),
            "progressive fixture JPEG/R: bad HLG decode")
    b7 = gm.yuv420_to_rgba8888(*(p[None] for p in fx.planes))[0]
    require(np.array_equal(fx_out[OutputFormat.SDR],
                           b7.cpu().numpy().view(np.uint32)),
            "progressive fixture JPEG/R: SDR differs from B7 of its planes")
    # (e)
    require(multi.count(b"\xff\xda") == 3 and
            all(map(torch.equal, multi_planes, huff_planes)),
            "multi-scan baseline: planes differ from the single-scan file's")
    log(f"off-path window: arithmetic encode r 0 and {OFFPATH_RESTART} "
        f"({[len(b) for b in arith_jpg.values()]} bytes; Huffman "
        f"{len(huff)}), its decode, the JPEG/R with it as primary, the "
        f"progressive fixture ({len(fixture)} bytes, {n_scans} scans) and "
        f"the multi-scan file at {GW}x{GH}: all checks held ({smi})")

    # Stage lines, after the window (timing launches count nowhere).
    stages: dict = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        out = None
        for _ in range(OFFPATH_REPS):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages.setdefault(label, []).append(
                (time.perf_counter() - t) * 1e3)
        return out

    try:
        scan_threads(1)
        timed("host entropy decode progressive fixture, 1 scan thread",
              lambda: codec.decode_jpeg_coefs(fixture))
        scan_threads(None)
        timed(f"host entropy decode progressive fixture, "
              f"{codec._scan_threads()} scan threads (default)",
              lambda: codec.decode_jpeg_coefs(fixture))
    finally:
        scan_threads(scan_env)
    timed("host entropy decode arithmetic (SOF9)",
          lambda: codec.decode_jpeg_coefs(arith_jpg[0]))
    timed("host entropy decode multi-scan baseline (3 scans)",
          lambda: codec.decode_jpeg_coefs(multi))
    timed("upload + B5, progressive fixture",
          lambda: codec.coefs_to_planes(fx_coefs, dev))
    c = timed("arithmetic encode: padding + B2 (jpeg_coefs)",
              lambda: codec.jpeg_coefs(planes, OFFPATH_Q, device=dev))
    host_blocks = timed("arithmetic encode: D2H (coefs_to_host)",
                        lambda: codec.coefs_to_host(c))
    mcu = timed("arithmetic encode: MCU interleave (host)",
                lambda: codec.interleave_coefs(c, host_blocks))
    timed("arithmetic encode: QM coding (host)",
          lambda: codec.arith_scan(mcu[0], mcu[1], False, 0, mcu[2]))
    for name, blob in (("arithmetic", arith_jr), ("progressive", fx_jr)):
        frame = timed(f"JPEG/R ({name} primary) decode HLG: host stage",
                      lambda: batched.decode_host_stage([blob], "hdr_hlg"))
        timed(f"JPEG/R ({name} primary) decode HLG: device stage (upload, "
              f"B5, B6)",
              lambda: batched.decode_device_stage(frame, "hdr_hlg",
                                                  float("inf"), dev))
    return launches, stages


MESH_ROUNDS = 2     # serving-loop rounds of each mesh arm
MESH_KERNELS = ("B1", "B2", "B3", "B3g", "B3w", "B3gw", "B4", "B5", "B6",
                "B7", "B14", "B15", "B16", "B18", "B19", "B19g")


def _sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _mesh_calls(dev, mesh, inputs, label: str, smi: str):
    """One arm of the mesh window: every batched entry point the window
    covers, on `mesh` (None: the one-device calls on `dev`), run once
    untimed, so that the readbacks' plan cache holds this arm's shard
    shapes, then again in one count window -> (outputs, launches,
    readback events, fetch modes). Each counted call is timed, device
    work included, and logged as a stage line of the arm. The readback
    events are the fused fetch's re-plans (B15 and B16 once more each)
    and the Rice pack's declines (no B16) of the counted run; the fetch
    modes are, per shard, the modes of its planes readbacks there."""
    from libultrahdr_dev_tpu_torch import serving
    from libultrahdr_dev_tpu_torch.parallel import batched, link
    from libultrahdr_dev_tpu_torch.utils import counters as events

    y, uv, dy, duv, planes, md = inputs
    boost = serving.BOOST
    kw = {"device": dev} if mesh is None else {"mesh": mesh}
    out, ms, fetch_stats = {}, {}, []

    def timed(name, fn):
        _sync_all()
        t0 = time.perf_counter()
        out[name] = fn()
        _sync_all()
        ms[name] = (time.perf_counter() - t0) * 1e3

    def calls():
        fetch_stats.clear()
        timed("API-0 encode + handoff", lambda: batched.batched_encode_api0(
            y, uv, return_handoff=True, **kw))
        blobs, hand = out["API-0 encode + handoff"]
        for fmt in ("hdr_hlg", "hdr_linear", "sdr"):
            timed(f"decode {fmt}", lambda: batched.batched_decode(
                blobs, fmt, boost, **kw))
        timed("handoff decode hdr_hlg",
              lambda: batched.batched_decode_from_handoff(
                  hand, "hdr_hlg", boost, mesh=mesh))
        timed("batched apply hdr_hlg", lambda: batched.batched_apply_gainmap(
            *planes, md, "hdr_hlg", boost, **kw))
        fetch_stats.append({})
        timed("host-apply decode hdr_hlg",
              lambda: link.decode_batch_hostapply(
                  blobs, "hdr_hlg", boost, fetch_stats[0], **kw))
        timed(f"serving loop ({MESH_ROUNDS} rounds)", lambda: serving.run(
            len(y), H, W, MESH_ROUNDS, log=lambda m: None, **kw))
        fetch_stats.extend(out[f"serving loop ({MESH_ROUNDS} rounds)"].stats)
        timed("dense API-0 encode (q100)",
              lambda: batched.batched_encode_api0(
                  dy, duv, quality=100, return_handoff=True, **kw))
        timed("dense decode hdr_hlg", lambda: batched.batched_decode(
            out["dense API-0 encode (q100)"][0], "hdr_hlg", boost, **kw))

    calls()
    _sync_all()
    reset_counts()
    ev0 = events.snapshot()
    t0 = time.perf_counter()
    calls()
    _sync_all()
    c = read_counts(f"mesh {label} ({time.perf_counter() - t0:.1f} s)",
                    MESH_KERNELS)
    ev1 = events.snapshot()
    ev = {k: ev1.get(k, 0) - ev0.get(k, 0)
          for k in ("fused_fetch_replan", "rice_readback_declined")}
    modes = []
    for st in fetch_stats:
        shards = st["fetch_stages"]
        shards = shards if isinstance(shards, list) else [shards]
        modes = modes or [[] for _ in shards]
        for m, sh in zip(modes, shards):
            m.append(sh.get("mode", "two_phase"))
    log(f"mesh {label}: readback events {ev}, planes fetch modes per shard "
        f"{modes}")
    for name, v in ms.items():
        log(f"stage mesh {label} {name}: {v:.3f} ms ({len(y)} frames of "
            f"{W}x{H}; {smi})")
    return out, c, ev, modes


def _fetches_out(launches: dict, ev: dict) -> dict:
    """Launch counts with the readbacks' re-plans and declines taken out
    of B15 and B16: what one pack a fetch launches."""
    out = dict(launches)
    out["B15"] -= ev["fused_fetch_replan"]
    out["B16"] += ev["rice_readback_declined"] - ev["fused_fetch_replan"]
    return out


def _host(x):
    """An output of the window on the host, for a bitwise comparison."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel.mesh import ShardedBatch

    if isinstance(x, (ShardedBatch, torch.Tensor)):
        return x.cpu().numpy()
    return x


def _mesh_placed(out, mesh, label: str):
    """Every sharded output of an arm lies shard for shard on the mesh's
    devices, and each shard holds its span of the batch."""
    from libultrahdr_dev_tpu_torch.parallel.mesh import ShardedBatch

    n = out["decode hdr_hlg"].shape[0]
    for name in ("decode hdr_hlg", "decode hdr_linear", "decode sdr",
                 "handoff decode hdr_hlg", "batched apply hdr_hlg",
                 "dense decode hdr_hlg"):
        b = out[name]
        require(isinstance(b, ShardedBatch) and b.devices == mesh.devices
                and all(s.shape[0] == n // len(mesh) for s in b.shards),
                f"mesh {label}: {name} is not laid over {mesh}")
    hand = out["API-0 encode + handoff"][1]
    require(len(hand) == len(mesh) and all(
        h.streams.base.device == d == h.streams.gm.device
        for h, d in zip(hand, mesh.devices)),
        f"mesh {label}: a handoff shard is off its device")


def main_path_mesh(dev, smi: str):
    """The mesh window (parallel/mesh.py and the mesh= arm of the batched
    entry points) at the serving loop's defaults, 4080x3072, batch
    SERVE_FRAMES: the API-0 encode with its handoff, batched_decode to
    HLG, F16 and SDR, the handoff decode, batched_apply_gainmap, the
    host-apply decode, MESH_ROUNDS serving-loop rounds, and a q100 batch
    whose frame 1 holds a DENSE_PATCH noise square (encoded and
    decoded), first as the one-device calls and then on each arm: (a)
    default_mesh(), (b) two shards on cuda:0, (c) cuda:0 and cuda:1 when
    there are two GPUs (else one line says it did not run). Each arm's
    blobs are the one-device blobs byte for byte and its pixels bitwise
    the one-device pixels; the dense batch is restart-less in every shard
    with no handoff; in (c) every sharded output lies on its shard's
    device. The readbacks run as a serving loop runs them, fused on a
    cached plan: every shard must take the fused fetch at least once in
    the counted run. Each kernel launches once per shard where the
    one-device calls launch it once, the readbacks' re-plans and
    declines of each run taken out of B15 and B16 first (a re-plan
    launches both once more, a decline launches no B16; which fetch
    re-plans hangs on the plan cache's history, not on the mesh). ->
    launches summed over the reference and the arms."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import batched
    from libultrahdr_dev_tpu_torch.parallel.mesh import (DeviceMesh,
                                                         default_mesh)
    from libultrahdr_dev_tpu_torch.types import GainMapMetadata

    n = SERVE_FRAMES
    y, uv = synth_p010(n, H, W, SEED + 500)
    dy, duv = synth_p010(n, H, W, SEED + 501)
    p = DENSE_PATCH
    r0, c0 = H // 32 * 16, W // 32 * 16
    ny, nuv = dense_p010(1, p, p, SEED + 502)
    dy[1, r0:r0 + p, c0:c0 + p] = ny[0]
    duv[1, r0 // 2:(r0 + p) // 2, c0:c0 + p] = nuv[0]
    rng = np.random.default_rng(SEED + 503)
    planes = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                   for s in ((n, H, W), (n, H // 2, W // 2),
                             (n, H // 2, W // 2), (n, H // 4, W // 4)))
    boost = 1000 / 203
    md = GainMapMetadata(max_content_boost=boost, min_content_boost=1.0,
                         hdr_capacity_min=1.0, hdr_capacity_max=boost)
    inputs = (y, uv, dy, duv, planes, md)

    ref, ref_c, ref_ev, _ = _mesh_calls(dev, None, inputs, "one device",
                                        smi)
    require(ref["dense API-0 encode (q100)"][1] is None,
            "mesh window: the dense batch gave a handoff")
    arms = [("(a) default_mesh", default_mesh()),
            ("(b) two shards on cuda:0", DeviceMesh([dev, dev]))]
    count = torch.cuda.device_count()
    if count >= 2:
        arms.append(("(c) cuda:0 + cuda:1",
                     DeviceMesh([torch.device("cuda", 0),
                                 torch.device("cuda", 1)])))
    else:
        log(f"mesh arm (c) cuda:0 + cuda:1: not run: "
            f"torch.cuda.device_count() is {count}, it needs 2")
    total = dict(ref_c)
    for label, mesh in arms:
        s = len(mesh)
        log(f"mesh devices={len(set(mesh.devices))} shards={s} {label}: "
            f"{[str(d) for d in mesh.devices]}")
        out, c, ev, modes = _mesh_calls(dev, mesh, inputs, label, smi)
        for k in total:
            total[k] += c[k]
        require(len(modes) == s and all("fused" in m for m in modes),
                f"mesh {label}: a shard never took the fused readback: "
                f"{modes}")
        for name, want in ref.items():
            got = out[name]
            if name.startswith("API-0") or name.startswith("dense API-0"):
                require(got[0] == want[0],
                        f"mesh {label}: {name} blobs differ from the "
                        f"one-device blobs")
            elif name.startswith("serving"):
                require(got.blobs == want.blobs and np.array_equal(
                    got.pixels, want.pixels) and np.array_equal(
                        got.comp, want.comp),
                    f"mesh {label}: the serving loop differs from the "
                    f"one-device loop")
            else:
                require(np.array_equal(_host(got), _host(want)),
                        f"mesh {label}: {name} pixels differ from the "
                        f"one-device pixels")
        dense, dhand = out["dense API-0 encode (q100)"]
        require(dhand is None and not any(
            bytes([0xFF, 0xD0 + k]) in b for b in dense for k in range(8)),
            f"mesh {label}: the dense batch is not restart-less in every "
            f"shard")
        want_c = {k: s * v for k, v in _fetches_out(ref_c, ref_ev).items()}
        require(_fetches_out(c, ev) == want_c,
                f"mesh {label}: launches {c} (readback events {ev}) are not "
                f"{s} x the one-device launches {ref_c} (readback events "
                f"{ref_ev})")
        _mesh_placed(out, mesh, label)
        log(f"mesh {label}: blobs byte-identical, pixels bitwise equal to "
            f"the one-device calls; dense batch restart-less in all {s} "
            f"shards; launches {s} x the one-device launches")
    return total


def launch_guard_cost(dev, smi: str, reps: int = 4000):
    """Host time of kernels/build.py:launch's device guard with the
    device already current: its current-device check alone, the
    `torch.cuda.device` enter and exit it takes for a tensor off the
    current device, then a tiny kernel (pow_probe over 32 floats)
    launched through build.launch and through its bare ctypes entry
    point on the same stream, in turns (bare, guarded, guarded, bare),
    each timed on the host from the first call to the last of `reps`
    (the queue drained before each run)."""
    import torch

    from libultrahdr_dev_tpu_torch.kernels import build
    from libultrahdr_dev_tpu_torch.ops import color

    x = torch.rand(32, device=dev)
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), 32, color._f32(0.5), 1)
    lib = build.get_lib()

    def check():
        return x.device.index == torch.cuda.current_device()

    def guard():
        with torch.cuda.device(x.device):
            pass

    def guarded():
        build.launch(x, "uhdr_pow_probe", *args)

    def bare():
        build.check(lib.uhdr_pow_probe(*args, build.stream_of(x)),
                    "uhdr_pow_probe")

    def us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / reps * 1e6

    for fn in (check, guard, guarded, bare):
        us(fn)
    c = min(us(check) for _ in range(2))
    g = min(us(guard) for _ in range(2))
    b1, l1, l2, b2 = us(bare), us(guarded), us(guarded), us(bare)
    log(f"launch guard: current-device check {c:.3f} us, torch.cuda.device "
        f"enter + exit {g:.3f} us; pow_probe launch guarded {l1:.3f}, "
        f"{l2:.3f} us, bare {b1:.3f}, {b2:.3f} us ({reps} calls a run, "
        f"device current; {smi})")


def main_path_cli(dev, smi: str):
    """The command-line tool (python -m libultrahdr_dev_tpu_torch.cli) on
    one GW x GH P010 frame: encode (API-0 on the general route), then
    decode to HLG RGBA1010102 (-o 1 -O 5) and to linear F16 (-o 0 -O 4),
    whose pixels cross through fetch_pixels_packed, in one window with
    the counters zeroed before and read after. Each written file equals
    the bytes of the same decode read back without packing (UhdrDecoder's
    host pixels)."""
    import shutil
    import tempfile

    from libultrahdr_dev_tpu_torch import cli
    from libultrahdr_dev_tpu_torch.api import UhdrDecoder
    from libultrahdr_dev_tpu_torch.types import ColorTransfer, PixelFormat

    d = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        y, uv = synth_p010(1, GH, GW, SEED + 400)
        src, enc = os.path.join(d, "in.p010"), os.path.join(d, "out.jpg")
        np.concatenate([y[0].ravel(), uv[0].ravel()]).tofile(src)
        decodes = {"hlg": ("1", "5", PixelFormat.RGBA1010102,
                           ColorTransfer.HLG),
                   "f16": ("0", "4", PixelFormat.RGBA_F16,
                           ColorTransfer.LINEAR)}
        reset_counts()
        for fn in plain_calls().values():
            fn.calls = 0
        t0 = time.perf_counter()
        require(cli.main(["-m", "0", "-p", src, "-w", str(GW), "-h", str(GH),
                          "-C", "2", "-t", "1", "-q", "95", "-z", enc]) == 0,
                "cli encode failed")
        for name, (o, fmt, *_) in decodes.items():
            require(cli.main(["-m", "1", "-j", enc, "-o", o, "-O", fmt, "-z",
                              os.path.join(d, f"{name}.raw")]) == 0,
                    f"cli decode {name} failed")
        c = read_counts(f"CLI window ({time.perf_counter() - t0:.1f} s)",
                        CLI_KERNELS)
        calls = {k: fn.calls for k, fn in plain_calls().items()}
        require(not any(calls.values()), f"plain versions ran: {calls}")
        with open(enc, "rb") as f:
            data = f.read()
        for name, (_, _, fmt, ct) in decodes.items():
            dec = UhdrDecoder(dev)
            dec.set_image(data)
            dec.set_out_img_format(fmt)
            dec.set_out_color_transfer(ct)
            want = np.ascontiguousarray(dec.decode().planes["rgba"])
            with open(os.path.join(d, f"{name}.raw"), "rb") as f:
                got = f.read()
            require(got == want.tobytes(), f"cli {name} file != the "
                    f"unpacked decode's bytes")
            log(f"CLI decode {name}: {len(got)} B file = the decode read "
                f"back raw")
        return c
    finally:
        shutil.rmtree(d)


def stage_times_readback(dev, smi: str, kept: dict):
    """Warm per-frame times of the packed pixel readbacks beside the
    plain copies of the same device pixels, in turns (plain, packed,
    packed, plain), each ending with the pixels on the host: the HLG
    and F16 packs (fused once warm), the fine-width arm, the 10-bit
    plane pack; .cpu() (pageable) and a copy into pinned memory."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import link, packio

    hlg, f16, p10 = kept["readback"]
    plane = p10.reshape(-1, W)
    n = SERVE_FRAMES

    def pinned(t):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return lambda: (buf.copy_(t), torch.cuda.synchronize())

    for label, x, packed in (
            ("HLG RGBA1010102", hlg, lambda: link.fetch_1010102_packed(hlg)),
            ("F16", f16, lambda: link.fetch_f16_packed(f16)),
            ("HLG fine-width", hlg,
             lambda: packio.fetch_rgba1010102_batch(hlg)),
            ("10-bit planar plane", plane, lambda: packio.unpack_plane_host(
                packio.pack_plane_device(plane)))):
        copy = lambda: x.cpu()  # noqa: E731
        a = host_ms(copy, 3)
        b = host_ms(packed, 3)
        b2 = host_ms(packed, 3)
        a2 = host_ms(copy, 3)
        pin = host_ms(pinned(x), 3)
        log(f"stage readback {label}: packed {b / n:.3f} / {b2 / n:.3f} "
            f"ms/frame, .cpu() {a / n:.3f} / {a2 / n:.3f} ms/frame, pinned "
            f"copy {pin / n:.3f} ms/frame, {nbytes(x) / n / 1e6:.1f} MB/frame "
            f"raw ({W}x{H}, batch {n}, {smi})")
    planar_readback_parts(plane, n, smi)


def planar_readback_parts(plane, n: int, smi: str, reps: int = 3):
    """The 10-bit planar plane's readback, pack_plane_device then
    unpack_plane_host, with a StageTimes each run: their parts
    (packio.PLANE_PACK_STAGES), the median over `reps` warm runs, ms a
    frame of the batch of n, one log line a part. The unpacked plane
    must equal the device's."""
    from libultrahdr_dev_tpu_torch.parallel import packio
    from libultrahdr_dev_tpu_torch.utils.profiler import StageTimes

    times = {k: [] for k in packio.PLANE_PACK_STAGES}
    for rep in range(reps + 1):
        st = StageTimes()
        out = packio.unpack_plane_host(
            packio.pack_plane_device(plane, times=st), times=st)
        require(sorted(st.totals) == sorted(times),
                f"planar readback recorded {sorted(st.totals)}")
        if rep:
            for k in times:
                times[k].append(st.totals[k] * 1e3)
    require(np.array_equal(out, plane.cpu().numpy().view(np.uint16)),
            "planar readback by part != the device plane")
    total = 0.0
    for k in packio.PLANE_PACK_STAGES:
        ms = float(np.median(times[k])) / n
        total += ms
        log(f"stage readback 10-bit planar plane part {k}: {ms:.3f} "
            f"ms/frame (median of {reps}; {W}x{H}, batch {n}, {smi})")
    log(f"stage readback 10-bit planar plane parts together: {total:.3f} "
        f"ms/frame")


def stage_times_serving(dev, smi: str, kept: dict):
    """Warm per-frame times of the serving loop's packed stages beside
    the plain copies they replace (batch SERVE_FRAMES, 4080x3072), each
    ending synchronized: the packed upload (host pack, H2D, B14) and
    p010_to_device; the planes readback (B15, B16, D2H, native unpack;
    the fused path once warm) and .cpu() of the composite; the host
    apply and the device's B6 followed by .cpu()."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched, link

    n = SERVE_FRAMES
    y_np, uv_np = kept["upload"]
    comp, planes, sc = kept["comp"], kept["planes"], kept["scalars"]
    sc_dev = torch.from_numpy(sc).to(dev)

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    pre = link.pack_p010_batch_host(y_np, uv_np)
    comp_host = link.fetch_planes(comp)
    stages = {
        "packed upload (host pack + H2D + B14)": synced(
            lambda: link.upload_p010_batch(y_np, uv_np, device=dev)),
        "  host pack alone": lambda: link.pack_p010_batch_host(y_np, uv_np),
        "  H2D + B14 of the packed blob": synced(
            lambda: link.upload_p010_batch(y_np, uv_np, None, pre, dev)),
        "plain copy (p010_to_device of y and uv)": synced(
            lambda: (batched.p010_to_device(y_np, dev),
                     batched.p010_to_device(uv_np, dev))),
        "planes readback (B15 + B16 + D2H + host unpack)":
            lambda: link.fetch_planes(comp),
        "plain copy (.cpu() of the composite)": lambda: comp.cpu(),
        "host apply (HLG)": lambda: link.apply_planes_host(
            comp_host, sc, H, W, H // 4, W // 4, "hdr_hlg"),
        "device B6 (HLG) + .cpu()": lambda: gm.apply_gainmap(
            *planes, sc_dev, "hdr_hlg").cpu(),
    }
    for k, fn in stages.items():
        log(f"stage {k}: {host_ms(fn, 3) / n:.3f} ms/frame ({W}x{H}, batch "
            f"{n}, {smi})")


API0_KERNELS = ("B1", "B2", "B3", "B3g", "B4", "B5", "B6")
# The serving loop's kernels (B0 for the noise round's dense upload).
SERVE_KERNELS = ("B14", "B0", "B1", "B2", "B3", "B3g", "B4", "B5", "B18",
                 "B15", "B16")
SERVE_FRAMES, SERVE_ROUNDS = 4, 4
# The readback window: its kernels and its HLG rounds.
READBACK_KERNELS = ("B14", "B1", "B2", "B3", "B4", "B5", "B6", "B6r",
                    "B15/10", "B15/16", "B16/10", "B16/16", "B17a", "B17b",
                    "B21a", "B21b")
READBACK_ROUNDS = 3
# The CLI window's (an encode on the general route, two decodes).
CLI_KERNELS = ("B10a", "B10b", "B10c", "B2", "B19", "B4", "B5", "B6",
               "B15/10", "B15/16", "B16/10", "B16/16")
RICE_L = 256
# Kernels checked and timed at the general routes' 4000x3000 frame.
GENERAL_KERNELS = ("B10a", "B10b", "B10c", "B12", "B12e", "B13", "B19")


def counters():
    """Each kernel's launch counter: name -> (wrapper, attribute). B3
    counts its YCbCr and gray wrappers apart (B3, B3g), and their write
    passes (B3w, B3gw); B12e counts encode_jpeg's restart-interval
    codings (each one B3 launch, counted in B3 or B3g as well); B19
    counts its YCbCr and gray wrappers apart (B19, B19g); B11 is the
    table arm of B6's wrapper, B6r its 10-bit planar arm (counted in B6
    or B11 as well); B12 counts decode_jpeg's device-route calls (each
    one B4 (or B22) and B5 launches); B13 counts apply_effects' launches
    (one per image: all its planes in one launch);
    B22 is the log-emission arm of B4's wrapper."""
    from libultrahdr_dev_tpu_torch.jpeg import codec, dct
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de
    from libultrahdr_dev_tpu_torch.ops import editor, gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import packio

    return {"B1": (gm.encode_front, "launches"),
            "B2": (dct.fdct_quant, "launches"),
            "B3": (de.encode_ycbcr_rst_stream, "launches"),
            "B3g": (de.encode_gray_rst_stream, "launches"),
            "B3w": (de.encode_ycbcr_rst_stream, "write_launches"),
            "B3gw": (de.encode_gray_rst_stream, "write_launches"),
            "B4": (dd.decode_rst_chunks, "launches"),
            "B22": (dd.decode_rst_chunks, "log_launches"),
            "B5": (dct.dequant_idct, "launches"),
            "B6": (gm.apply_gainmap, "launches"),
            "B6r": (gm.apply_gainmap, "rgb10_launches"),
            "B7": (gm.yuv420_to_rgba8888, "launches"),
            "B9": (gm.encode_front_api1, "launches"),
            "B10a": (gm.tonemap_p010, "launches"),
            "B10b": (gm.generate_gainmap, "launches"),
            "B10c": (gm.convert_yuv_encoding, "launches"),
            "B11": (gm.apply_gainmap, "lut_launches"),
            "B12": (dd.decode_stream_device, "launches"),
            "B12e": (codec.entropy_stage, "rst_launches"),
            "B13": (editor.apply_effects, "launches"),
            "B19": (de.encode_ycbcr_stream, "launches"),
            "B19g": (de.encode_gray_stream, "launches"),
            "B0": (packio.unpack_p010_dense, "launches"),
            "B14": (packio.unpack_plane_device, "launches"),
            "B15": (packio.rice_stats, "launches"),
            "B16": (packio.rice_pack, "launches"),
            "B15/10": (packio.rice_stats, "launches10"),
            "B15/16": (packio.rice_stats, "launches16"),
            "B16/10": (packio.rice_pack, "launches10"),
            "B16/16": (packio.rice_pack, "launches16"),
            "B17a": (packio.rct_widths, "launches"),
            "B17b": (packio.rct_pack, "launches"),
            "B18": (gm.planes_composite, "launches"),
            "B21a": (packio.plane_widths, "launches"),
            "B21b": (packio.plane_pack, "launches")}


PACKIO_CU = "libultrahdr_dev_tpu_torch/kernels/csrc/packio.cu"
KERNELS = {
    "B1": ("encode_front", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "encode_front.cu", "libultrahdr_dev_tpu/parallel/sharding.py:570"),
    "B2": ("fdct_quant", "libultrahdr_dev_tpu_torch/kernels/csrc/dct.cu",
           "libultrahdr_dev_tpu/jpeg/dct.py:76"),
    "B3": ("huff_encode_rst", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "huff_encode.cu", "libultrahdr_dev_tpu/jpeg/device_entropy.py:498"),
    "B4": ("huff_decode_rst", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "huff_decode.cu", "libultrahdr_dev_tpu/jpeg/device_decode.py:403"),
    "B5": ("dequant_idct", "libultrahdr_dev_tpu_torch/kernels/csrc/dct.cu",
           "libultrahdr_dev_tpu/jpeg/dct.py:122"),
    "B6": ("apply_gainmap", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "apply.cu", "libultrahdr_dev_tpu/ops/gainmap.py:296"),
    "B6r": ("apply_gainmap_rgb10", "libultrahdr_dev_tpu_torch/kernels/csrc/"
            "apply.cu", "libultrahdr_dev_tpu/ops/gainmap.py:318"),
    "B7": ("yuv420_to_rgba8888", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "sdr_out.cu", "libultrahdr_dev_tpu/ops/gainmap.py:407"),
    "B9": ("encode_front_api1", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "encode_front.cu", "libultrahdr_dev_tpu/parallel/sharding.py:622"),
    "B10a": ("tonemap_p010", "libultrahdr_dev_tpu_torch/kernels/csrc/"
             "encode_front.cu", "libultrahdr_dev_tpu/ops/gainmap.py:90"),
    "B10b": ("generate_gainmap", "libultrahdr_dev_tpu_torch/kernels/csrc/"
             "encode_front.cu", "libultrahdr_dev_tpu/ops/gainmap.py:103"),
    "B10c": ("convert_yuv_encoding", "libultrahdr_dev_tpu_torch/kernels/"
             "csrc/encode_front.cu", "libultrahdr_dev_tpu/ops/gainmap.py:427"),
    "B11": ("apply_gainmap_lut", "libultrahdr_dev_tpu_torch/kernels/csrc/"
            "apply.cu", "libultrahdr_dev_tpu/ops/color.py:254"),
    "B12": ("decode_jpeg_device", "libultrahdr_dev_tpu_torch/kernels/csrc/"
            "huff_decode.cu + libultrahdr_dev_tpu_torch/kernels/csrc/dct.cu",
            "libultrahdr_dev_tpu/jpeg/device_decode.py:876"),
    "B12e": ("huff_encode_rst_jpeg", "libultrahdr_dev_tpu_torch/kernels/"
             "csrc/huff_encode.cu", "libultrahdr_dev_tpu/jpeg/codec.py:326"),
    "B13": ("edit_planes", "libultrahdr_dev_tpu_torch/kernels/csrc/editor.cu",
            "libultrahdr_dev_tpu/ops/editor.py:71"),
    "B19": ("huff_encode_restartless", "libultrahdr_dev_tpu_torch/kernels/"
            "csrc/huff_encode.cu",
            "libultrahdr_dev_tpu/jpeg/device_entropy.py:294"),
    "B0": ("p010_dense_unpack", PACKIO_CU,
           "libultrahdr_dev_tpu/parallel/sharding.py:61"),
    "B14": ("p010_seg_unpack", PACKIO_CU,
            "libultrahdr_dev_tpu/parallel/packio.py:216"),
    "B15": ("rice_stats", PACKIO_CU,
            "libultrahdr_dev_tpu/parallel/packio.py:706"),
    "B16": ("rice_pack", PACKIO_CU,
            "libultrahdr_dev_tpu/parallel/packio.py:749"),
    "B18": ("planes_composite", PACKIO_CU,
            "libultrahdr_dev_tpu/ops/gainmap.py:264"),
    "B15/10": ("rice_stats_10bit", PACKIO_CU,
               "libultrahdr_dev_tpu/parallel/packio.py:678"),
    "B15/16": ("rice_stats_16bit", PACKIO_CU,
               "libultrahdr_dev_tpu/parallel/packio.py:706"),
    "B16/10": ("rice_pack_10bit", PACKIO_CU,
               "libultrahdr_dev_tpu/parallel/packio.py:833"),
    "B16/16": ("rice_pack_16bit", PACKIO_CU,
               "libultrahdr_dev_tpu/parallel/packio.py:894"),
    "B17a": ("rct_widths", PACKIO_CU,
             "libultrahdr_dev_tpu/parallel/packio.py:509"),
    "B17b": ("rct_pack", PACKIO_CU,
             "libultrahdr_dev_tpu/parallel/packio.py:535"),
    "B21a": ("plane_widths", PACKIO_CU,
             "libultrahdr_dev_tpu/parallel/packio.py:269"),
    "B21b": ("plane_pack", PACKIO_CU,
             "libultrahdr_dev_tpu/parallel/packio.py:299"),
    "B22": ("huff_decode_log", "libultrahdr_dev_tpu_torch/kernels/csrc/"
            "huff_decode.cu", "libultrahdr_dev_tpu/jpeg/device_decode.py:554"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from libultrahdr_dev_tpu_torch.kernels import build
    from libultrahdr_dev_tpu_torch.utils import profiler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)
    log(f"find_library: heif {ctypes.util.find_library('heif')}, avif "
        f"{ctypes.util.find_library('avif')}")

    t0 = time.perf_counter()
    with profiler.recording():
        build.build(verbose=True)
        build.get_lib()
    nvcc = sum(end - start for n, _, start, end in profiler.recorded()
               if n == "kernels.build")
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {nvcc:.1f} s)")

    results: dict = {}
    phases = [("kernels B1 B2 B5 B6 B11 B7",
               lambda: kernel_phases(dev, results))]
    kept = {}
    phases.append(("B2 tensor-core premise", lambda: b2_premise_phase(dev)))
    phases.append(("pow_exact", lambda: pow_phase(dev)))
    phases.append(("B3", lambda: kept.update(b3_phase(dev, results))))
    phases.append(("B9", lambda: b9_phase(dev, results)))
    phases.append(("B4", lambda: b4_phase(dev, results, kept)))
    phases.append(("B22", lambda: b22_phase(dev, results, kept)))
    phases.append(("B10", lambda: b10_phase(dev, results)))
    phases.append(("B12", lambda: b12_phase(dev, results, kept)))
    phases.append(("B13", lambda: b13_phase(dev, results)))
    phases.append(("B19", lambda: b19_phase(dev, results)))
    phases.append(("B12-enc", lambda: b12e_phase(dev, results)))
    phases.append(("B0 B14 B18 B15 B16",
                   lambda: packio_phase(dev, results, kept)))
    phases.append(("B15 B16 at 10 and 16 bits, B17, B21",
                   lambda: readback_phase(dev, results, kept)))
    for label, fn in phases:
        t = time.perf_counter()
        fn()
        log(f"phase {label}: {time.perf_counter() - t:.1f} s")
    for k in KERNELS:
        r = results[k]
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r.get("flops", 0.0),
                                             r.get("dflops", 0.0),
                                             r.get("tc_flops", 0.0))
        log(f"{k} {KERNELS[k][0]}: kernel {r['ms']:.4f} ms/frame, plain "
            f"{r['plain_ms']:.3f} ms/frame, bound {r['bound_ms']:.4f} "
            f"ms/frame ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), "
            f"library {r['library_ms']} ms/frame ("
            f"{f'{GW}x{GH}' if k in GENERAL_KERNELS else f'{W}x{H}'}, {smi})")
    t = time.perf_counter()
    launches, inputs, blobs, handoffs = main_path(dev, smi)
    log(f"phase main path API-0: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches8 = main_path_log(dev, smi, blobs, handoffs)
    log(f"phase main path log emission: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches1, inputs1, blobs1, _ = main_path_api1(dev, smi)
    log(f"phase main path API-1 / SDR / use_luts: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches2, general = main_path_general(dev, smi)
    log(f"phase main path general routes: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches3, conv = main_path_converter(dev, smi)
    log(f"phase main path converter: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches4 = main_path_dense(dev, smi)
    log(f"phase main path dense content: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches5 = main_path_serving(dev, smi)
    log(f"phase main path serving loop: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches6 = main_path_readback(dev, smi, kept)
    log(f"phase main path readback (--no-hostapply): "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches7 = main_path_cli(dev, smi)
    log(f"phase main path CLI: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches9 = main_path_capi(dev, smi)
    log(f"phase main path C-style API + batched apply: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches10, heif_stages = main_path_heif(dev, smi)
    log(f"phase main path HEIF: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches11, offpath_stages = main_path_offpath(dev, smi)
    log(f"phase main path off-path formats: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches12 = main_path_mesh(dev, smi)
    log(f"phase main path mesh: {time.perf_counter() - t:.1f} s")
    launch_guard_cost(dev, smi)
    launches = {k: sum(c[k] for c in (launches, launches1, launches2,
                                      launches3, launches4, launches5,
                                      launches6, launches7, launches8,
                                      launches9, launches10, launches11,
                                      launches12))
                for k in launches}
    launches["B3"] += launches.pop("B3g")
    launches["B19"] += launches.pop("B19g")
    stage_times(dev, smi, inputs, blobs, handoffs, (inputs1, blobs1))
    stage_times_general(dev, smi, general)
    stage_times_converter(dev, smi, conv)
    stage_times_serving(dev, smi, kept)
    stage_times_readback(dev, smi, kept)
    for label, ms in heif_stages.items():
        log(f"stage heif {label}: {float(np.median(ms)):.3f} ms (median of "
            f"{len(ms)}; {smi})")
    for label, ms in offpath_stages.items():
        log(f"stage offpath {label}: {float(np.median(ms)):.3f} ms (median "
            f"of {len(ms)}; {GW}x{GH}; {smi})")

    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": results[k]["err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"],
         **({"launches_count": "images: one launch edits all planes of an "
             "image"} if k == "B13" else {})} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
