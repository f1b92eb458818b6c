#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from kernels/csrc with nvcc, checks
each against its plain PyTorch version at the shapes of a 4080x3072
frame, drives the API-0 round trip (batched encode, batched decode,
JpegR, UhdrEncoder / UhdrDecoder) at 4080x3072, checks what comes out,
and times the kernels and the stages. It needs one CUDA device and
fails (exit code != 0, no result line) without one; nothing falls back
to the CPU. It imports nothing of JAX.

Output: progress lines, the card's name and power limit as nvidia-smi
reports them, a JSON line {"kernels": [...]}, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

W, H, FRAMES = 4080, 3072, 2
SEED = 0
CONFIGS = (("bt2100", "hlg"), ("bt709", "pq"))


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
    return torch.stack([(((a >> s) & 1023) - ((b >> s) & 1023)).abs()
                        for s in (0, 10, 20)])


def kernel_phases(dev, results: dict):
    """Each kernel against its plain version at the 4080x3072 shapes,
    on inputs from a seed; the stages feed each other like the main
    path does."""
    import torch

    from libultrahdr_dev_tpu_torch.jpeg import dct
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    y_np, uv_np = synth_p010(FRAMES, H, W, SEED)
    y = batched.p010_to_device(y_np, dev)
    uv = batched.p010_to_device(uv_np, dev)
    gamut, tf = CONFIGS[0]

    # B1: gain codes <= 1 apart on <= 1e-4 of samples; planes <= 1 apart.
    got = gm.encode_front(y, uv, gamut, tf)
    ref = gm.encode_front_plain(y, uv, gamut, tf)
    d = [(g.to(torch.int32) - r.to(torch.int32)).abs()
         for g, r in zip(got, ref)]
    n_off = int((d[0] > 0).sum())
    err_b1 = max(int(x.max()) for x in d)
    log(f"B1 encode_front: max |diff| gain {int(d[0].max())} on {n_off} of "
        f"{d[0].numel()} samples, planes max "
        f"{max(int(x.max()) for x in d[1:])}")
    require(int(d[0].max()) <= 1 and n_off <= 1e-4 * d[0].numel(),
            "B1 gain codes disagree with the plain version")
    require(all(int(x.max()) <= 1 for x in d[1:]),
            "B1 base planes disagree with the plain version")
    results["B1"] = dict(
        err=err_b1,
        ms=cuda_ms(lambda: gm.encode_front(y, uv, gamut, tf), 20) / FRAMES,
        plain_ms=cuda_ms(lambda: gm.encode_front_plain(y, uv, gamut, tf), 3)
        / FRAMES)
    gmap, yb, ub, vb = got

    # B2: int16 equal except +-1 on <= 1e-5 of coefficients.
    qs = [torch.from_numpy(q.reshape(64)).to(dev)
          for q in batched.quant_tables(95)]
    planes = ((yb, qs[0]), (ub, qs[1]), (vb, qs[1]), (gmap, qs[2]))
    coefs, worst, n_off, n_all = [], 0, 0, 0
    for p, q in planes:
        c = dct.fdct_quant(p, q)
        dd = (c.to(torch.int32) - dct.fdct_quant_plain(p, q).to(
            torch.int32)).abs()
        worst = max(worst, int(dd.max()))
        n_off += int((dd > 0).sum())
        n_all += dd.numel()
        coefs.append(c)
    log(f"B2 fdct_quant: max |diff| {worst} on {n_off} of {n_all} "
        f"coefficients")
    require(worst <= 1 and n_off <= 1e-5 * n_all,
            "B2 coefficients disagree with the plain version")
    results["B2"] = dict(
        err=worst,
        ms=cuda_ms(lambda: [dct.fdct_quant(p, q) for p, q in planes], 20) /
        FRAMES,
        plain_ms=cuda_ms(lambda: [dct.fdct_quant_plain(p, q)
                                  for p, q in planes], 3) / FRAMES)

    # B5: u8 planes <= 1 apart on <= 1e-4 of pixels.
    idct_args = []
    for c, (p, q) in zip(coefs, planes):
        bh, bw = dct.blocks_dims(*p.shape[1:])
        idct_args.append((c, q.expand(FRAMES, 64).contiguous(), bh, bw))
    decoded, worst, n_off, n_all = [], 0, 0, 0
    for args in idct_args:
        pix = dct.dequant_idct(*args)
        dd = (pix.to(torch.int32) - dct.dequant_idct_plain(*args).to(
            torch.int32)).abs()
        worst = max(worst, int(dd.max()))
        n_off += int((dd > 0).sum())
        n_all += dd.numel()
        decoded.append(pix)
    log(f"B5 dequant_idct: max |diff| {worst} on {n_off} of {n_all} pixels")
    require(worst <= 1 and n_off <= 1e-4 * n_all,
            "B5 pixels disagree with the plain version")
    results["B5"] = dict(
        err=worst,
        ms=cuda_ms(lambda: [dct.dequant_idct(*a) for a in idct_args], 20) /
        FRAMES,
        plain_ms=cuda_ms(lambda: [dct.dequant_idct_plain(*a)
                                  for a in idct_args], 3) / FRAMES)

    # B6: <= 1 ten-bit code / F16 ULP, >= 99.9% bit-exact per channel.
    y8, u8, v8 = decoded[:3]
    g8 = decoded[3][:, :H // 4, :W // 4]
    worst, times = 0, {}
    for fmt, (g_, t_) in (("hdr_linear", CONFIGS[0]),
                          ("hdr_hlg", CONFIGS[0]), ("hdr_pq", CONFIGS[1])):
        sc = torch.from_numpy(np.stack([batched.apply_scalars(
            batched.api0_metadata(t_), math.inf)] * FRAMES)).to(dev)
        args = (y8, u8, v8, g8, sc, fmt)
        dd = code_diff(gm.apply_gainmap(*args), gm.apply_gainmap_plain(*args),
                       fmt)
        exact = float((dd == 0).double().mean())
        log(f"B6 apply_gainmap {fmt}: max |diff| {int(dd.max())}, "
            f"{int((dd > 0).sum())} of {dd.numel()} channel samples differ "
            f"({exact:.6f} exact)")
        require(int(dd.max()) <= 1 and exact >= 0.999,
                f"B6 {fmt} disagrees with the plain version")
        worst = max(worst, int(dd.max()))
        times[fmt] = (cuda_ms(lambda: gm.apply_gainmap(*args), 20) / FRAMES,
                      cuda_ms(lambda: gm.apply_gainmap_plain(*args), 3) /
                      FRAMES)
        log(f"B6 {fmt}: kernel {times[fmt][0]:.3f} ms/frame, plain "
            f"{times[fmt][1]:.3f} ms/frame")
    results["B6"] = dict(err=worst, ms=times["hdr_linear"][0],
                         plain_ms=times["hdr_linear"][1])


def main_path(dev, smi: str):
    """The API-0 round trip through the entry points a user calls; the
    launch counters are zeroed just before and read just after."""
    import torch

    from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                           OutputFormat, PixelFormat,
                                           RawImage, UhdrDecoder,
                                           UhdrEncoder)
    from libultrahdr_dev_tpu_torch.api import HDR_IMG
    from libultrahdr_dev_tpu_torch.container import mux
    from libultrahdr_dev_tpu_torch.jpeg import dct
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    wrappers = {"B1": gm.encode_front, "B2": dct.fdct_quant,
                "B5": dct.dequant_idct, "B6": gm.apply_gainmap}
    inputs = {cfg: synth_p010(FRAMES, H, W, SEED + 1 + i)
              for i, cfg in enumerate(CONFIGS)}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0

    t0 = time.perf_counter()
    blobs, outs = {}, {}
    for (gamut, tf), (y, uv) in inputs.items():
        blobs[gamut, tf] = batched.batched_encode_api0(
            y, uv, gamut=gamut, hdr_tf=tf, quality=95, device=dev)
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
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"main path: {wall:.1f} s wall, kernel launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    # What came out: containers, shapes, finite values, luminance.
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

    # Stage times, warm, per frame (batch of FRAMES, first config).
    gamut, tf = CONFIGS[0]
    y, uv = inputs[CONFIGS[0]]
    yd, uvd = (batched.p010_to_device(a, dev) for a in (y, uv))

    def enc_dev():
        c = batched.encode_device_stage(yd, uvd, gamut, tf, 95)
        torch.cuda.synchronize()
        return c

    coefs = enc_dev()
    frames = [batched.decode_host_stage(b) for b in blobs[gamut, tf]]

    def dec_dev():
        batched.decode_device_stage(frames, f"hdr_{tf}", math.inf, dev)
        torch.cuda.synchronize()

    stages = {
        "encode_device": host_ms(enc_dev, 5) / FRAMES,
        "encode_host": host_ms(lambda: batched.assemble_api0(
            coefs, W, H, gamut, tf, 95), 2) / FRAMES,
        "decode_host": host_ms(lambda: [batched.decode_host_stage(b)
                                        for b in blobs[gamut, tf]], 2)
        / FRAMES,
        "decode_device": host_ms(dec_dev, 5) / FRAMES,
    }
    for k, v in stages.items():
        log(f"stage {k}: {v:.2f} ms/frame ({W}x{H}, batch {FRAMES}, "
            f"{gamut}/{tf}, {smi})")
    return launches


KERNELS = {
    "B1": ("encode_front", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "encode_front.cu", "libultrahdr_dev_tpu/parallel/sharding.py:570"),
    "B2": ("fdct_quant", "libultrahdr_dev_tpu_torch/kernels/csrc/dct.cu",
           "libultrahdr_dev_tpu/jpeg/dct.py:76"),
    "B5": ("dequant_idct", "libultrahdr_dev_tpu_torch/kernels/csrc/dct.cu",
           "libultrahdr_dev_tpu/jpeg/dct.py:122"),
    "B6": ("apply_gainmap", "libultrahdr_dev_tpu_torch/kernels/csrc/"
           "apply.cu", "libultrahdr_dev_tpu/ops/gainmap.py:296"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from libultrahdr_dev_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.get_lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{build.build_seconds if build.build_seconds is not None else 0:.1f}"
        f" s)")

    results: dict = {}
    kernel_phases(dev, results)
    for k, r in results.items():
        log(f"{k} {KERNELS[k][0]}: kernel {r['ms']:.3f} ms/frame, plain "
            f"{r['plain_ms']:.3f} ms/frame ({W}x{H}, {smi})")
    launches = main_path(dev, smi)

    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": results[k]["err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
