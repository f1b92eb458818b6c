#!/usr/bin/env python3
"""Kernels of this tree beside the same kernels of another checkout, in
one process on one NVIDIA GPU: B2 (fdct_quant), B5 (dequant_idct), B4
and B22 (the Huffman decode, dense and log emission), B12-dec (B4 then
B5), B19 (the restart-less Huffman encode), B3 and B12-enc (the
restart-interval Huffman encode), B6 / B11 (the gain-map apply), B1 /
B9 / B10b (the encode front ends) and B15 / B16 (Rice pass 1 and the
Rice pack of the packed readbacks), B7 (the SDR output), B13 (the
effect chain), B17b (the RCT fine-width pack), B18 (the planes
composite), B14 (the segment-packed upload), B17a (the RCT widths
pass) and B21a (the widths pass of a 10-bit plane).

    git archive <commit> | tar -x -C _verify/other
    python3 dct_timing.py _verify/other
    python3 dct_timing.py _verify/other --only B7,B13   # those two alone
    python3 dct_timing.py _verify/other --only B17b,B18 # with B15/B16's checks
    python3 dct_timing.py _verify/other --only B14,B17a
    python3 dct_timing.py _verify/other --only B21a

Both trees' kernels are built from their own sources (each into its own
git-ignored _build directory) and called through their own wrappers on
chip_smoke.py's inputs: B1's planes and gain map of the 4080x3072 batch
of 2 at quality 95 (B2), their coefficients (B5), the API-0 JPEG/Rs of
that batch (B4, B22: base and gain map), a 4000x3000 4:2:0 JPEG from
encode_jpeg, restart-less, decoded by B4 then B5 (B12-dec), the
general route's 4000x3000 base and 1000x750 gain map (B19), B2's
coefficients of the batch (B3: base and gain map at the device routes'
interval of 4 MCUs), encode_jpeg's coefficients of a 4000x3000 4:2:0
frame at r = 4 (B12-enc), B5's pixels of the batch (B6 in its four
output formats, B11 to HLG), the batch's P010 frames (B1 at HLG and PQ;
B9 with chip_smoke.py's BT.709 SDR rendition, HLG), a tonemapped
4000x3000 frame (B10b, the general route's API-0 gain map), and
chip_smoke.py's readback inputs (a
4080x3072 batch of 4 decoded to the u8 planes composite, to HLG
RGBA1010102 and to F16: B15 and B16 at 8, 10 and 16 bits), B5's
planes of the batch (B7), chip_smoke.py's B13 frame: a 4000x3000
YUV420 image and its 1000x750 gain map (each single effect of its B13
phase, and the converter's chain on both), and the readback inputs
again (B18 on the batch's u8 planes, B17b on this tree's pass 1 of the
HLG pixels).

Checks: B2 of both trees bitwise equal to the plain version; B5 of both
trees bitwise equal to each other, with their off-count against the
plain version; B4, B22 and B12-dec of both trees bitwise equal to each
other; B19's, B3's and B12-enc's streams and bits of both trees bitwise
equal; B6 (F16, HLG, PQ, 10-bit planar) and B11 (HLG) of both trees
bitwise equal; B1 (HLG, PQ), B9 and B10b of both trees bitwise equal;
B15's residuals and maps (both schemes), B16's orders,
two-phase blobs (each scheme on its host plan) and fused buffers (fit
and no fit) of both trees bitwise equal, and equal to the plain
versions; each tree's packed fetch of the composite, the HLG and the
F16 pixels = the source; B7 and B13 (each single effect, the chain) of
both trees bitwise equal; B17b and B18 of both trees bitwise equal, and
equal to the plain versions.

Times, ms per frame, in turns (other, this, this, other): B2, B5, B4,
B22 and B12-dec by CUDA-graph replay and by CUDA events, B20 (B1 + B2)
by CUDA graph, B19, B3 and B12-enc by CUDA events with their syncs (as
chip_smoke.py times them), B6 and B11 by CUDA graph, B1 (HLG, PQ), B9
and B10b by CUDA events and by CUDA graph; then each tree's device ms
by kernel (torch.profiler) of B4, B22 (its pass split: log_kernel,
rebuild_kernel), B12-dec, B19, B3, B12-enc, B6 (F16, PQ), B11 and B1
(HLG, PQ); B15 (both schemes) and B16 (the MED
two-phase pack: order and emit) at 8, 10 and 16 bits by CUDA events
with each tree's device ms by kernel, and the three packed fetches
(B15 + B16 + D2H + native unpack) by the host clock, synchronized; B7
by CUDA events and by CUDA graph, each B13 single effect by CUDA graph,
the B13 chain (frame + map) by CUDA graph and launched one by one (CUDA
events), in turns; B17b and B18 by CUDA events and by CUDA graph, in
turns, with each tree's device ms by kernel (B17b's order and pack
apart). `--only B17b,B18` runs B15's and B16's checks at the three
widths (B17b's order runs on B16's kernels), then B17b and B18.
`--only B14,B17a` checks B14 on chip_smoke.py's bench upload (4080x3072,
batch of 4), on full-range noise at that size and on its B14_EDGES
inputs, and B17a on the HLG pixels and its B17_EDGES inputs: both trees
bitwise equal to the plain versions; prints a fill_ of B14's output and
a copy_ of B17a's residuals by CUDA graph (the card's rates for those
bytes); then times B14 (bench, noise) and B17a in turns by CUDA events
and by CUDA graph, with each tree's device ms by kernel.
`--only B21a` checks B21a (the widths pass of a 10-bit plane) on the
readback batch decoded to 10-bit planar and on chip_smoke.py's
B21_EDGES planes, both trees (and this tree's kernel at each row run)
bitwise equal to the plain version; prints a copy_ of B21a's residuals
by CUDA graph; then times B21a in turns by CUDA events and by CUDA
graph with each tree's device ms by kernel, and this tree's kernel at
each row run in turns.
Prints the card's name and power limit and, last,
one JSON object of the times.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys

import numpy as np

PKG = "libultrahdr_dev_tpu_torch"


def load_other(root: str):
    """The other checkout's package, imported as `uhdr_other`."""
    pkg = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        "uhdr_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["uhdr_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def modules(prefix: str) -> dict:
    """The timed modules of one tree's package."""
    mods = {k: importlib.import_module(f"{prefix}.jpeg.{k}")
            for k in ("dct", "device_decode", "device_entropy")}
    mods["gainmap"] = importlib.import_module(f"{prefix}.ops.gainmap")
    mods["packio"] = importlib.import_module(f"{prefix}.parallel.packio")
    mods["editor"] = importlib.import_module(f"{prefix}.ops.editor")
    mods["types"] = importlib.import_module(f"{prefix}.types")
    return mods


def sdr_edit_timing(cs, trees: dict, dev, smi: str):
    """B7 and B13 of both trees: bitwise checks, then times in turns
    (other, this, this, other). -> {tree: [times of each turn]}."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import editor

    frames = cs.FRAMES
    y_np, uv_np = cs.synth_p010(frames, cs.H, cs.W, cs.SEED)
    y8, u8, v8 = cs._decoded_planes(dev, y_np, uv_np)[0][:3]
    outs = [m["gainmap"].yuv420_to_rgba8888(y8, u8, v8)
            for m in trees.values()]
    cs.require(torch.equal(*outs), "B7 differs between the trees")
    print("B7 of both trees bitwise equal", flush=True)

    # chip_smoke.py's B13 frame and gain map, as each tree's RawImage.
    gy, guv = cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 70)
    planes = [torch.from_numpy((a >> 8).astype(np.uint8)).to(dev) for a in
              (gy[0], guv[0, :, 0::2], guv[0, :, 1::2])]
    gplane = planes[0][::4, ::4].contiguous()
    chain = cs.converter_chain()
    crop = editor.CropEffect(cs.GW // 20, cs.GW - cs.GW // 20,
                             *cs.CONV_ROWS)
    singles = {"crop": crop, "mirror": chain[2], "rotate90": chain[1],
               "rotate180": editor.RotateEffect(180), "resize": chain[3]}

    def images(m):
        t = m["types"]
        frame = t.RawImage(fmt=t.PixelFormat.YUV420, width=cs.GW,
                           height=cs.GH, planes=dict(zip("yuv", planes)))
        gmap = t.RawImage(fmt=t.PixelFormat.MONOCHROME, width=cs.GW // 4,
                          height=cs.GH // 4, planes={"y": gplane})
        return frame, gmap

    def port(m, effects):
        """The effects as the tree's own dataclasses."""
        ed = m["editor"]
        return [getattr(ed, type(e).__name__)(**vars(e)) for e in effects]

    def calls(m):
        frame, gmap = images(m)
        ed = m["editor"]
        fx = {k: port(m, [e]) for k, e in singles.items()}
        c, gc = port(m, chain), port(m, editor.scale_effects(chain, 4))
        out = {k: (lambda e=e: [ed.apply_effects(frame, e)])
               for k, e in fx.items()}
        out["chain"] = lambda: [ed.apply_effects(frame, c),
                                ed.apply_effects(gmap, gc)]
        return out

    runs = {name: calls(m) for name, m in trees.items()}
    for k in runs["this"]:
        a, b = (
            [p for img in runs[n][k]() for p in img.planes.values()]
            for n in ("other", "this"))
        cs.require(len(a) == len(b) and all(map(torch.equal, a, b)),
                   f"B13 {k} differs between the trees")
    print("B13 of both trees bitwise equal: each single effect and the "
          "chain", flush=True)
    times = {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        m, r = trees[name], runs[name]
        b7 = lambda: m["gainmap"].yuv420_to_rgba8888(y8, u8, v8)  # noqa
        t = dict(B7_events=cs.cuda_ms(b7, 20) / frames,
                 B7_graph=cs.graph_ms(b7, 20) / frames)
        for k, fn in r.items():
            t[f"B13_{k}_graph"] = cs.graph_ms(fn, 20)
        t["B13_chain_events"] = cs.cuda_ms(r["chain"], 20)
        print(f"turn {turn} {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms/frame ({smi})",
            flush=True)
        times.setdefault(name, []).append(t)
    return times


def rice_inputs(cs, dev):
    """chip_smoke.py's readback inputs: the u8 planes of a decoded
    4080x3072 batch of 4, {bits: source} of the three readbacks (the
    planes composite, HLG RGBA1010102 and F16 pixels) and the batch's
    10-bit planar codes as one (3 * 4 * 3072, 4080) plane."""
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm

    y_np, uv_np = cs.synth_p010(cs.SERVE_FRAMES, cs.H, cs.W, cs.SEED + 200)
    planes, sc = cs._decoded_planes(dev, y_np, uv_np)
    pix = cs._decoded_pixels(dev, {"planes": planes, "scalars": sc})
    return planes, {8: gm.planes_composite(*planes), 10: pix["hdr_hlg"],
                    16: pix["hdr_linear"]}, \
        pix["hdr_linear_rgb_10bit"].reshape(-1, cs.W)


def rice_checks(cs, trees: dict, dev, arms: dict) -> dict:
    """B15's residuals and maps and B16's orders, two-phase blobs (each
    scheme on its host plan) and fused buffers (fit and no fit) of both
    trees at each width of `arms`: bitwise equal to each other and to the
    plain versions. -> {bits: the MED two-phase pack's arguments}."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    both = (False, True)
    packs = {}
    for bits, x in arms.items():
        outs = {name: m["packio"].rice_stats(x, both)
                for name, m in trees.items()}
        zr, mr = packio.rice_stats_plain(x, both)
        for name, (zg, mg) in outs.items():
            cs.require(all(map(torch.equal, zg, zr)) and torch.equal(mg, mr),
                       f"{name}: B15 {bits}-bit differs from the plain "
                       f"version")
        zg, mg = outs["this"]
        maps = mg.cpu().numpy()
        for pick, med in ((0, False), (1, True)):
            _, _, rp, up, offs, _ = packio._rice_host_plan(
                maps[2 * pick], maps[2 * pick + 1], 10**15, bits)
            kuw = mg[2 * pick:2 * pick + 2]
            ref = packio.rice_pack_plain(zg[pick], kuw, offs, rp, up)
            for name, m in trees.items():
                pk = m["packio"]
                sidx = torch.empty((2, kuw.shape[1]), dtype=torch.int32,
                                   device=dev)
                pk._rice_order(kuw, sidx, nk=len(rp))
                blob = pk.rice_pack(zg[pick], kuw, offs, rp, up, bits)
                cs.require(torch.equal(blob, ref), f"{name}: B16 {bits}-bit "
                           f"two-phase differs from the plain version")
                packs.setdefault((bits, med), []).append(sidx)
                for pads in ((rp, up), ((32,) * len(rp), (32,) * 7)):
                    fused = (pk.rice_fused(x, med, *pads),
                             packio.rice_fused_plain(x, med, *pads))
                    cs.require(torch.equal(*fused), f"{name}: B16 {bits}-"
                               f"bit fused differs from the plain version")
            a, b = packs.pop((bits, med))
            cs.require(torch.equal(a, b), f"B16 {bits}-bit orders differ "
                       f"between the trees")
            if med:
                packs[bits] = (zg[1], kuw, offs, rp, up)
        print(f"B15/B16 {bits}-bit of both trees bitwise equal (and = "
              f"plain): residuals, maps, orders, two-phase and fused "
              f"blobs ({mg.shape[1]} segments)", flush=True)
    return packs


def pack_timing(cs, trees: dict, dev, smi: str, planes, arms: dict):
    """B17b (the fine-width pack of the HLG pixels, on this tree's pass
    1) and B18 (the planes composite) of both trees: bitwise equal to
    each other and to the plain versions, then times in turns (other,
    this, this, other) by CUDA events and by CUDA graph, and each tree's
    device ms by kernel (B17b's order and pack apart). -> (times,
    by_kernel)."""
    import torch

    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import packio

    n = cs.SERVE_FRAMES
    comps = [m["gainmap"].planes_composite(*planes)
             for m in trees.values()]
    cs.require(all(torch.equal(c, arms[8]) for c in comps)
               and torch.equal(arms[8], gm.planes_composite_plain(*planes)),
               "B18 differs between the trees or from the plain version")
    x = arms[10]
    zs, bc = packio.rct_widths(x)
    counts = np.bincount(packio.FINE_RANK[bc.cpu().numpy().reshape(-1)],
                         minlength=9)
    npads = tuple(packio._pow2_pad(max(int(c), 1), floor=32)
                  for c in counts[1:])
    offs = np.cumsum(counts[:8]).astype(np.int32)
    ref = packio.rct_pack_plain(zs, bc, offs, npads)
    for name, m in trees.items():
        cs.require(torch.equal(m["packio"].rct_pack(zs, bc, offs, npads),
                               ref), f"{name}: B17b differs from the plain "
                   f"version")
    print(f"B17b and B18 of both trees bitwise equal (and = plain; "
          f"{bc.numel()} segments, rank counts {counts.tolist()})",
          flush=True)
    runs = {name: {"B17b": lambda m=m: m["packio"].rct_pack(zs, bc, offs,
                                                            npads),
                   "B18": lambda m=m: m["gainmap"].planes_composite(
                       *planes)} for name, m in trees.items()}
    return turns(cs, runs, n, smi)


def turns(cs, runs: dict, n: int, smi: str):
    """runs[tree][kernel] (a call on a batch of n frames) timed in turns
    (other, this, this, other) by CUDA events and by CUDA graph, ms per
    frame, then each tree's device ms by kernel. -> (times, by_kernel)."""
    times = {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        t = {}
        for k, fn in runs[name].items():
            t[f"{k}_events"] = cs.cuda_ms(fn, 20) / n
            t[f"{k}_graph"] = cs.graph_ms(fn, 20) / n
        print(f"turn {turn} {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms/frame ({smi})",
            flush=True)
        times.setdefault(name, []).append(t)
    by_kernel = {}
    for name in runs:
        for k, fn in runs[name].items():
            by = {kk: v / n for kk, v in cs.device_ms_by_kernel(fn, 10)
                  .items()}
            by_kernel.setdefault(name, {})[k] = by
            print(f"{name} {k}: device ms/frame by kernel "
                  f"{ {kk: round(v, 4) for kk, v in by.items()} } ({smi})",
                  flush=True)
    return times, by_kernel


def upload_widths_timing(cs, trees: dict, dev, smi: str, arms: dict):
    """B14 (the segment-packed upload of chip_smoke.py's bench content,
    4080x3072 batch of 4, full-range noise at that size (every segment in
    the 10-bit bucket), then its B14_EDGES inputs) and B17a (the widths
    pass of the HLG pixels, then its B17_EDGES inputs) of both trees:
    bitwise equal to the plain versions, so to each other. Then, by CUDA
    graph, the card's rates for the same bytes: a fill_ of B14's output
    and a copy of B17a's residuals; then times in turns. -> (times,
    by_kernel)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    n = cs.SERVE_FRAMES
    b14_in = [("4080x3072", cs.synth_p010(n, cs.H, cs.W, cs.SEED + 200)),
              ("noise 4080x3072", cs.b14_input(n, cs.H, cs.W, "noise",
                                               cs.SEED + 207))]
    b14_in += [(label, cs.b14_input(en, h, w, kind, cs.SEED + 206 + i))
               for i, (label, en, h, w, kind) in enumerate(cs.B14_EDGES)]
    unpacks = {name: m["packio"].unpack_plane_device
               for name, m in trees.items()}
    blobs = {label: cs.b14_check(dev, cs.b14_pack(y, uv), y, uv, label,
                                 unpacks)[:2]
             for label, (y, uv) in b14_in}
    rng = np.random.default_rng(cs.SEED + 212)
    b17_in = [("4080x3072", arms[10])]
    b17_in += [(label, torch.from_numpy(cs._rice_edge_batch(
        10, en, h, w, kind, rng)).to(dev))
        for label, en, h, w, kind in cs.B17_EDGES]
    for label, x in b17_in:
        zp, bp = packio.rct_widths_plain(x)
        for name, m in trees.items():
            zs, bc = m["packio"].rct_widths(x)
            cs.require(torch.equal(zs, zp) and torch.equal(bc, bp),
                       f"{name}: B17a {label} differs from the plain "
                       f"version")
    print(f"B14 and B17a of both trees bitwise equal to the plain versions "
          f"at 4080x3072 (batch of {n}; B14 on bench content and on noise) "
          f"and on {len(b14_in) - 2} and {len(b17_in) - 1} edge inputs",
          flush=True)
    y, uv = b14_in[0][1]
    out = torch.empty(2 * (y.size + uv.size), dtype=torch.uint8, device=dev)
    zs = packio.rct_widths(arms[10])[0]
    zs2 = torch.empty_like(zs)
    print(f"fill_ of B14's {out.numel() / 1e6:.1f} MB output "
          f"{cs.graph_ms(lambda: out.fill_(1), 20) / n:.4f}, copy_ of "
          f"B17a's {zs.numel() * 2 / 1e6:.1f} MB residuals "
          f"{cs.graph_ms(lambda: zs2.copy_(zs), 20) / n:.4f} ms/frame by "
          f"graph ({smi})", flush=True)

    def b14(m, label):
        blob, plan = blobs[label]
        return lambda: m["packio"].unpack_plane_device(blob, plan, n, cs.H)

    runs = {name: {"B14": b14(m, "4080x3072"),
                   "B14_noise": b14(m, "noise 4080x3072"),
                   "B17a": lambda m=m: m["packio"].rct_widths(arms[10])}
            for name, m in trees.items()}
    return turns(cs, runs, n, smi)


def plane_widths_timing(cs, trees: dict, dev, smi: str, plane):
    """B21a (the widths pass of a 10-bit plane) of both trees on
    chip_smoke.py's readback batch decoded to 10-bit planar (`plane`:
    4080x3072, batch of 4, one (36864, 4080) plane) and on its B21_EDGES
    planes: bitwise equal to the plain version, so to each other. Then, by CUDA
    graph, a copy_ of B21a's residuals (the card's rate for about the
    same bytes); then times in turns (other, this, this, other) by CUDA
    events and by CUDA graph with each tree's device ms by kernel.
    -> (times, by_kernel)."""
    import torch

    from libultrahdr_dev_tpu_torch.parallel import packio

    n = cs.SERVE_FRAMES
    ins = [(f"{cs.W}x{cs.H}", plane)]
    ins += [(label, torch.from_numpy(cs.b21_edge_plane(
        h, w, kind, cs.SEED + 213 + i)).to(dev))
        for i, (label, h, w, kind) in enumerate(cs.B21_EDGES)]
    for label, x in ins:
        zp, bp = packio.plane_widths_plain(x)
        for name, m in trees.items():
            zs, bc = m["packio"].plane_widths(x)
            cs.require(torch.equal(zs, zp) and torch.equal(bc, bp),
                       f"{name}: B21a {label} differs from the plain "
                       f"version")
    print(f"B21a of both trees bitwise equal to the plain version at {cs.W}x{cs.H} (batch of "
          f"{n}, {plane.shape[0]}x{plane.shape[1]}) and on "
          f"{len(ins) - 1} edge planes", flush=True)
    zs = packio.plane_widths(plane)[0]
    zs2 = torch.empty_like(zs)
    print(f"copy_ of B21a's {zs.numel() * 2 / 1e6:.1f} MB residuals "
          f"{cs.graph_ms(lambda: zs2.copy_(zs), 20) / n:.4f} ms/frame by "
          f"graph ({smi})", flush=True)
    runs = {name: {"B21a": lambda m=m: m["packio"].plane_widths(plane)}
            for name, m in trees.items()}
    return turns(cs, runs, n, smi)


def rice_timing(cs, trees: dict, dev, smi: str, arms: dict, packs: dict):
    """B15 and B16 of both trees on chip_smoke.py's readback inputs
    (`arms`, checked by rice_checks, whose `packs` B16 takes): times in
    turns and device ms by kernel, and the three packed fetches. ->
    (times, by_kernel)."""
    both = (False, True)
    n = cs.SERVE_FRAMES

    def b15(m, bits):
        return m["packio"].rice_stats(arms[bits], both)

    def b16(m, bits):
        zs, kuw, offs, rp, up = packs[bits]
        return m["packio"].rice_pack(zs, kuw, offs, rp, up, bits)

    # The packed readbacks end to end (B15 + B16 + D2H + native unpack),
    # synchronized: each tree's fetch gives the source back.
    fetches = {"planes": ("fetch_planes_u8", 8),
               "HLG": ("fetch_rgba1010102_auto", 10),
               "F16": ("fetch_rgba_f16_auto", 16)}
    for label, (fn, bits) in fetches.items():
        want = arms[bits].cpu().numpy().view(np.uint8).ravel()
        for name, m in trees.items():
            got = getattr(m["packio"], fn)(arms[bits])[0]
            cs.require(got is not None and np.array_equal(
                np.ascontiguousarray(got).view(np.uint8).ravel(), want),
                f"{name}: the {label} fetch differs from the source")
    times = {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        m = trees[name]
        t = {}
        for bits in arms:
            t[f"B15_{bits}_events"] = cs.cuda_ms(lambda: b15(m, bits), 20) / n
            t[f"B16_{bits}_events"] = cs.cuda_ms(lambda: b16(m, bits), 20) / n
        for label, (fn, bits) in fetches.items():
            t[f"fetch_{label}_host"] = cs.host_ms(
                lambda: getattr(m["packio"], fn)(arms[bits]), 3) / n
        print(f"turn {turn} {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms/frame ({smi})",
            flush=True)
        times.setdefault(name, []).append(t)
    by_kernel = {}
    for name, m in trees.items():
        for bits in arms:
            for what, fn in (("B15", b15), ("B16", b16)):
                by = {k: v / n for k, v in cs.device_ms_by_kernel(
                    lambda: fn(m, bits), 10).items()}
                by_kernel.setdefault(name, {})[f"{what}/{bits}"] = by
                print(f"{name} {what} {bits}-bit: device ms/frame by kernel "
                      f"{ {k: round(v, 4) for k, v in by.items()} } ({smi})",
                      flush=True)
    return times, by_kernel


def main(argv) -> int:
    import torch

    only = argv[3].split(",") if len(argv) == 4 and argv[2] == "--only" \
        else None
    if len(argv) != (4 if only else 2) or not torch.cuda.is_available() \
            or not set(only or ()) <= {"B7", "B13", "B14", "B17a", "B17b",
                                       "B18", "B21a"}:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libultrahdr_dev_tpu_torch import jpegr
    from libultrahdr_dev_tpu_torch.jpeg import codec, dct
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}\n{smi}", flush=True)
    load_other(argv[1])
    trees = {"other": modules("uhdr_other"), "this": modules(PKG)}
    if only:
        times, by_kernel = {}, {}
        parts = []
        if {"B7", "B13"} & set(only):
            parts.append((sdr_edit_timing(cs, trees, dev, smi), {}))
        if {"B14", "B17a", "B17b", "B18", "B21a"} & set(only):
            planes, arms, plane10 = rice_inputs(cs, dev)
        if {"B17b", "B18"} & set(only):
            rice_checks(cs, trees, dev, arms)
            parts.append(pack_timing(cs, trees, dev, smi, planes, arms))
        if {"B14", "B17a"} & set(only):
            parts.append(upload_widths_timing(cs, trees, dev, smi, arms))
        if "B21a" in only:
            parts.append(plane_widths_timing(cs, trees, dev, smi, plane10))
        for ts, by in parts:
            for name, runs in ts.items():
                old = times.setdefault(name, [{} for _ in runs])
                for t, r in zip(old, runs):
                    t.update(r)
            for name, b in by.items():
                by_kernel.setdefault(name, {}).update(b)
        print(json.dumps({"device": smi, "times": times,
                          "by_kernel": by_kernel}))
        return 0

    frames = cs.FRAMES
    y_np, uv_np = cs.synth_p010(frames, cs.H, cs.W, cs.SEED)
    y = batched.p010_to_device(y_np, dev)
    uv = batched.p010_to_device(uv_np, dev)
    gamut, tf = cs.CONFIGS[0]
    gmap, yb, ub, vb = gm.encode_front(y, uv, gamut, tf)
    qs = [torch.from_numpy(q.reshape(64)).to(dev)
          for q in batched.quant_tables(95)]
    planes = ((yb, qs[0]), (ub, qs[1]), (vb, qs[1]), (gmap, qs[2]))
    plain = [dct.fdct_quant_plain(p, q) for p, q in planes]
    idct_args = []
    for c, (p, q) in zip(plain, planes):
        bh, bw = dct.blocks_dims(*p.shape[1:])
        idct_args.append((c, q.expand(frames, 64).contiguous(), bh, bw))
    pix_plain = [dct.dequant_idct_plain(*a) for a in idct_args]
    pix = {}
    for name, m in trees.items():
        got = [m["dct"].fdct_quant(p, q) for p, q in planes]
        off = sum(int((g != w).sum()) for g, w in zip(got, plain))
        pix[name] = [m["dct"].dequant_idct(*a) for a in idct_args]
        n_off = sum(int((g != w).sum()) for g, w in zip(pix[name], pix_plain))
        worst = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                    for g, w in zip(pix[name], pix_plain))
        print(f"{name}: B2 {off} coefficients off the plain version; B5 "
              f"{n_off} pixels off the plain version (max {worst})",
              flush=True)
        cs.require(off == 0, f"{name}: B2 differs from the plain version")
    same = all(map(torch.equal, pix["other"], pix["this"]))
    print(f"B5 of both trees bitwise equal: {same}", flush=True)
    cs.require(same, "B5 differs between the trees")

    # B4 / B22: the API-0 JPEG/Rs of the batch (base and gain map lanes).
    blobs = batched.batched_encode_api0(y_np, uv_np, gamut, tf, 95,
                                        device=dev)
    b4_in = cs._b4_inputs(batched.decode_host_stage(blobs), dev)

    def b4(m, mode="dense"):
        return [g for ln, a in b4_in
                for g in m["device_decode"].decode_rst_chunks(
                    *a, ln.gray, ln.sampling, ln.mcus_x, ln.mcus_y,
                    emit_mode=mode)]

    # B12-dec: one restart-less 4000x3000 4:2:0 JPEG (lanes host-scanned,
    # DC carried across them).
    gy, guv = cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 50)
    jpeg = codec.encode_jpeg(cs._yuv_variants(gy[0], guv[0])["4:2:0"][0], 90,
                             device=dev)
    ds, (src, fr, lanes, tabs, qd) = cs._b12_inputs(
        dd.parse_device_stream(jpeg), dev)
    shapes = dd.plane_shapes(ds.gray, ds.sampling, ds.mcus_x, ds.mcus_y)

    def b12(m):
        grids = m["device_decode"].decode_rst_chunks(
            src, fr, lanes, tabs, ds.gray, ds.sampling, ds.mcus_x,
            ds.mcus_y, emit_mode="dense")
        return [m["dct"].dequant_idct(g, qd[k:k + 1], bh, bw)
                for k, (g, (bh, bw)) in enumerate(zip(grids, shapes))]

    # B19: the general route's base (4:2:0) and gain map at 4000x3000.
    ry, ruv = cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 90)
    yd, uvd = jpegr.upload_frame(ry[0], ruv[0], None, dev)
    gen = jpegr.general_device_stage(yd, uvd, None, "bt2100", "bt2100",
                                     "hlg", 95)
    yz, uz, vz = gen.base.coefs
    (gz,) = gen.gainmap.coefs
    mx, my = cs._mcus(gen.base)

    def b19(m):
        de = m["device_entropy"]
        return (de.encode_ycbcr_stream(yz, uz, vz, mx, my)
                + de.encode_gray_stream(gz))

    # B3: B2's coefficients of the batch, base and gain map, r = 4.
    r = batched.RST_INTERVAL
    coefs = batched.encode_coefs_stage(y, uv, gamut, tf, 95)

    def b3(m):
        de = m["device_entropy"]
        return (de.encode_ycbcr_rst_stream(*coefs[:3], cs.W // 16,
                                           cs.H // 16, r)
                + de.encode_gray_rst_stream(coefs[3], r))

    # B12-enc: encode_jpeg's 4:2:0 coefficients at 4000x3000, r = 4.
    ey, euv = cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 95)
    ec = codec.jpeg_coefs(cs._yuv_variants(ey[0], euv[0])["4:2:0"][0], 90,
                          device=dev)
    ex, ey_ = cs._mcus(ec)

    def b12e(m):
        return m["device_entropy"].encode_ycbcr_rst_stream(
            *ec.coefs, ex, ey_, 4, (2, 2))

    # B6 / B11: B5's pixels of the batch and its gain map.
    y8, u8, v8 = pix["this"][:3]
    g8 = pix["this"][3][:, :cs.H // 4, :cs.W // 4]
    apply_args = {}
    for fmt, (g_, t_) in (("hdr_linear", cs.CONFIGS[0]),
                          ("hdr_hlg", cs.CONFIGS[0]),
                          ("hdr_pq", cs.CONFIGS[1]),
                          ("hdr_linear_rgb_10bit", cs.CONFIGS[0])):
        sc = torch.from_numpy(np.stack([batched.apply_scalars(
            batched.api0_metadata(t_), math.inf)] * frames)).to(dev)
        apply_args[fmt] = (y8, u8, v8, g8, sc, fmt)

    def b6(m, fmt, luts=False):
        return [m["gainmap"].apply_gainmap(*apply_args[fmt], luts)]

    # B1 (HLG and PQ) and B9 (API-1, HLG) on the batch; B10b (the
    # general route's API-0 gain map) on one 4000x3000 frame.
    sg, hg, tf1 = cs.API1_CONFIGS[0]
    api1 = [y, uv] + [torch.from_numpy(p).to(dev)
                      for p in cs.sdr_rendition(y_np, uv_np, sg, dev)]
    ty, tuv = (batched.p010_to_device(a, dev)
               for a in cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 40))
    tm = gm.tonemap_p010(ty, tuv)

    def b1(m, cfg):
        return list(m["gainmap"].encode_front(y, uv, *cfg))

    def b9(m):
        return list(m["gainmap"].encode_front_api1(*api1, sg, hg, tf1))

    def b10b(m):
        return [m["gainmap"].generate_gainmap(
            *tm, ty, tuv, sdr_gamut="bt2100", hdr_gamut="bt2100",
            hdr_tf="hlg")[0]]

    fronts = {"B1 HLG": lambda m: b1(m, cs.CONFIGS[0]),
              "B1 PQ": lambda m: b1(m, cs.CONFIGS[1]),
              "B9": b9, "B10b": b10b}

    applies = {"B6 F16": lambda m: b6(m, "hdr_linear"),
               "B6 HLG": lambda m: b6(m, "hdr_hlg"),
               "B6 PQ": lambda m: b6(m, "hdr_pq"),
               "B6r": lambda m: b6(m, "hdr_linear_rgb_10bit"),
               "B11 HLG": lambda m: b6(m, "hdr_hlg", True)}

    for what, fn in (("B4", b4), ("B22", lambda m: b4(m, "log")),
                     ("B12-dec", b12), ("B19", b19), ("B3", b3),
                     ("B12-enc", b12e), *applies.items(),
                     *fronts.items()):
        a, b = fn(trees["other"]), fn(trees["this"])
        same = len(a) == len(b) and all(map(torch.equal, a, b))
        print(f"{what} of both trees bitwise equal: {same}", flush=True)
        cs.require(same, f"{what} differs between the trees")

    def b20(m):
        g, yb, ub, vb = m["gainmap"].encode_front(y, uv, gamut, tf)
        return [m["dct"].fdct_quant(p, q) for p, q in
                ((yb, qs[0]), (ub, qs[1]), (vb, qs[1]), (g, qs[2]))]

    times = {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        m = trees[name]
        b2 = lambda: [m["dct"].fdct_quant(p, q)  # noqa: E731
                      for p, q in planes]
        b5 = lambda: [m["dct"].dequant_idct(*a)  # noqa: E731
                      for a in idct_args]
        t = dict(B2_graph=cs.graph_ms(b2, 20) / frames,
                 B2_events=cs.cuda_ms(b2, 20) / frames,
                 B5_graph=cs.graph_ms(b5, 20) / frames,
                 B5_events=cs.cuda_ms(b5, 20) / frames,
                 B20_graph=cs.graph_ms(lambda: b20(m), 10) / frames,
                 B4_graph=cs.graph_ms(lambda: b4(m), 10) / frames,
                 B4_events=cs.cuda_ms(lambda: b4(m), 10) / frames,
                 B22_graph=cs.graph_ms(lambda: b4(m, "log"), 10) / frames,
                 B22_events=cs.cuda_ms(lambda: b4(m, "log"), 10) / frames,
                 B12dec_graph=cs.graph_ms(lambda: b12(m), 10),
                 B12dec_events=cs.cuda_ms(lambda: b12(m), 10),
                 B19_events=cs.cuda_ms(lambda: b19(m), 10),
                 B3_events=cs.cuda_ms(lambda: b3(m), 10) / frames,
                 B12enc_events=cs.cuda_ms(lambda: b12e(m), 10))
        for what, fn in applies.items():
            t[what.replace(" ", "_") + "_graph"] = cs.graph_ms(
                lambda fn=fn: fn(m), 10) / frames
        for what, fn in fronts.items():
            per = 1 if what == "B10b" else frames
            key = what.replace(" ", "_")
            t[key + "_events"] = cs.cuda_ms(lambda fn=fn: fn(m), 20) / per
            t[key + "_graph"] = cs.graph_ms(lambda fn=fn: fn(m), 20) / per
        print(f"turn {turn} {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms/frame ({smi})",
            flush=True)
        times.setdefault(name, []).append(t)
    by_kernel = {}
    for name, m in trees.items():
        for what, fn, per in (("B4", lambda: b4(m), frames),
                              ("B22", lambda: b4(m, "log"), frames),
                              ("B12-dec", lambda: b12(m), 1),
                              ("B19", lambda: b19(m), 1),
                              ("B3", lambda: b3(m), frames),
                              ("B12-enc", lambda: b12e(m), 1),
                              ("B6 F16", lambda: b6(m, "hdr_linear"), frames),
                              ("B6 PQ", lambda: b6(m, "hdr_pq"), frames),
                              ("B11 HLG", lambda: b6(m, "hdr_hlg", True),
                               frames),
                              ("B1 HLG", lambda: b1(m, cs.CONFIGS[0]),
                               frames),
                              ("B1 PQ", lambda: b1(m, cs.CONFIGS[1]),
                               frames)):
            by = {k: v / per
                  for k, v in cs.device_ms_by_kernel(fn, 10).items()}
            by_kernel.setdefault(name, {})[what] = by
            print(f"{name} {what}: device ms/frame by kernel "
                  f"{ {k: round(v, 4) for k, v in by.items()} } ({smi})",
                  flush=True)
    planes, arms, _ = rice_inputs(cs, dev)
    packs = rice_checks(cs, trees, dev, arms)
    for ts, by in (rice_timing(cs, trees, dev, smi, arms, packs),
                   pack_timing(cs, trees, dev, smi, planes, arms)):
        for name, runs in ts.items():
            for t, r in zip(times[name], runs):
                t.update(r)
        for name, b in by.items():
            by_kernel[name].update(b)
    for name, ts in sdr_edit_timing(cs, trees, dev, smi).items():
        for t, r in zip(times[name], ts):
            t.update(r)
    print(json.dumps({"device": smi, "times": times,
                      "by_kernel": by_kernel}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
