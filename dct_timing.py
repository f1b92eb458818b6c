#!/usr/bin/env python3
"""B2 (fdct_quant) and B5 (dequant_idct) of this tree beside the same
kernels of another checkout, in one process on one NVIDIA GPU.

    git archive <commit> | tar -x -C _verify/other
    python3 dct_timing.py _verify/other

Both trees' kernels are built from their own sources (each into its own
git-ignored _build directory) and called through their own wrappers on
chip_smoke.py's inputs: B1's planes and gain map of the 4080x3072 batch
of 2 at quality 95 (B2), their coefficients (B5), and a 4000x3000 4:2:0
JPEG from encode_jpeg decoded by B4 then B5 (B12-dec). Checks: B2 of
both trees bitwise equal to the plain version; B5 of both trees bitwise
equal to each other, with their off-count against the plain version.
Times, ms per frame, in turns (other, this, this, other): B2 and B5 by
CUDA-graph replay and by CUDA events, B20 (B1 + B2) by CUDA graph, and
B12-dec (B4 + B5) by CUDA events, as chip_smoke.py times B12. Prints
the card's name and power limit and, last, one JSON object of the
times.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

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
    return importlib.import_module("uhdr_other.jpeg.dct")


def main(argv) -> int:
    import torch

    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libultrahdr_dev_tpu_torch.jpeg import codec, dct
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
    from libultrahdr_dev_tpu_torch.ops import gainmap as gm
    from libultrahdr_dev_tpu_torch.parallel import batched

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}\n{smi}", flush=True)
    trees = {"other": load_other(argv[1]), "this": dct}

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
        got = [m.fdct_quant(p, q) for p, q in planes]
        off = sum(int((g != w).sum()) for g, w in zip(got, plain))
        pix[name] = [m.dequant_idct(*a) for a in idct_args]
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

    gy, guv = cs.synth_p010(1, cs.GH, cs.GW, cs.SEED + 50)
    jpeg = codec.encode_jpeg(cs._yuv_variants(gy[0], guv[0])["4:2:0"][0], 90,
                             device=dev)
    ds, (src, fr, lanes, tabs, qd) = cs._b12_inputs(
        dd.parse_device_stream(jpeg), dev)
    shapes = dd.plane_shapes(ds.gray, ds.sampling, ds.mcus_x, ds.mcus_y)

    def b12(m):
        grids = dd.decode_rst_chunks(src, fr, lanes, tabs, ds.gray,
                                     ds.sampling, ds.mcus_x, ds.mcus_y,
                                     emit_mode="dense")
        return [m.dequant_idct(g, qd[k:k + 1], bh, bw)
                for k, (g, (bh, bw)) in enumerate(zip(grids, shapes))]

    def b20(m):
        g, yb, ub, vb = gm.encode_front(y, uv, gamut, tf)
        return [m.fdct_quant(p, q) for p, q in
                ((yb, qs[0]), (ub, qs[1]), (vb, qs[1]), (g, qs[2]))]

    times = {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        m = trees[name]
        b2 = lambda: [m.fdct_quant(p, q) for p, q in planes]  # noqa: E731
        b5 = lambda: [m.dequant_idct(*a) for a in idct_args]  # noqa: E731
        t = dict(B2_graph=cs.graph_ms(b2, 20) / frames,
                 B2_events=cs.cuda_ms(b2, 20) / frames,
                 B5_graph=cs.graph_ms(b5, 20) / frames,
                 B5_events=cs.cuda_ms(b5, 20) / frames,
                 B20_graph=cs.graph_ms(lambda: b20(m), 10) / frames,
                 B12dec_events=cs.cuda_ms(lambda: b12(m), 10))
        print(f"turn {turn} {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms/frame ({smi})",
            flush=True)
        times.setdefault(name, []).append(t)
    print(json.dumps({"device": smi, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
