"""Whether what the timed path produced is correct.

Every number here compares an output of the program with the plain
reference (portbench/reference), which works out again, from the
inputs alone, what the program derived from them. Each number has its
limit; a run is correct when no request failed and every number is
within its limit. PERF.md gives the readings each limit was set from:
the program's sound runs below it, the control (the reference computed
in bfloat16 in the program's place) above it.

Each entry (portbench/entries/) judges its outputs with the numbers of
its kind below and holds them to its ``limits``.

An API-0 JPEG/R of a P010 frame, per judged frame:
- ``faults``: what the file gets wrong outright: its MPF index, the gain
  map's XMP metadata, the primary's container directory, its ICC
  colorants, the frame size, sampling and quant tables of both images,
  the restart markers, the Huffman codes, the stuffing. Limit 0.
- ``base_coef_off`` / ``map_coef_off``: the share of the base image's
  (luma and chroma) and of the gain map's quantized coefficients, as
  the file's Huffman streams hold them, that differ from the
  reference's: the gain map, the re-encode, the fDCT and the
  quantization together.

A JPEG/R decoded to RGBA1010102 words, per judged frame:
- ``faults``: pixel arrays of the wrong shape, alpha other than 3.
  Limit 0.
- ``px_off``: the share of the 10-bit R, G and B codes more than one
  code from the reference's: the Huffman decode, the IDCT, the gain-map
  apply, the transfer function and the pack together.

The judged frames are the worst case: a run reports the largest share
over them and the sum of their faults.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import codec, jpeg, writer

# The limits of an API-0 JPEG/R written by the program, and of
# RGBA1010102 words decoded by it (PERF.md gives their readings).
FILE_LIMITS = {"faults": 0, "base_coef_off": 1e-3, "map_coef_off": 1e-3}
WORDS_LIMITS = {"faults": 0, "px_off": 1e-3}

def _gainmap_xmp_faults(attrs: dict, log2_max: float) -> list[str]:
    want = {"hdrgm:GainMapMin": 0.0, "hdrgm:GainMapMax": log2_max,
            "hdrgm:Gamma": 1.0, "hdrgm:OffsetSDR": 0.0,
            "hdrgm:OffsetHDR": 0.0, "hdrgm:HDRCapacityMin": 0.0,
            "hdrgm:HDRCapacityMax": log2_max}
    faults = []
    if attrs.get("hdrgm:Version") != "1.0":
        faults.append("gain map XMP: no hdrgm:Version 1.0")
    for k, v in want.items():
        try:
            ok = abs(float(attrs[k]) - v) <= 1e-5
        except (KeyError, ValueError):
            ok = False
        if not ok:
            faults.append(f"gain map XMP {k} = {attrs.get(k)}, want {v:.6f}")
    return faults


def _image_faults(j: jpeg.Jpeg, w: int, h: int, sampling, tables) -> list:
    faults = []
    if (j.width, j.height) != (w, h):
        faults.append(f"image {j.width}x{j.height}, want {w}x{h}")
    if [(c[1], c[2]) for c in j.comps] != list(sampling):
        faults.append(f"sampling {[(c[1], c[2]) for c in j.comps]}")
        return faults
    for c, want in zip(j.comps, tables):
        if c[3] not in j.qt or not np.array_equal(j.qt[c[3]], want):
            faults.append(f"component {c[0]}: quant table differs from "
                          f"the configuration's quality")
    return faults


def encode_faults(cfg: dict, blob: bytes):
    """(faults, base coefficients (Y, U, V), gain-map coefficients) of
    one JPEG/R the program wrote; coefficients None where unreadable."""
    w, h = cfg["width"], cfg["height"]
    r = jpeg.split_jpegr(blob)
    faults = list(r.faults)
    log2_max = math.log2(codec.PEAK_NITS[cfg["transfer"]]
                         / codec.SDR_WHITE_NITS)
    faults += _gainmap_xmp_faults(jpeg.xmp_attributes(r.gainmap_xmp),
                                  log2_max)
    pattrs = jpeg.xmp_attributes(r.primary_xmp)
    if pattrs.get("hdrgm:Version") != "1.0":
        faults.append("primary XMP: no hdrgm:Version 1.0")
    if str(len(r.gainmap)) not in (r.primary_xmp or b"").decode(
            errors="replace"):
        faults.append("primary XMP: no item of the gain map's length")
    col = jpeg.icc_colorants(r.icc)
    if col is None:
        faults.append("no ICC profile with colorants")
    elif np.abs(col - writer.gamut_colorants(cfg["gamut"])).max() > 2e-3:
        faults.append("ICC colorants are not the configuration's gamut")
    ql = codec.quant_table(codec.STD_LUMA, cfg["quality"])
    qc = codec.quant_table(codec.STD_CHROMA, cfg["quality"])
    qg = codec.quant_table(codec.STD_LUMA, cfg["gainmap_quality"])
    base, gm = jpeg.parse_jpeg(r.primary), jpeg.parse_jpeg(r.gainmap)
    faults += _image_faults(base, w, h, ((2, 2), (1, 1), (1, 1)),
                            (ql, qc, qc))
    faults += _image_faults(gm, w // 4, h // 4, ((1, 1),), (qg,))
    bc = jpeg.decode_coefficients(base) if not faults else None
    gc = jpeg.decode_coefficients(gm) if not faults else None
    faults += [f"base: {f}" for f in base.faults]
    faults += [f"gain map: {f}" for f in gm.faults]
    return faults, bc, gc


def expected_coefficients(cfg: dict, y16: np.ndarray, uv16: np.ndarray,
                          device, dtype=torch.float32):
    """The reference's (Y, U, V) and gain-map quantized coefficients of
    one P010 frame, as (bh, bw, 64) int32 numpy arrays in zigzag
    order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    y = torch.from_numpy(y16.astype(np.int32)).to(device)
    uv = torch.from_numpy(uv16.astype(np.int32)).to(device)
    gmap, y8, u8, v8 = codec.encode_front(y, uv, cfg["gamut"],
                                          cfg["transfer"], dtype)
    ql = codec.quant_table(codec.STD_LUMA, cfg["quality"])
    qc = codec.quant_table(codec.STD_CHROMA, cfg["quality"])
    qg = codec.quant_table(codec.STD_LUMA, cfg["gainmap_quality"])
    base = [codec.fdct_quant(p, q, dtype).cpu().numpy()
            for p, q in ((y8, ql), (u8, qc), (v8, qc))]
    return base, codec.fdct_quant(gmap, qg, dtype).cpu().numpy()


def _off(got: list, want: list) -> float:
    n = sum(w.size for w in want)
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return 1.0
    return sum(int(np.count_nonzero(g != w)) for g, w in zip(got, want)) / n


def encode_numbers(cfg: dict, blob: bytes, y16, uv16, device) -> dict:
    faults, bc, gc = encode_faults(cfg, blob)
    want_b, want_g = expected_coefficients(cfg, y16, uv16, device)
    return {"faults": len(faults), "fault_list": faults,
            "base_coef_off": 1.0 if bc is None else _off(bc, want_b),
            "map_coef_off": 1.0 if gc is None else _off(gc, [want_g])}


def control_encode_numbers(cfg: dict, y16, uv16, device,
                           dtype=torch.bfloat16) -> dict:
    """The numbers the reference computed in `dtype` reads when it stands
    in the program's place."""
    got_b, got_g = expected_coefficients(cfg, y16, uv16, device, dtype)
    want_b, want_g = expected_coefficients(cfg, y16, uv16, device)
    return {"faults": 0, "fault_list": [],
            "base_coef_off": _off(got_b, want_b),
            "map_coef_off": _off([got_g], [want_g])}


def expected_pixels(cfg: dict, blob: bytes, device, dtype=torch.float32):
    """(faults, the reference's (h, w) int64 RGBA1010102 words of one
    JPEG/R input), decoded from the file alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = jpeg.split_jpegr(blob)
    attrs = jpeg.xmp_attributes(r.gainmap_xmp)
    faults = list(r.faults)
    try:
        log2_min = float(attrs["hdrgm:GainMapMin"])
        log2_max = float(attrs["hdrgm:GainMapMax"])
    except (KeyError, ValueError):
        return faults + ["input gain map has no metadata"], None
    base, gm = jpeg.parse_jpeg(r.primary), jpeg.parse_jpeg(r.gainmap)
    bc, gc = jpeg.decode_coefficients(base), jpeg.decode_coefficients(gm)
    faults += base.faults + gm.faults
    if bc is None or gc is None:
        return faults, None
    w, h = base.width, base.height
    sizes = ((h, w), (-(-h // 2), -(-w // 2)), (-(-h // 2), -(-w // 2)))
    y8, u8, v8 = (codec.idct(g, base.qt[c[3]], ph, pw, device, dtype)
                  for g, c, (ph, pw) in zip(bc, base.comps, sizes))
    g8 = codec.idct(gc[0], gm.qt[gm.comps[0][3]], gm.height, gm.width,
                    device, dtype)
    # The API's display boost is unbounded by default: the content's.
    return faults, codec.apply_gainmap(y8, u8, v8, g8, log2_min, log2_max,
                                       2.0 ** log2_max, cfg["transfer"],
                                       dtype)


def pixel_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Faults and px_off of program words `got` against `want`."""
    if tuple(got.shape) != tuple(want.shape):
        return {"faults": 1, "fault_list": [
            f"pixels {tuple(got.shape)}, want {tuple(want.shape)}"],
            "px_off": 1.0, "max_code_diff": None}
    g = got.to(want.device, torch.int64) & 0xFFFFFFFF
    alpha = int(torch.count_nonzero((g >> 30) != 3))
    off, worst = 0, 0
    for s in (0, 10, 20):
        d = (((g >> s) & 1023) - ((want >> s) & 1023)).abs()
        off += int(torch.count_nonzero(d > 1))
        worst = max(worst, int(d.max()))
    faults = [f"alpha not 3 on {alpha} pixels"] if alpha else []
    return {"faults": len(faults), "fault_list": faults,
            "px_off": off / (3 * want.numel()), "max_code_diff": worst}


def to_tensor(pixels) -> torch.Tensor:
    """A program's pixel output (numpy uint32 or an int32 tensor)."""
    if isinstance(pixels, np.ndarray):
        return torch.from_numpy(pixels.view(np.int32))
    return pixels


def worst(rows: list[dict], names) -> dict:
    """Faults summed and shares maximized over judged frames."""
    out = {}
    for k in names:
        vals = [r[k] for r in rows if r.get(k) is not None]
        out[k] = (sum(vals) if k == "faults" else max(vals)) if vals else 0
    return out


def verdict(limits: dict, numbers: dict) -> tuple[bool, dict]:
    """(whether every number is within its limit, name -> (value,
    limit))."""
    checks = {k: (numbers[k], limits[k]) for k in limits}
    return all(v <= lim for v, lim in checks.values()), checks


def file_numbers(entry, frame: int, blob: bytes) -> dict:
    """An entry's JPEG/R of pool frame `frame` against the reference."""
    y, uv = entry.inputs
    return encode_numbers(entry.cfg, blob, y[frame], uv[frame], entry.device)


def file_control(entry, frame: int) -> dict:
    y, uv = entry.inputs
    return control_encode_numbers(entry.cfg, y[frame], uv[frame],
                                  entry.device)


def words_numbers(entry, frame: int, pixels) -> dict:
    """An entry's RGBA1010102 words of the JPEG/R `entry.inputs[frame]`
    against the reference's decode of that file, which is kept on the
    entry for the frame's next output."""
    cache = entry.__dict__.setdefault("_reference_words", {})
    if frame not in cache:
        cache[frame] = expected_pixels(entry.cfg, entry.inputs[frame],
                                       entry.device)
    faults, want = cache[frame]
    if want is None:
        return {"faults": len(faults) or 1, "fault_list": faults,
                "px_off": 1.0}
    row = pixel_numbers(to_tensor(pixels), want)
    row["faults"] += len(faults)
    row["fault_list"] = faults + row["fault_list"]
    return row


def words_control(entry, frame: int) -> dict:
    blob = entry.inputs[frame]
    _, want = expected_pixels(entry.cfg, blob, entry.device)
    _, got = expected_pixels(entry.cfg, blob, entry.device, torch.bfloat16)
    return pixel_numbers(got, want)
