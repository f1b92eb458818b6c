"""Plain reference of the JPEG/R work the timed path does, in PyTorch.

What an Ultra HDR API-0 encode must put in its file, and what a decode
to RGBA1010102 must give, written from the formulas of libultrahdr's
gainmapmath (lib/src/gainmapmath.cpp) and ITU-T T.81, with no kernel,
no cache and no batching, and nothing of the program under test
imported. Every elementwise step and every product runs in ``dtype``:
float32 for the reference (TF32 off), a lower precision for the
control that the judge must refuse.

- ``encode_front``: API-0's SDR rendition (the top 8 bits of each P010
  sample), its gain map against the HDR input, and the base re-encoded
  to the BT.601 YUV that a JPEG base carries.
- ``fdct_quant``: the 8x8 forward DCT of each plane, edge-padded to
  whole blocks, quantized (round half to even of c times 1 / q).
- ``idct``: dequantization and the 8x8 inverse DCT, rounded and
  clamped to 8 bits.
- ``apply_gainmap``: a decoded base and gain map to HLG or PQ
  RGBA1010102 words (gainmapmath.cpp applyGain, the map upsampled by
  Shepard's inverse-distance weights as gainmapmath.cpp:66-110).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SDR_WHITE_NITS = 203.0
PEAK_NITS = {"hlg": 1000.0, "pq": 10000.0}
MAP_SCALE = 4

# (luma weights, Cb scale, Cr scale) of each YUV encoding.
YUV = {"bt709": ((0.2126, 0.7152, 0.0722), 1.8556, 1.5748),
       "bt601": ((0.299, 0.587, 0.114), 1.772, 1.402),
       "bt2100": ((0.2627, 0.6780, 0.0593), 1.8814, 1.4746)}
# The YUV encoding and the luminance weights of each gamut.
GAMUT_YUV = {"bt709": "bt709", "p3": "bt601", "bt2100": "bt2100"}
LUMINANCE = {"bt709": (0.2126, 0.7152, 0.0722),
             "p3": (0.20949, 0.72160, 0.06891),
             "bt2100": (0.2627, 0.6780, 0.0593)}
# YUV re-encode to BT.601 (gainmapmath.cpp:447-481), by source gamut.
TO_601 = {"bt709": ((1.0, 0.101579, 0.196076), (0.0, 0.989854, -0.110653),
                    (0.0, -0.072453, 0.983398)),
          "bt2100": ((1.0, 0.117887, 0.105521), (0.0, 0.995211, -0.059549),
                     (0.0, -0.084085, 0.976518))}

HLG_A, HLG_B, HLG_C = 0.17883277, 0.28466892, 0.55991073
PQ_M1 = 2610.0 / 16384.0
PQ_M2 = 2523.0 / 4096.0 * 128.0
PQ_C1 = 3424.0 / 4096.0
PQ_C2 = 2413.0 / 4096.0 * 32.0
PQ_C3 = 2392.0 / 4096.0 * 32.0

# ITU-T T.81 Annex K.1, natural order.
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def quant_table(std: np.ndarray, quality: int) -> np.ndarray:
    """IJG scaling of a standard table to `quality`, natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((std * scale + 50) // 100, 1, 255).astype(np.int32)


def _dct_matrix(device, dtype) -> torch.Tensor:
    """Orthonormal 8-point DCT-II: F = D x."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.where(u == 0, math.sqrt(0.125), 0.5) * np.cos(
        (2 * x + 1) * u * np.pi / 16.0)
    return torch.tensor(d, dtype=dtype, device=device)


def _box_mean(x: torch.Tensor, f: int) -> torch.Tensor:
    h, w = x.shape
    return x[:h // f * f, :w // f * f].reshape(h // f, f, w // f, f).mean(
        dim=(1, 3))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1)


def _yuv_to_rgb(encoding: str, y, u, v):
    (kr, kg, kb), cb, cr = YUV[encoding]
    r = y + cr * v
    g = y - (kb * cb / kg) * u - (kr * cr / kg) * v
    b = y + cb * u
    return tuple(torch.clamp(c, 0.0, 1.0) for c in (r, g, b))


def _lum(gamut: str, rgb):
    kr, kg, kb = LUMINANCE[gamut]
    return kr * rgb[0] + kg * rgb[1] + kb * rgb[2]


def srgb_inv_oetf(e):
    return torch.where(e <= 0.04045, e / 12.92,
                       torch.pow((e + 0.055) / 1.055, 2.4))


def hlg_inv_oetf(e):
    return torch.where(e <= 0.5, e * e / 3.0,
                       (torch.exp((e - HLG_C) / HLG_A) + HLG_B) / 12.0)


def pq_inv_oetf(e):
    ef = torch.pow(torch.clamp(e, min=1e-5), 1.0 / PQ_M2)
    out = torch.pow(torch.clamp((ef - PQ_C1) / (PQ_C2 - PQ_C3 * ef),
                                min=0.0), 1.0 / PQ_M1)
    return torch.where(e <= 0.0001, torch.zeros_like(out), out)


def hlg_oetf(e):
    return torch.where(e <= 1.0 / 12.0,
                       torch.sqrt(torch.clamp(3.0 * e, min=0.0)),
                       HLG_A * torch.log(torch.clamp(12.0 * e - HLG_B,
                                                     min=1e-12)) + HLG_C)


def pq_oetf(e):
    ep = torch.pow(torch.clamp(e, min=0.0), PQ_M1)
    out = torch.pow((PQ_C1 + PQ_C2 * ep) / (1.0 + PQ_C3 * ep), PQ_M2)
    return torch.where(e <= 0.0, torch.zeros_like(out), out)


INV_OETF = {"hlg": hlg_inv_oetf, "pq": pq_inv_oetf}
OETF = {"hlg": hlg_oetf, "pq": pq_oetf}


def gain_codes(max_boost: float):
    """(log2 min, 1 / (log2 max - log2 min), the code of a gain at or
    above the max boost, the code at or below the min boost): the
    reference takes log2 of the boundary boosts in double against
    float32 log2 bounds (gainmapmath.cpp:529-541), so its top code is
    usually 254."""
    min_b, max_b = float(np.float32(1.0)), float(np.float32(max_boost))
    lo = float(np.float32(math.log2(min_b)))
    hi = float(np.float32(math.log2(max_b)))

    def code(boost):
        return int(min(max((math.log2(boost) - lo) / (hi - lo) * 255.0, 0.0),
                       255.0))

    return min_b, max_b, lo, 1.0 / (hi - lo), code(max_b), code(min_b)


def encode_front(y16: torch.Tensor, uv16: torch.Tensor, gamut: str,
                 tf: str, dtype=torch.float32):
    """API-0's front end on one frame: int32 P010 sample words y (h, w)
    and interleaved CbCr (h/2, w) -> (gain map (h/4, w/4), y (h, w),
    u, v (h/2, w/2)) uint8: the gain map of the SDR rendition (each
    sample's top 8 bits, read as `gamut`'s YUV with the sRGB transfer)
    against the HDR input, and that rendition re-encoded to BT.601."""
    y8, u8, v8 = y16 >> 8, uv16[:, 0::2] >> 8, uv16[:, 1::2] >> 8
    sy = y8.to(dtype) / 255.0
    su = (u8.to(dtype) - 128.0) / 255.0
    sv = (v8.to(dtype) - 128.0) / 255.0
    enc = GAMUT_YUV[gamut]
    sdr = _yuv_to_rgb(enc, _box_mean(sy, 4), _box_mean(su, 2),
                      _box_mean(sv, 2))
    sdr_nits = _lum(gamut, tuple(srgb_inv_oetf(c) for c in sdr)) \
        * SDR_WHITE_NITS
    hy = ((y16 >> 6).to(dtype) - 64.0) / 876.0
    c10 = (uv16 >> 6).to(dtype)
    hu = (c10[:, 0::2] - 64.0) / 896.0 - 0.5
    hv = (c10[:, 1::2] - 64.0) / 896.0 - 0.5
    hdr = _yuv_to_rgb(enc, _box_mean(hy, 4), _box_mean(hu, 2),
                      _box_mean(hv, 2))
    hdr_nits = _lum(gamut, tuple(INV_OETF[tf](c) for c in hdr)) \
        * PEAK_NITS[tf]
    min_b, max_b, lo, inv, top, bottom = gain_codes(
        PEAK_NITS[tf] / SDR_WHITE_NITS)
    gain = torch.where(sdr_nits > 0.0,
                       hdr_nits / torch.clamp(sdr_nits, min=1e-30),
                       torch.ones_like(sdr_nits))
    scaled = (torch.log2(torch.clamp(gain, min_b, max_b)) - lo) * inv * 255.0
    gmap = torch.clamp(scaled, 0.0, 255.0).to(torch.uint8)
    gmap = torch.where(gain >= max_b, torch.full_like(gmap, top), gmap)
    gmap = torch.where(gain <= min_b, torch.full_like(gmap, bottom), gmap)
    if enc == "bt601":
        return gmap, y8.to(torch.uint8), u8.to(torch.uint8), \
            v8.to(torch.uint8)
    m = TO_601[enc]
    yn = sy + _up2(m[0][1] * su + m[0][2] * sv)
    un = m[1][1] * su + m[1][2] * sv
    vn = m[2][1] * su + m[2][2] * sv

    def to_u8(x, bias):
        return torch.clamp(x * 255.0 + bias, 0, 255).to(torch.uint8)

    return gmap, to_u8(yn, 0.5), to_u8(un, 128.5), to_u8(vn, 128.5)


def fdct_quant(plane: torch.Tensor, q_natural: np.ndarray,
               dtype=torch.float32) -> torch.Tensor:
    """(h, w) uint8 -> (bh, bw, 64) int32 quantized coefficients in
    zigzag order, the plane edge-padded to whole blocks: each
    coefficient c times the float32 reciprocal of its q (the quantizer
    of the JAX package's constant tables), that product rounded to
    `dtype`, then half to even. At float32 the transform itself runs in
    float64, so that a coefficient that is exactly a multiple of 1/8 (a
    DC term) lands on its tie as the program's exact sums do."""
    h, w = plane.shape
    bh, bw = -(-h // 8), -(-w // 8)
    dev = plane.device
    wide = torch.float64 if dtype == torch.float32 else dtype
    rows = torch.clamp(torch.arange(bh * 8, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(bw * 8, device=dev), max=w - 1)
    x = plane.index_select(0, rows).index_select(1, cols).to(wide) - 128.0
    x = x.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3)
    d = _dct_matrix(dev, wide)
    c = torch.matmul(torch.matmul(d, x), d.T).reshape(bh, bw, 64)
    zz = torch.from_numpy(ZIGZAG).to(dev)
    recip = (np.float32(1.0) / q_natural.astype(np.float32))[ZIGZAG]
    v = (c[..., zz] * torch.from_numpy(recip).to(dev, wide)).to(dtype)
    return torch.round(v).to(torch.int32)


def idct(grid: np.ndarray, q_natural: np.ndarray, h: int, w: int, device,
         dtype=torch.float32) -> torch.Tensor:
    """(bh, bw, 64) zigzag coefficients -> the (h, w) uint8 plane."""
    bh, bw, _ = grid.shape
    zz = torch.from_numpy(ZIGZAG).to(device)
    coefs = torch.from_numpy(grid.astype(np.int32)).to(device)
    nat = torch.zeros((bh, bw, 64), dtype=dtype, device=device)
    nat[..., zz] = coefs.to(dtype)
    f = (nat * torch.from_numpy(q_natural).to(device, dtype)).reshape(
        bh, bw, 8, 8)
    d = _dct_matrix(device, dtype)
    pix = torch.matmul(torch.matmul(d.T, f), d) + 128.0
    pix = torch.clamp(torch.round(pix), 0, 255).to(torch.uint8)
    return pix.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:h, :w]


def _shepard(gmap: torch.Tensor, h: int, w: int, dtype):
    """The (mh, mw) map in [0, 1] upsampled to (h, w) by the weights of
    the four surrounding samples, 1 / distance, with the last row and
    column of the map as their own neighbours."""
    mh, mw = gmap.shape
    dev = gmap.device
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    my, mx = ys // MAP_SCALE, xs // MAP_SCALE
    my2 = torch.clamp(my + 1, max=mh - 1)
    mx2 = torch.clamp(mx + 1, max=mw - 1)

    def tap(r, c):
        return gmap.index_select(0, r).index_select(1, c)

    e1, e2, e3, e4 = tap(my, mx), tap(my2, mx), tap(my, mx2), tap(my2, mx2)
    px = ((xs % MAP_SCALE).to(dtype) / MAP_SCALE)[None, :]
    py = ((ys % MAP_SCALE).to(dtype) / MAP_SCALE)[:, None]
    dxr = px - torch.where(mx >= mw - 1, 0.0, 1.0).to(dtype)[None, :]
    dyb = py - torch.where(my >= mh - 1, 0.0, 1.0).to(dtype)[:, None]
    d1 = torch.sqrt(px * px + py * py)
    d2 = torch.sqrt(px * px + dyb * dyb)
    d3 = torch.sqrt(dxr * dxr + py * py)
    d4 = torch.sqrt(dxr * dxr + dyb * dyb)
    w1, w2, w3, w4 = (1.0 / torch.clamp(d, min=1e-12)
                      for d in (d1, d2, d3, d4))
    blend = (e1 * w1 + e2 * w2 + e3 * w3 + e4 * w4) / (w1 + w2 + w3 + w4)
    return torch.where(d1 <= 0.0, e1, blend)


def apply_gainmap(y8, u8, v8, gmap, log2_min: float, log2_max: float,
                  display_boost: float, tf: str, dtype=torch.float32):
    """A decoded base (uint8 Y (h, w), U and V (h/2, w/2), BT.601 YUV
    with the sRGB transfer) and gain map (h/4, w/4) -> (h, w) int64
    RGBA1010102 words (alpha 3) in the `tf` transfer (HLG or PQ),
    normalized to the display boost."""
    h, w = y8.shape
    y = y8.to(dtype) / 255.0
    u = _up2((u8.to(dtype) - 128.0) / 255.0)[:h, :w]
    v = _up2((v8.to(dtype) - 128.0) / 255.0)[:h, :w]
    rgb = tuple(srgb_inv_oetf(c) for c in _yuv_to_rgb("bt601", y, u, v))
    g = _shepard(gmap.to(dtype) / 255.0, h, w, dtype)
    boost_factor = display_boost / 2.0 ** log2_max
    factor = torch.exp2((log2_min * (1.0 - g) + log2_max * g)
                        * boost_factor) / display_boost
    codes = [(torch.clamp(OETF[tf](c * factor), 0.0, 1.0) * 1023.0)
             .to(torch.int64) for c in rgb]
    return codes[0] | (codes[1] << 10) | (codes[2] << 20) | (3 << 30)
