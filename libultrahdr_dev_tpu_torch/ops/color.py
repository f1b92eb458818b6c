"""Color science for the gain-map codec, as plain PyTorch.

The port of libultrahdr_dev_tpu/ops/color.py: the transfer functions,
luminance weights, YUV<->RGB matrices, the u8 gain code and the output
packs of the reference's gainmapmath
(lib/src/gainmapmath.cpp:112-732). Every function works elementwise on
float32 tensors of any shape and on any device, in the same order of
operations and roundings as the JAX version (see ``fma``), so that the
plain versions of the kernels (ops/gainmap.py) agree with the JAX
package. The CUDA kernels repeat this arithmetic in kernels/csrc/*.cu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SDR_WHITE_NITS = 203.0
HLG_MAX_NITS = 1000.0
PQ_MAX_NITS = 10000.0

# Luminance (linear light) weights per gamut (gainmapmath.cpp:121,177,208).
SRGB_LUM = (0.2126, 0.7152, 0.0722)
P3_LUM = (0.20949, 0.72160, 0.06891)
BT2100_LUM = (0.2627, 0.6780, 0.0593)

# (luma coefficients, Cb scale, Cr scale) per YUV encoding
# (gainmapmath.cpp:129-254).
YUV_PARAMS = {
    "bt709": (SRGB_LUM, 1.8556, 1.5748),
    "bt601": ((0.299, 0.587, 0.114), 1.772, 1.402),
    "bt2100": (BT2100_LUM, 1.8814, 1.4746),
}
# Gamut -> the YUV encoding its SDR planes use (sRGB: 709, P3: 601).
GAMUT_YUV_PARAMS = {"bt709": "bt709", "p3": "bt601", "bt2100": "bt2100"}
LUMINANCE = {"bt709": SRGB_LUM, "p3": P3_LUM, "bt2100": BT2100_LUM}

_HLG_A = 0.17883277
_HLG_B = 0.28466892
_HLG_C = 0.55991073

_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0

_PQ_INV_A = 128.0
_PQ_INV_B = 107.0
_PQ_INV_C = 2413.0
_PQ_INV_D = 2392.0
_PQ_INV_E = 6.2773946361
_PQ_INV_F = 0.0126833


def clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


# The JAX reference as its tests run it (XLA on the CPU) rounds a few
# operations differently from PyTorch's eager ops: it fuses a multiply
# feeding an add into one fused multiply-add, turns a division by a
# constant into a multiplication by the constant's float32 reciprocal,
# and evaluates pow() correctly rounded. Power laws amplify those
# last-bit differences (the PQ OETF's outer power ~79x), so the plain
# versions reproduce all three; the CUDA kernels do the same with
# fmaf, the same reciprocals and a double pow().

def _f32(x: float) -> float:
    """A Python constant as the float32 value a float32 op sees."""
    return float(np.float32(x))


def recip(c: float) -> float:
    """float32 reciprocal of a constant divisor (1/c rounded once)."""
    return float(np.float32(1.0) / np.float32(c))


def _f64(v):
    return v.to(torch.float64) if torch.is_tensor(v) else _f32(v)


def fma(a, b, c):
    """a * b + c rounded once to float32 (the float32 product is exact
    in float64). Arguments are float32 tensors or Python constants."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def pow_rn(x, p: float):
    """float32 x ** p, correctly rounded in all but rare cases."""
    return torch.pow(x.to(torch.float64), _f32(p)).to(torch.float32)


def luminance(coeffs, rgb):
    """kr*r + kg*g + kb*b, fused as fma(kb, b, fma(kr, r, kg*g))."""
    r, g, b = rgb
    kr, kg, kb = coeffs
    return fma(kb, b, fma(kr, r, kg * g))


def luminance_fn(gamut: str):
    coeffs = LUMINANCE[gamut]
    return lambda rgb: luminance(coeffs, rgb)


def yuv_to_rgb(params, yuv):
    """Gamma-encoded YUV -> RGB, clamped (gainmapmath.cpp:129-254)."""
    (kr, kg, kb), cb, cr = params
    y, u, v = yuv
    gcb = kb * cb / kg
    gcr = kr * cr / kg
    r = clamp01(fma(cr, v, y))
    g = clamp01(fma(-gcr, v, fma(-gcb, u, y)))
    b = clamp01(fma(cb, u, y))
    return (r, g, b)


def yuv_to_rgb_fn(gamut: str):
    params = YUV_PARAMS[GAMUT_YUV_PARAMS[gamut]]
    return lambda yuv: yuv_to_rgb(params, yuv)


def p3_yuv_to_rgb(yuv):
    return yuv_to_rgb(YUV_PARAMS["bt601"], yuv)


# ---------------------------------------------------------------------------
# Transfer functions.
# ---------------------------------------------------------------------------

def srgb_inv_oetf(e):
    """sRGB gamma -> linear, IEC 61966-2-1 (gainmapmath.cpp:149-155)."""
    lo = e * recip(12.92)
    hi = pow_rn((e + 0.055) * recip(1.055), 2.4)
    return torch.where(e <= 0.04045, lo, hi)


def hlg_oetf(e):
    """Scene linear -> HLG signal, BT.2100-2 (gainmapmath.cpp:259-265)."""
    lo = torch.sqrt(torch.clamp(3.0 * e, min=0.0))
    hi = fma(_HLG_A, torch.log(torch.clamp(fma(12.0, e, -_HLG_B),
                                           min=1e-12)), _HLG_C)
    return torch.where(e <= 1.0 / 12.0, lo, hi)


def hlg_inv_oetf(e):
    """HLG signal -> scene linear, BT.2100-2 (gainmapmath.cpp:280-286)."""
    lo = (e * e) * recip(3.0)
    hi = (torch.exp((e - _HLG_C) * recip(_HLG_A)) + _HLG_B) * recip(12.0)
    return torch.where(e <= 0.5, lo, hi)


def pq_oetf(e):
    """Normalized linear -> PQ signal, BT.2100-2 (gainmapmath.cpp:309-312)."""
    ep = pow_rn(torch.clamp(e, min=0.0), _PQ_M1)
    out = pow_rn(fma(_PQ_C2, ep, _PQ_C1) / fma(_PQ_C3, ep, 1.0), _PQ_M2)
    return torch.where(e <= 0.0, torch.zeros_like(out), out)


def pq_inv_oetf(e):
    """PQ signal -> normalized linear, crushed to 0 below 1e-4
    (gainmapmath.cpp:330-338)."""
    ef = pow_rn(torch.clamp(e, min=1e-5), _PQ_INV_F)
    num = fma(_PQ_INV_A, ef, -_PQ_INV_B)
    den = fma(-_PQ_INV_D, ef, _PQ_INV_C)
    out = pow_rn(torch.clamp(num / den, min=0.0), _PQ_INV_E)
    return torch.where(e <= 0.0001, torch.zeros_like(out), out)


def identity(x):
    return x


def apply_channelwise(fn, rgb):
    return tuple(fn(c) for c in rgb)


def hdr_inv_oetf_fn(tf: str):
    """Inverse OETF + peak white nits of an HDR transfer function
    (ultrahdr.cpp:220-245)."""
    if tf == "linear":
        return identity, HLG_MAX_NITS
    if tf == "hlg":
        return hlg_inv_oetf, HLG_MAX_NITS
    if tf == "pq":
        return pq_inv_oetf, PQ_MAX_NITS
    raise ValueError(f"unsupported hdr transfer function: {tf}")


# YUV-encoding cross-conversions (gainmapmath.cpp:447-481), keyed by
# (source encoding, destination encoding).
_YUV_CONVERSIONS = {
    ("709", "601"): ((1.0, 0.101579, 0.196076),
                     (0.0, 0.989854, -0.110653),
                     (0.0, -0.072453, 0.983398)),
    ("709", "2100"): ((1.0, -0.016969, 0.096312),
                      (0.0, 0.995306, -0.051192),
                      (0.0, 0.011507, 1.002637)),
    ("601", "709"): ((1.0, -0.118188, -0.212685),
                     (0.0, 1.018640, 0.114618),
                     (0.0, 0.075049, 1.025327)),
    ("601", "2100"): ((1.0, -0.128245, -0.115879),
                      (0.0, 1.010016, 0.061592),
                      (0.0, 0.086969, 1.029350)),
    ("2100", "709"): ((1.0, 0.018149, -0.095132),
                      (0.0, 1.004123, 0.051267),
                      (0.0, -0.011524, 0.996782)),
    ("2100", "601"): ((1.0, 0.117887, 0.105521),
                      (0.0, 0.995211, -0.059549),
                      (0.0, -0.084085, 0.976518)),
}
GAMUT_YUV_ENCODING = {"bt709": "709", "p3": "601", "bt2100": "2100"}


def yuv_conversion_matrix(src_gamut: str, dst_gamut: str):
    """Matrix converting YUV signals between gamut encodings, or None if
    identity (jpegr.cpp:1132-1206 convertYuv dispatch)."""
    src = GAMUT_YUV_ENCODING[src_gamut]
    dst = GAMUT_YUV_ENCODING[dst_gamut]
    if src == dst:
        return None
    return _YUV_CONVERSIONS[(src, dst)]


# ---------------------------------------------------------------------------
# Gain computation (gainmapmath.cpp:524-560).
# ---------------------------------------------------------------------------

def gain_code_params(min_content_boost: float, max_content_boost: float):
    """The float32 constants of encode_gain and its two boundary codes.

    At the clamp boundaries the reference evaluates log2(gain) in double
    while log2MaxBoost was rounded to float32, so the saturated code is
    typically 254, not 255. The boundary codes are computed here in
    float64 and selected by mask. Returns (min_b, max_b, log2_min,
    denom, sat_code, floor_code)."""
    min_b = float(np.float32(min_content_boost))
    max_b = float(np.float32(max_content_boost))
    log2_min = float(np.float32(math.log2(min_b)))
    log2_max = float(np.float32(math.log2(max_b)))
    denom = log2_max - log2_min

    def boundary_code(boost: float) -> int:
        v = (math.log2(boost) - log2_min) / denom * 255.0
        return int(min(max(v, 0.0), 255.0))

    return (min_b, max_b, log2_min, denom, boundary_code(max_b),
            boundary_code(min_b))


def encode_gain(y_sdr_nits, y_hdr_nits, min_content_boost: float,
                max_content_boost: float):
    """Per-sample u8 gain code: quantized position of log2(hdr/sdr)
    within [log2(min_boost), log2(max_boost)] (gainmapmath.cpp:529-541),
    bit-exact with the reference at the clamp boundaries."""
    min_b, max_b, log2_min, denom, sat_code, floor_code = \
        gain_code_params(min_content_boost, max_content_boost)
    gain = torch.where(y_sdr_nits > 0.0,
                       y_hdr_nits / torch.clamp(y_sdr_nits, min=1e-30),
                       torch.ones_like(y_sdr_nits))
    scaled = (torch.log2(torch.clamp(gain, min_b, max_b)) - log2_min) \
        * recip(denom) * 255.0
    code = torch.clamp(scaled, 0.0, 255.0).to(torch.uint8)
    code = torch.where(gain >= max_b, torch.full_like(code, sat_code), code)
    return torch.where(gain <= min_b, torch.full_like(code, floor_code),
                       code)


# ---------------------------------------------------------------------------
# Pixel packing (gainmapmath.cpp:722-732).
# ---------------------------------------------------------------------------

RGBA1010102_ALPHA = -(1 << 30)  # 0xC0000000 as int32


def pack_rgba1010102(rgb):
    """Gamma-encoded RGB -> RGBA1010102 words, alpha=3, truncating like
    the reference. The words are int32 holding the uint32 bits."""
    r, g, b = (torch.clamp(c, 0.0, 1.0) * 1023.0 for c in rgb)
    ri, gi, bi = (c.to(torch.int32) & 0x3FF for c in (r, g, b))
    return ri | (gi << 10) | (bi << 20) | RGBA1010102_ALPHA


F16_ONE = int(np.float16(1.0).view(np.uint16))


def pack_rgba_f16(rgb):
    """Linear RGB -> (..., 4) RGBA half-float bits, alpha=1.0, round to
    nearest even. The halves are int16 holding the uint16 bits."""
    chans = [c.to(torch.float16).view(torch.int16) for c in rgb]
    chans.append(torch.full_like(chans[0], F16_ONE))
    return torch.stack(chans, dim=-1)
