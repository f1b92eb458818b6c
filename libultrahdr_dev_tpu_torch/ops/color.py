"""Color science for the gain-map codec, as plain PyTorch.

The port of libultrahdr_dev_tpu/ops/color.py: the transfer functions
and their tables, luminance weights, YUV<->RGB and gamut matrices, the
u8 gain code and the output packs of the reference's gainmapmath
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

from ..device import resolve_device

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


def _first_vector_math_call():
    """On the CPU, torch computes sqrt, log, exp and log2 of float
    tensors with MKL's vector math (VML), which sets itself up on its
    first call. When that first call is an OpenMP parallel region (a
    tensor of more than 2,048 elements), a worker thread can run its
    chunk before the setup is done and return results good to about
    12 bits: torch.sqrt of 20,000 floats, the first VML call of a fresh
    process, came back up to 3,930 ULP off on one thread's 2,500
    elements in 4 of 240 processes on an 8-core host under load, and in
    none of 880 processes that first made one single-element call. This
    is that call, made once, on the importing thread."""
    torch.exp(torch.ones(1))


_first_vector_math_call()


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


def dot2(m0: float, x0, m1: float, x1):
    """m0*x0 + m1*x1 rounded as XLA on the CPU rounds it: one product
    fused into a multiply-add, the other rounded first. Which one
    depends on the signs of the constants: XLA rewrites a sum whose
    first term has a negative constant as a difference (x1*m1 -
    x0*|m0|) and then fuses the first operand of the sum."""
    if m0 < 0 and m1 >= 0:
        return fma(m1, x1, _f32(m0) * x0)
    return fma(m0, x0, _f32(m1) * x1)


def dot3(m, xs):
    """m[0]*x0 + m[1]*x1 + m[2]*x2 with XLA's CPU rounding: dot2 of the
    first two terms, then the third fused."""
    return fma(m[2], xs[2], dot2(m[0], xs[0], m[1], xs[1]))


def luminance(coeffs, rgb):
    """kr*r + kg*g + kb*b, fused as fma(kb, b, fma(kr, r, kg*g))."""
    return dot3(coeffs, rgb)


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
# Gamut conversions on linear RGB (gainmapmath.cpp:359-393).
# ---------------------------------------------------------------------------

BT709_TO_P3 = ((0.82254, 0.17755, 0.00006),
               (0.03312, 0.96684, -0.00001),
               (0.01706, 0.07240, 0.91049))
BT709_TO_BT2100 = ((0.62740, 0.32930, 0.04332),
                   (0.06904, 0.91958, 0.01138),
                   (0.01636, 0.08799, 0.89555))
P3_TO_BT709 = ((1.22482, -0.22490, -0.00007),
               (-0.04196, 1.04199, 0.00001),
               (-0.01961, -0.07865, 1.09831))
P3_TO_BT2100 = ((0.75378, 0.19862, 0.04754),
                (0.04576, 0.94177, 0.01250),
                (-0.00121, 0.01757, 0.98359))
BT2100_TO_BT709 = ((1.66045, -0.58764, -0.07286),
                   (-0.12445, 1.13282, -0.00837),
                   (-0.01811, -0.10057, 1.11878))
BT2100_TO_P3 = ((1.34369, -0.28223, -0.06135),
                (-0.06533, 1.07580, -0.01051),
                (0.00283, -0.01957, 1.01679))

# (SDR gamut, HDR gamut) -> the matrix taking linear HDR RGB into the
# SDR gamut.
_GAMUT_CONVERSIONS = {
    ("bt709", "p3"): P3_TO_BT709,
    ("bt709", "bt2100"): BT2100_TO_BT709,
    ("p3", "bt709"): BT709_TO_P3,
    ("p3", "bt2100"): BT2100_TO_P3,
    ("bt2100", "bt709"): BT709_TO_BT2100,
    ("bt2100", "p3"): P3_TO_BT2100,
}


def hdr_gamut_conversion_matrix(sdr_gamut: str, hdr_gamut: str):
    """Matrix converting linear HDR RGB into the SDR gamut, or None for
    identity (gainmapmath.cpp:397-440 getHdrConversionFn)."""
    if sdr_gamut == hdr_gamut:
        return None
    return _GAMUT_CONVERSIONS[(sdr_gamut, hdr_gamut)]


def apply_matrix3(m, rgb):
    """y_i = sum_j m[i][j] * x_j, elementwise, rounded as XLA on the CPU
    rounds it (dot3)."""
    return tuple(dot3(m[i], rgb) for i in range(3))


# ---------------------------------------------------------------------------
# Table variants of the transfer functions (gainmapmath.cpp:21-64):
# index = trunc(x * (n - 1) + 0.5), clamped to the table. The tables are
# built in numpy float32 exactly as the JAX package builds them, so both
# packages index identical tables.
# ---------------------------------------------------------------------------

SRGB_INV_OETF_NUM_ENTRIES = 1 << 10
HLG_OETF_NUM_ENTRIES = 1 << 16
HLG_INV_OETF_NUM_ENTRIES = 1 << 12
PQ_OETF_NUM_ENTRIES = 1 << 16
PQ_INV_OETF_NUM_ENTRIES = 1 << 12
GAIN_FACTOR_NUM_ENTRIES = 1 << 10


def _np_srgb_inv_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / np.float32(12.92),
                    ((x + np.float32(0.055)) / np.float32(1.055))
                    ** np.float32(2.4)).astype(np.float32)


def _np_hlg_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 1.0 / 12.0, np.sqrt(np.maximum(3.0 * x, 0.0)),
                    _HLG_A * np.log(np.maximum(12.0 * x - _HLG_B, 1e-12))
                    + _HLG_C).astype(np.float32)


def _np_hlg_inv_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.5, x * x / 3.0,
                    (np.exp((x - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
                    ).astype(np.float32)


def _np_pq_oetf(x):
    x = np.asarray(x, np.float32)
    ep = np.maximum(x, 0.0) ** _PQ_M1
    out = ((_PQ_C1 + _PQ_C2 * ep) / (1.0 + _PQ_C3 * ep)) ** _PQ_M2
    return np.where(x <= 0.0, 0.0, out).astype(np.float32)


def _np_pq_inv_oetf(x):
    x = np.asarray(x, np.float32)
    ef = np.maximum(x, 1e-5) ** _PQ_INV_F
    out = np.maximum((_PQ_INV_A * ef - _PQ_INV_B)
                     / (_PQ_INV_C - _PQ_INV_D * ef), 0.0) ** _PQ_INV_E
    return np.where(x <= 0.0001, 0.0, out).astype(np.float32)


# name -> (numpy builder, entries)
LUT_SPECS = {
    "srgb_inv": (_np_srgb_inv_oetf, SRGB_INV_OETF_NUM_ENTRIES),
    "hlg_oetf": (_np_hlg_oetf, HLG_OETF_NUM_ENTRIES),
    "hlg_inv": (_np_hlg_inv_oetf, HLG_INV_OETF_NUM_ENTRIES),
    "pq_oetf": (_np_pq_oetf, PQ_OETF_NUM_ENTRIES),
    "pq_inv": (_np_pq_inv_oetf, PQ_INV_OETF_NUM_ENTRIES),
}
_LUTS: dict = {}         # name -> numpy float32 table, built once
_DEVICE_LUTS: dict = {}  # (name, device) -> the table on that device


def lut_table(name: str) -> np.ndarray:
    """The float32 table `name`, built once per process."""
    if name not in _LUTS:
        np_fn, n = LUT_SPECS[name]
        xs = np.arange(n, dtype=np.float32) / np.float32(n - 1)
        _LUTS[name] = np.asarray(np_fn(xs), np.float32)
    return _LUTS[name]


def lut_tensor(name: str, device) -> torch.Tensor:
    """The table `name` on `device`, uploaded once per device (keyed by
    its index)."""
    dev = resolve_device(device)
    key = (name, dev)
    if key not in _DEVICE_LUTS:
        _DEVICE_LUTS[key] = torch.from_numpy(lut_table(name)).to(dev)
    return _DEVICE_LUTS[key]


def lut_index(x, n: int):
    """clamp(trunc(x * (n - 1) + 0.5), 0, n - 1), the multiply-add fused
    as XLA fuses it."""
    return torch.clamp(fma(x, float(n - 1), 0.5).to(torch.int32), 0, n - 1)


def _lut_lookup(name: str, x):
    table = lut_tensor(name, x.device)
    return table[lut_index(x, table.numel()).to(torch.int64)]


def srgb_inv_oetf_lut(x):
    return _lut_lookup("srgb_inv", x)


def hlg_oetf_lut(x):
    return _lut_lookup("hlg_oetf", x)


def hlg_inv_oetf_lut(x):
    return _lut_lookup("hlg_inv", x)


def pq_oetf_lut(x):
    return _lut_lookup("pq_oetf", x)


def pq_inv_oetf_lut(x):
    return _lut_lookup("pq_inv", x)


def gain_factor_lut(gain01, min_content_boost: float,
                    max_content_boost: float,
                    display_boost: float | None = None):
    """Table variant of the gain factor exp2(log boost), quantized as the
    reference's GainLUT (gainmapmath.h:149-182). No decode path of either
    package calls it."""
    n = GAIN_FACTOR_NUM_ENTRIES
    xs = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    log_boost = (math.log2(min_content_boost) * (1.0 - xs)
                 + math.log2(max_content_boost) * xs)
    if display_boost is not None:
        boost_factor = (display_boost / max_content_boost
                        if display_boost > 0 else 1.0)
        log_boost = log_boost * boost_factor
    table = torch.from_numpy(np.exp2(log_boost).astype(np.float32)).to(
        gain01.device)
    return table[lut_index(gain01, n).to(torch.int64)]


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
