"""Gain-map generation and application: kernels B1 and B6.

``encode_front`` (B1) is the API-0 encode front end: the P010 -> u8
tonemap, the gain map, and the BT.601 re-encode of the base. It replaces
libultrahdr_dev_tpu/parallel/sharding.py:_gainmap_and_coefs (before the
fDCT) with _encode_one_image_coefs' tonemap. ``apply_gainmap`` (B6)
rebuilds HDR pixels from a decoded base and gain map; it replaces
libultrahdr_dev_tpu/ops/gainmap.py:_apply_kernel.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
its hand-written CUDA kernel (kernels/csrc/encode_front.cu, apply.cu)
for CUDA tensors, and counts its kernel launches in ``.launches``. The
plain versions follow the JAX programs operation by operation, rounding
as XLA does on the CPU (ops/color.py, ``fma``). Planes
travel as torch tensors: P010 samples as int16 holding the uint16 bits,
u8 planes as uint8, RGBA1010102 words as int32 holding the uint32 bits,
F16 pixels as (..., 4) int16 holding the half-float bits. All take a
leading batch dimension.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..types import MAP_DIMENSION_SCALE_FACTOR
from . import color

SCALE = MAP_DIMENSION_SCALE_FACTOR
TF_IDS = {"linear": 0, "hlg": 1, "pq": 2}
OUTPUT_FORMATS = {"hdr_linear": 0, "hdr_hlg": 1, "hdr_pq": 2}


# ---------------------------------------------------------------------------
# Plane normalization helpers (gainmapmath.cpp:562-601).
# ---------------------------------------------------------------------------

def p010_to_float(y_u16, uv_u16):
    """Narrow-range P010 planes (int32 sample values) -> normalized float
    (y, u, v); chroma stays at half resolution."""
    y10 = (y_u16 >> 6).to(torch.float32)
    uv10 = (uv_u16 >> 6).to(torch.float32)
    y = (y10 - 64.0) * (1.0 / 876.0)
    u = color.fma(uv10[..., 0::2] - 64.0, 1.0 / 896.0, -0.5)
    v = color.fma(uv10[..., 1::2] - 64.0, 1.0 / 896.0, -0.5)
    return y, u, v


def yuv420_to_float(y_u8, u_u8, v_u8):
    """JPEG-convention YUV420 planes -> normalized floats, 128-bias
    chroma."""
    y = y_u8.to(torch.float32) * (1.0 / 255.0)
    u = (u_u8.to(torch.float32) - 128.0) * (1.0 / 255.0)
    v = (v_u8.to(torch.float32) - 128.0) * (1.0 / 255.0)
    return y, u, v


def _box_mean(x, factor: int):
    """Mean over non-overlapping factor x factor blocks of (n, h, w)."""
    n, h, w = x.shape
    hh, ww = h // factor, w // factor
    x = x[:, :hh * factor, :ww * factor]
    s = x.reshape(n, hh, factor, ww, factor).sum(dim=(2, 4))
    return s * (1.0 / (factor * factor))


def _upsample2(x):
    """Nearest 2x upsample of (n, h, w) chroma."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _unsigned16(t):
    """int16 tensor holding uint16 bits -> int32 sample values."""
    return t.to(torch.int32) & 0xFFFF


# ---------------------------------------------------------------------------
# B1: API-0 encode front end.
# ---------------------------------------------------------------------------

def _check_p010(y_p010, uv_p010):
    n, h, w = y_p010.shape
    if h % 16 or w % 16:
        raise ValueError(f"encode front end needs 16-aligned dims, "
                         f"got {w}x{h}")
    if tuple(uv_p010.shape) != (n, h // 2, w):
        raise ValueError(f"uv plane shape {tuple(uv_p010.shape)} does not "
                         f"match y {tuple(y_p010.shape)}")
    return n, h, w


def encode_front_plain(y_p010, uv_p010, gamut: str, hdr_tf: str):
    """(n, h, w) / (n, h/2, w) int16 P010 planes (uint16 bits) ->
    (gain map (n, h/4, w/4), y (n, h, w), u, v (n, h/2, w/2)), all
    uint8: the gain map of the tonemapped SDR against the HDR input, and
    the tonemapped base re-encoded to BT.601 YUV."""
    _check_p010(y_p010, uv_p010)
    y = _unsigned16(y_p010)
    uv = _unsigned16(uv_p010)
    y8, u8, v8 = y >> 8, uv[..., 0::2] >> 8, uv[..., 1::2] >> 8

    hdr_inv_oetf, hdr_white = color.hdr_inv_oetf_fn(hdr_tf)
    luminance = color.luminance_fn(gamut)
    yuv_to_rgb = color.yuv_to_rgb_fn(gamut)
    max_boost = hdr_white / color.SDR_WHITE_NITS

    sy, su, sv = yuv420_to_float(y8, u8, v8)
    sy = _box_mean(sy, SCALE)
    su = _box_mean(su, SCALE // 2)
    sv = _box_mean(sv, SCALE // 2)
    sdr_rgb = color.apply_channelwise(color.srgb_inv_oetf,
                                      yuv_to_rgb((sy, su, sv)))
    sdr_nits = luminance(sdr_rgb) * color.SDR_WHITE_NITS
    hy, hu, hv = p010_to_float(y, uv)
    hy = _box_mean(hy, SCALE)
    hu = _box_mean(hu, SCALE // 2)
    hv = _box_mean(hv, SCALE // 2)
    hdr_rgb = color.apply_channelwise(hdr_inv_oetf,
                                      yuv_to_rgb((hy, hu, hv)))
    hdr_nits = luminance(hdr_rgb) * hdr_white
    gmap = color.encode_gain(sdr_nits, hdr_nits, 1.0, max_boost)

    m = color.yuv_conversion_matrix(gamut, "p3")
    if m is None:
        return (gmap, y8.to(torch.uint8), u8.to(torch.uint8),
                v8.to(torch.uint8))
    # transformYuv420: the luma shift comes from the shared chroma
    # sample, chroma from chroma alone (gainmap.py:428-448).
    yf, uf, vf = yuv420_to_float(y8, u8, v8)
    y_shift = color.fma(m[0][1], uf, m[0][2] * vf)
    y_new = yf + _upsample2(y_shift)
    u_new = color.fma(m[1][1], uf, m[1][2] * vf)
    v_new = color.fma(m[2][1], uf, m[2][2] * vf)

    def to_u8(x, bias):
        return torch.clamp(color.fma(x, 255.0, bias), 0,
                           255).to(torch.uint8)

    return gmap, to_u8(y_new, 0.5), to_u8(u_new, 128.5), to_u8(v_new, 128.5)


def encode_front(y_p010, uv_p010, gamut: str, hdr_tf: str):
    """B1 wrapper: the plain version on the CPU, the CUDA kernel on CUDA
    tensors. Same signature and result as encode_front_plain."""
    if not y_p010.is_cuda:
        return encode_front_plain(y_p010, uv_p010, gamut, hdr_tf)
    n, h, w = _check_p010(y_p010, uv_p010)
    build.require(y_p010, "y_p010", torch.int16)
    build.require(uv_p010, "uv_p010", torch.int16)
    dev = y_p010.device
    gmap = torch.empty((n, h // 4, w // 4), dtype=torch.uint8, device=dev)
    y601 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    u601 = torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev)
    v601 = torch.empty_like(u601)

    (kr, kg, kb), cb, cr = color.YUV_PARAMS[color.GAMUT_YUV_PARAMS[gamut]]
    _, hdr_white = color.hdr_inv_oetf_fn(hdr_tf)
    min_b, max_b, log2_min, denom, sat, floor = color.gain_code_params(
        1.0, hdr_white / color.SDR_WHITE_NITS)
    m = color.yuv_conversion_matrix(gamut, "p3")
    mvals = ((m[0][1], m[0][2], m[1][1], m[1][2], m[2][1], m[2][2])
             if m is not None else (0.0,) * 6)
    lib = build.get_lib()
    encode_front.launches += 1
    build.check(lib.uhdr_encode_front(
        y_p010.data_ptr(), uv_p010.data_ptr(), gmap.data_ptr(),
        y601.data_ptr(), u601.data_ptr(), v601.data_ptr(), n, h, w,
        cr, cb, kb * cb / kg, kr * cr / kg, *color.LUMINANCE[gamut],
        hdr_white, TF_IDS[hdr_tf], int(m is not None), min_b, max_b,
        log2_min, color.recip(denom), *mvals, sat, floor,
        build.stream_of(y_p010)),
        "uhdr_encode_front")
    return gmap, y601, u601, v601


encode_front.launches = 0


# ---------------------------------------------------------------------------
# B6: gain-map application (ultrahdr.cpp:360-515).
# ---------------------------------------------------------------------------

def _idw_upsample(gmap01, scale: int, out_h: int, out_w: int):
    """Upsample (n, mh, mw) [0,1] maps to (n, out_h, out_w) with
    Shepard's inverse-distance weights over the 4 surrounding samples,
    including the reference's right/bottom edge cells
    (gainmapmath.cpp:66-110, 686-720)."""
    _, mh, mw = gmap01.shape
    dev = gmap01.device
    ys = torch.arange(out_h, device=dev)
    xs = torch.arange(out_w, device=dev)
    my, mx = ys // scale, xs // scale
    my2 = torch.clamp(my + 1, max=mh - 1)
    mx2 = torch.clamp(mx + 1, max=mw - 1)

    def taps(rows, cols):
        return gmap01.index_select(1, rows).index_select(2, cols)

    e1, e2 = taps(my, mx), taps(my2, mx)
    e3, e4 = taps(my, mx2), taps(my2, mx2)

    px = ((xs % scale).to(torch.float32) * color.recip(scale))[None, :]
    py = ((ys % scale).to(torch.float32) * color.recip(scale))[:, None]
    inc_r = torch.where(mx >= mw - 1, 0.0, 1.0)[None, :]
    inc_b = torch.where(my >= mh - 1, 0.0, 1.0)[:, None]
    dyb, dxr = py - inc_b, px - inc_r
    d1 = torch.sqrt(color.fma(px, px, py * py))
    d2 = torch.sqrt(color.fma(px, px, dyb * dyb))
    d3 = torch.sqrt(color.fma(dxr, dxr, py * py))
    d4 = torch.sqrt(color.fma(dxr, dxr, dyb * dyb))
    eps = 1e-12
    w1 = 1.0 / torch.clamp(d1, min=eps)
    w2 = 1.0 / torch.clamp(d2, min=eps)
    w3 = 1.0 / torch.clamp(d3, min=eps)
    w4 = 1.0 / torch.clamp(d4, min=eps)
    total = w1 + w2 + w3 + w4
    blended = color.fma(e4, w4, color.fma(e3, w3, color.fma(
        e1, w1, e2 * w2))) / total
    return torch.where(d1 <= 0.0, e1, blended)


def apply_gainmap_plain(y8, u8, v8, gmap, scalars, output_format: str):
    """(n, h, w) Y, (n, ceil(h/2), ceil(w/2)) U/V and (n, mh, mw) gain
    map uint8 planes, with (n, 4) float32 scalars per frame [log2(min
    boost), log2(max boost), boost factor, display boost] -> HDR pixels:
    (n, h, w, 4) int16 F16 bits for "hdr_linear", (n, h, w) int32
    RGBA1010102 words for "hdr_hlg" / "hdr_pq"."""
    if output_format not in OUTPUT_FORMATS:
        raise ValueError(f"unsupported output format {output_format}")
    n, h, w = y8.shape
    scale = w // gmap.shape[2]
    y, u, v = yuv420_to_float(y8, u8, v8)
    u = _upsample2(u)[:, :h, :w]
    v = _upsample2(v)[:, :h, :w]
    # Decoded JPEG base: always BT.601 YUV, sRGB transfer
    # (ultrahdr.cpp:437-445).
    rgb = color.apply_channelwise(color.srgb_inv_oetf,
                                  color.p3_yuv_to_rgb((y, u, v)))
    gain01 = _idw_upsample(gmap.to(torch.float32) * color.recip(255.0),
                           scale, h, w)
    s = scalars.to(torch.float32).reshape(n, 4, 1, 1)
    log_boost = color.fma(s[:, 0], 1.0 - gain01, s[:, 1] * gain01)
    factor = torch.exp2(log_boost * s[:, 2]) / s[:, 3]
    rgb = tuple(c * factor for c in rgb)
    if output_format == "hdr_linear":
        return color.pack_rgba_f16(rgb)
    oetf = color.hlg_oetf if output_format == "hdr_hlg" else color.pq_oetf
    return color.pack_rgba1010102(color.apply_channelwise(oetf, rgb))


def _plane_strides(t, name):
    if not t.is_cuda or t.dtype != torch.uint8 or t.dim() != 3 \
            or t.stride(2) != 1:
        raise ValueError(f"{name}: expected a (n, h, w) uint8 CUDA tensor "
                         f"with unit column stride")
    return t.stride(0), t.stride(1)


def apply_gainmap(y8, u8, v8, gmap, scalars, output_format: str):
    """B6 wrapper: the plain version on the CPU, the CUDA kernel on CUDA
    tensors. Same signature and result as apply_gainmap_plain; the
    kernel reads row-strided planes (crops of padded IDCT output) in
    place."""
    if not y8.is_cuda:
        return apply_gainmap_plain(y8, u8, v8, gmap, scalars,
                                   output_format)
    if output_format not in OUTPUT_FORMATS:
        raise ValueError(f"unsupported output format {output_format}")
    n, h, w = y8.shape
    mh, mw = gmap.shape[1:]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if tuple(u8.shape) != (n, ch, cw) or tuple(v8.shape) != (n, ch, cw) \
            or gmap.shape[0] != n or w % mw or w * mh != h * mw:
        raise ValueError("apply_gainmap: inconsistent plane shapes")
    strides = [s for t, name in ((y8, "y8"), (u8, "u8"), (v8, "v8"),
                                 (gmap, "gmap"))
               for s in _plane_strides(t, name)]
    build.require(scalars, "scalars", torch.float32, (n, 4))
    fmt = OUTPUT_FORMATS[output_format]
    if fmt == 0:
        out = torch.empty((n, h, w, 4), dtype=torch.int16, device=y8.device)
    else:
        out = torch.empty((n, h, w), dtype=torch.int32, device=y8.device)
    lib = build.get_lib()
    apply_gainmap.launches += 1
    build.check(lib.uhdr_apply_gainmap(
        y8.data_ptr(), u8.data_ptr(), v8.data_ptr(), gmap.data_ptr(),
        *strides, scalars.data_ptr(), out.data_ptr(), n, h, w, mh, mw,
        w // mw, fmt, build.stream_of(y8)), "uhdr_apply_gainmap")
    return out


apply_gainmap.launches = 0
