"""Gain-map generation and application, SDR output: kernels B1, B9,
B10a, B10b, B10c, B6, B11, B7 and B18.

- ``encode_front`` (B1) is the API-0 encode front end: the P010 -> u8
  tonemap, the gain map, and the BT.601 re-encode of the base. It
  replaces libultrahdr_dev_tpu/parallel/sharding.py:_gainmap_and_coefs
  (before the fDCT) with _encode_one_image_coefs' tonemap.
- ``encode_front_api1`` (B9) is the API-1 front end: the same program
  with a supplied SDR frame, the SDR and HDR gamuts apart
  (sharding.py:_batched_encode_api1_kernel).
- ``tonemap_p010`` (B10a), ``generate_gainmap`` (B10b, with its
  ``sdr_is_601`` and ``use_luts`` arms) and ``convert_yuv_encoding``
  (B10c) are the same work as three launches for any even frame size:
  the general encode routes (jpegr.py: non-16-aligned or EXIF encodes,
  API-2, API-3), replacing libultrahdr_dev_tpu/ops/gainmap.py:
  tonemap_p010, _generate_kernel and _convert_yuv_kernel.
- ``apply_gainmap`` (B6) rebuilds HDR pixels from a decoded base and
  gain map; it replaces libultrahdr_dev_tpu/ops/gainmap.py:_apply_kernel.
  With ``use_luts=True`` it launches B11, the table arms of the same
  program (its transfer functions read from ops/color.py's tables).
  ``apply_gainmap_metadata`` is JAX's apply_gainmap (gainmap.py:333-373):
  one frame, the metadata validated, its scalars derived.
- ``yuv420_to_rgba8888`` (B7) turns a decoded base into SDR RGBA8888
  pixels (gainmap.py:yuv420_to_rgba8888).
- ``planes_composite`` (B18) stacks a decoded base and gain map into the
  u8 composite that the host-apply decode reads back
  (gainmap.py:264 planes_composite; parallel/link.py applies the gain
  map on the host).

Each wrapper runs its plain PyTorch version for tensors on the CPU and
its hand-written CUDA kernel (kernels/csrc/encode_front.cu, apply.cu,
sdr_out.cu, packio.cu) for CUDA tensors, and counts its kernel launches in
``.launches`` (B11's in ``apply_gainmap.lut_launches``; B10b's table
arm counts in ``generate_gainmap.launches``). The plain
versions follow the JAX programs operation by operation, rounding as
XLA does on the CPU (ops/color.py, ``fma``). Planes travel as torch
tensors: P010 samples as int16 holding the uint16 bits, u8 planes as
uint8, RGBA1010102 and RGBA8888 words as int32 holding the uint32 bits,
F16 pixels as (..., 4) int16 holding the half-float bits, 10-bit planar
RGB as int16 holding the 10-bit codes. All take a leading batch
dimension.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build
from ..types import (GAIN_MAP_VERSION, GainMapMetadata,
                     MAP_DIMENSION_SCALE_FACTOR, err)
from . import color

SCALE = MAP_DIMENSION_SCALE_FACTOR
TF_IDS = {"linear": 0, "hlg": 1, "pq": 2}
OUTPUT_FORMATS = {"hdr_linear": 0, "hdr_hlg": 1, "hdr_pq": 2,
                  "hdr_linear_rgb_10bit": 3}


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
    """Mean over non-overlapping factor x factor blocks of (n, h, w),
    each block summed in row-major order from 0, as the JAX package's
    reduce_window sums it on the CPU at the codec's shapes
    (bit-identical there; at a few small widths XLA adds a 2x2 window's
    rows as pairs instead)."""
    n, h, w = x.shape
    hh, ww = h // factor, w // factor
    blocks = x[:, :hh * factor, :ww * factor].reshape(n, hh, factor, ww,
                                                      factor)
    s = torch.zeros((n, hh, ww), dtype=x.dtype, device=x.device)
    for dy in range(factor):
        for dx in range(factor):
            s = s + blocks[:, :, dy, :, dx]
    return s * (1.0 / (factor * factor))


def _upsample2(x):
    """Nearest 2x upsample of (n, h, w) chroma."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _unsigned16(t):
    """int16 tensor holding uint16 bits -> int32 sample values."""
    return t.to(torch.int32) & 0xFFFF


# ---------------------------------------------------------------------------
# B1 and B9: the encode front ends.
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


def _to_u8(x, bias):
    return torch.clamp(color.fma(x, 255.0, bias), 0, 255).to(torch.uint8)


def convert_yuv_encoding_plain(y8, u8, v8, src_gamut: str,
                               dst_gamut: str = "p3"):
    """YUV420 planes of `src_gamut`'s YUV encoding re-encoded to
    `dst_gamut`'s (by default BT.601, the P3 encoding of a JPEG base),
    uint8 (gainmap.py:428-458 convert_yuv_encoding). The luma shift
    comes from the shared chroma sample, chroma from chroma alone;
    planes already in the destination encoding are returned as they
    are."""
    m = color.yuv_conversion_matrix(src_gamut, dst_gamut)
    if m is None:
        return tuple(p.to(torch.uint8) for p in (y8, u8, v8))
    yf, uf, vf = yuv420_to_float(y8, u8, v8)
    y_new = yf + _upsample2(color.dot2(m[0][1], uf, m[0][2], vf))
    return (_to_u8(y_new, 0.5),
            _to_u8(color.dot2(m[1][1], uf, m[1][2], vf), 128.5),
            _to_u8(color.dot2(m[2][1], uf, m[2][2], vf), 128.5))


_INV_LUTS = {"hlg": color.hlg_inv_oetf_lut, "pq": color.pq_inv_oetf_lut}


def _gain_plain(y8, u8, v8, y, uv, sdr_gamut: str, hdr_gamut: str,
                hdr_tf: str, sdr_is_601: bool = False,
                use_luts: bool = False):
    """The u8 gain map of SDR planes (y8, u8, v8) against the P010
    samples (y, uv, int32 values), as gainmap.py:_generate_kernel
    computes it: box means, YUV -> RGB (BT.601 for the SDR with
    sdr_is_601), inverse OETFs (tables with use_luts), the HDR taken
    into the SDR gamut, both luminances with the SDR gamut's weights."""
    hdr_inv_oetf, hdr_white = color.hdr_inv_oetf_fn(hdr_tf)
    srgb_inv = color.srgb_inv_oetf
    if use_luts:
        hdr_inv_oetf = _INV_LUTS.get(hdr_tf, hdr_inv_oetf)
        srgb_inv = color.srgb_inv_oetf_lut
    sdr_to_rgb = (color.p3_yuv_to_rgb if sdr_is_601
                  else color.yuv_to_rgb_fn(sdr_gamut))
    luminance = color.luminance_fn(sdr_gamut)
    gamut_m = color.hdr_gamut_conversion_matrix(sdr_gamut, hdr_gamut)
    max_boost = hdr_white / color.SDR_WHITE_NITS

    sy, su, sv = yuv420_to_float(y8, u8, v8)
    sy = _box_mean(sy, SCALE)
    su = _box_mean(su, SCALE // 2)
    sv = _box_mean(sv, SCALE // 2)
    sdr_rgb = color.apply_channelwise(srgb_inv, sdr_to_rgb((sy, su, sv)))
    sdr_nits = luminance(sdr_rgb) * color.SDR_WHITE_NITS
    hy, hu, hv = p010_to_float(y, uv)
    hy = _box_mean(hy, SCALE)
    hu = _box_mean(hu, SCALE // 2)
    hv = _box_mean(hv, SCALE // 2)
    hdr_rgb = color.apply_channelwise(
        hdr_inv_oetf, color.yuv_to_rgb_fn(hdr_gamut)((hy, hu, hv)))
    if gamut_m is not None:
        hdr_rgb = color.apply_matrix3(gamut_m, hdr_rgb)
    hdr_nits = luminance(hdr_rgb) * hdr_white
    return color.encode_gain(sdr_nits, hdr_nits, 1.0, max_boost)


def _front_plain(y8, u8, v8, y, uv, sdr_gamut: str, hdr_gamut: str,
                 hdr_tf: str):
    """sharding.py:_gainmap_and_coefs before the fDCT: the gain map and
    the SDR re-encoded to BT.601."""
    return (_gain_plain(y8, u8, v8, y, uv, sdr_gamut, hdr_gamut, hdr_tf),
            *convert_yuv_encoding_plain(y8, u8, v8, sdr_gamut))


def encode_front_plain(y_p010, uv_p010, gamut: str, hdr_tf: str):
    """(n, h, w) / (n, h/2, w) int16 P010 planes (uint16 bits) ->
    (gain map (n, h/4, w/4), y (n, h, w), u, v (n, h/2, w/2)), all
    uint8: the gain map of the tonemapped SDR against the HDR input, and
    the tonemapped base re-encoded to BT.601 YUV."""
    _check_p010(y_p010, uv_p010)
    y = _unsigned16(y_p010)
    uv = _unsigned16(uv_p010)
    return _front_plain(y >> 8, uv[..., 0::2] >> 8, uv[..., 1::2] >> 8, y,
                        uv, gamut, gamut, hdr_tf)


@functools.lru_cache(maxsize=None)
def _gain_params(hdr_tf: str):
    """(hdr_white, min_b, max_b, log2_min, inv_denom, sat, floor); cached,
    as the wrappers' host work per call counts beside the kernels."""
    _, hdr_white = color.hdr_inv_oetf_fn(hdr_tf)
    min_b, max_b, log2_min, denom, sat, floor = color.gain_code_params(
        1.0, hdr_white / color.SDR_WHITE_NITS)
    return hdr_white, min_b, max_b, log2_min, color.recip(denom), sat, floor


def _rgb_params(gamut: str, bt601: bool = False):
    """(cr, cb, gcb, gcr) of color.yuv_to_rgb for `gamut`'s YUV matrix,
    or for BT.601's (color.p3_yuv_to_rgb) with bt601."""
    key = "bt601" if bt601 else color.GAMUT_YUV_PARAMS[gamut]
    (kr, kg, kb), cb, cr = color.YUV_PARAMS[key]
    return cr, cb, kb * cb / kg, kr * cr / kg


def _convert_params(gamut: str):
    """(enabled, (m01, m02, m11, m12, m21, m22)) of the re-encode."""
    m = color.yuv_conversion_matrix(gamut, "p3")
    if m is None:
        return 0, (0.0,) * 6
    return 1, (m[0][1], m[0][2], m[1][1], m[1][2], m[2][1], m[2][2])


def _require_aligned(t, name: str, n: int):
    """Raise unless `t`'s data starts on an n-byte boundary: B1 and B9
    read their inputs with n-byte vector loads."""
    if t.data_ptr() % n:
        raise ValueError(f"{name}: the encode front end needs its data "
                         f"{n}-byte aligned")


def _front_outputs(n, h, w, dev):
    gmap = torch.empty((n, h // 4, w // 4), dtype=torch.uint8, device=dev)
    y601 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    u601 = torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev)
    return gmap, y601, u601, torch.empty_like(u601)


def encode_front(y_p010, uv_p010, gamut: str, hdr_tf: str):
    """B1 wrapper: the plain version on the CPU, the CUDA kernel on CUDA
    tensors. Same signature and result as encode_front_plain."""
    if not y_p010.is_cuda:
        return encode_front_plain(y_p010, uv_p010, gamut, hdr_tf)
    n, h, w = _check_p010(y_p010, uv_p010)
    build.require(y_p010, "y_p010", torch.int16)
    build.require(uv_p010, "uv_p010", torch.int16)
    _require_aligned(y_p010, "y_p010", 16)
    _require_aligned(uv_p010, "uv_p010", 16)
    out = _front_outputs(n, h, w, y_p010.device)
    hdr_white, min_b, max_b, log2_min, inv_denom, sat, floor = \
        _gain_params(hdr_tf)
    convert, mvals = _convert_params(gamut)
    encode_front.launches += 1
    build.launch(
        y_p010, "uhdr_encode_front", y_p010.data_ptr(), uv_p010.data_ptr(),
        *(t.data_ptr() for t in out), n, h, w, *_rgb_params(gamut),
        *color.LUMINANCE[gamut], hdr_white, TF_IDS[hdr_tf], convert, min_b,
        max_b, log2_min, inv_denom, *mvals, sat, floor)
    return out


encode_front.launches = 0


def _check_sdr(sdr_y, sdr_u, sdr_v, n, h, w):
    if tuple(sdr_y.shape) != (n, h, w) or any(
            tuple(p.shape) != (n, h // 2, w // 2) for p in (sdr_u, sdr_v)):
        raise ValueError("SDR planes do not match the P010 frame: "
                         f"{[tuple(p.shape) for p in (sdr_y, sdr_u, sdr_v)]}"
                         f" for {w}x{h}")


def encode_front_api1_plain(y_p010, uv_p010, sdr_y, sdr_u, sdr_v,
                            sdr_gamut: str, hdr_gamut: str, hdr_tf: str):
    """API-1 front end: P010 planes as encode_front_plain takes them and
    the SDR frame as uint8 YUV420 planes (n, h, w) and (n, h/2, w/2) in
    `sdr_gamut`'s YUV encoding -> (gain map, y, u, v) uint8: the gain
    map of the SDR against the HDR (linear HDR RGB taken into the SDR
    gamut first), and the SDR re-encoded to BT.601 YUV."""
    n, h, w = _check_p010(y_p010, uv_p010)
    _check_sdr(sdr_y, sdr_u, sdr_v, n, h, w)
    return _front_plain(sdr_y, sdr_u, sdr_v, _unsigned16(y_p010),
                        _unsigned16(uv_p010), sdr_gamut, hdr_gamut, hdr_tf)


def encode_front_api1(y_p010, uv_p010, sdr_y, sdr_u, sdr_v,
                      sdr_gamut: str, hdr_gamut: str, hdr_tf: str):
    """B9 wrapper: the plain version on the CPU, the CUDA kernel on CUDA
    tensors. Same signature and result as encode_front_api1_plain."""
    if not y_p010.is_cuda:
        return encode_front_api1_plain(y_p010, uv_p010, sdr_y, sdr_u, sdr_v,
                                       sdr_gamut, hdr_gamut, hdr_tf)
    n, h, w = _check_p010(y_p010, uv_p010)
    _check_sdr(sdr_y, sdr_u, sdr_v, n, h, w)
    build.require(y_p010, "y_p010", torch.int16)
    build.require(uv_p010, "uv_p010", torch.int16)
    for t, name in ((sdr_y, "sdr_y"), (sdr_u, "sdr_u"), (sdr_v, "sdr_v")):
        build.require(t, name, torch.uint8)
    for t, name, align in ((y_p010, "y_p010", 16), (uv_p010, "uv_p010", 16),
                           (sdr_y, "sdr_y", 8), (sdr_u, "sdr_u", 4),
                           (sdr_v, "sdr_v", 4)):
        _require_aligned(t, name, align)
    out = _front_outputs(n, h, w, y_p010.device)
    fp, ip = _gain_arrays(sdr_gamut, hdr_gamut, hdr_tf, False,
                          *_convert_params(sdr_gamut))
    encode_front_api1.launches += 1
    build.launch(
        y_p010, "uhdr_encode_front_api1", y_p010.data_ptr(),
        uv_p010.data_ptr(), sdr_y.data_ptr(), sdr_u.data_ptr(),
        sdr_v.data_ptr(), *(t.data_ptr() for t in out), n, h, w,
        fp.ctypes.data, ip.ctypes.data)
    return out


encode_front_api1.launches = 0


@functools.lru_cache(maxsize=None)
def _gain_arrays(sdr_gamut: str, hdr_gamut: str, hdr_tf: str,
                 sdr_is_601: bool, convert: int = 0,
                 mvals=(0.0,) * 6):
    """The host parameter arrays (fp float32, ip int32, read-only) of the
    gain-map kernels' C entry points (encode_front.cu:unpack_gain);
    cached."""
    hdr_white, min_b, max_b, log2_min, inv_denom, sat, floor = \
        _gain_params(hdr_tf)
    gm = color.hdr_gamut_conversion_matrix(sdr_gamut, hdr_gamut)
    fp = np.asarray(
        [*_rgb_params(sdr_gamut, sdr_is_601), *_rgb_params(hdr_gamut),
         *color.LUMINANCE[sdr_gamut], hdr_white, min_b, max_b, log2_min,
         inv_denom, *(v for row in (gm or ((0.0,) * 3,) * 3) for v in row),
         *mvals], np.float32)
    ip = np.asarray([TF_IDS[hdr_tf], int(gm is not None), convert, sat,
                     floor], np.int32)
    fp.flags.writeable = ip.flags.writeable = False
    return fp, ip


# ---------------------------------------------------------------------------
# B10a, B10b, B10c: the general encode routes' device programs, each a
# launch of its own (gainmap.py:90-96 tonemap_p010, :103-175
# generate_gainmap, :427-458 convert_yuv_encoding), for any even frame
# size. B1 and B9 fuse the same work for 16-aligned frames.
# ---------------------------------------------------------------------------

def _check_frame(y_p010, uv_p010):
    n, h, w = y_p010.shape
    if h % 2 or w % 2 or h < 4 or w < 4:
        raise ValueError(f"the encode programs need even dims of at least "
                         f"4, got {w}x{h}")
    if tuple(uv_p010.shape) != (n, h // 2, w):
        raise ValueError(f"uv plane shape {tuple(uv_p010.shape)} does not "
                         f"match y {tuple(y_p010.shape)}")
    return n, h, w


def tonemap_p010_plain(y_p010, uv_p010):
    """(n, h, w) / (n, h/2, w) int16 P010 planes (uint16 bits) -> uint8
    (y (n, h, w), u, v (n, h/2, w/2)): each 10-bit code >> 2, i.e. the
    sample >> 8, with the CbCr pairs split."""
    _check_frame(y_p010, uv_p010)
    y, uv = _unsigned16(y_p010), _unsigned16(uv_p010)
    return tuple((p >> 8).to(torch.uint8)
                 for p in (y, uv[..., 0::2], uv[..., 1::2]))


def tonemap_p010(y_p010, uv_p010):
    """B10a wrapper: the plain version on the CPU, the CUDA kernel on
    CUDA tensors. Same signature and result as tonemap_p010_plain."""
    if not y_p010.is_cuda:
        return tonemap_p010_plain(y_p010, uv_p010)
    n, h, w = _check_frame(y_p010, uv_p010)
    build.require(y_p010, "y_p010", torch.int16)
    build.require(uv_p010, "uv_p010", torch.int16)
    dev = y_p010.device
    y8 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    u8 = torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev)
    v8 = torch.empty_like(u8)
    tonemap_p010.launches += 1
    build.launch(y_p010, "uhdr_tonemap_p010", y_p010.data_ptr(),
                 uv_p010.data_ptr(), y8.data_ptr(), u8.data_ptr(),
                 v8.data_ptr(), n, h, w)
    return y8, u8, v8


tonemap_p010.launches = 0


def gainmap_metadata(hdr_tf: str) -> GainMapMetadata:
    """The metadata of a generated gain map (gainmap.py:165-174,
    ultrahdr.cpp:247-257): boosts from 1 to the transfer's peak white
    over SDR white."""
    max_boost = color.hdr_inv_oetf_fn(hdr_tf)[1] / color.SDR_WHITE_NITS
    return GainMapMetadata(version=GAIN_MAP_VERSION,
                           max_content_boost=max_boost,
                           min_content_boost=1.0, gamma=1.0, offset_sdr=0.0,
                           offset_hdr=0.0, hdr_capacity_min=1.0,
                           hdr_capacity_max=max_boost)


def generate_gainmap_plain(sdr_y, sdr_u, sdr_v, hdr_y, hdr_uv, *,
                           sdr_gamut: str, hdr_gamut: str, hdr_tf: str,
                           sdr_is_601: bool = False,
                           use_luts: bool = False):
    """SDR uint8 planes (n, h, w), (n, h/2, w/2) and P010 int16 planes
    (n, h, w), (n, h/2, w) -> (gain map (n, h//4, w//4) uint8,
    GainMapMetadata), as gainmap.py:generate_gainmap returns them. Box
    remainders are cropped (gainmap.py:_box_mean)."""
    n, h, w = _check_frame(hdr_y, hdr_uv)
    _check_sdr(sdr_y, sdr_u, sdr_v, n, h, w)
    gmap = _gain_plain(sdr_y, sdr_u, sdr_v, _unsigned16(hdr_y),
                       _unsigned16(hdr_uv), sdr_gamut, hdr_gamut, hdr_tf,
                       sdr_is_601, use_luts)
    return gmap, gainmap_metadata(hdr_tf)


def generate_gainmap(sdr_y, sdr_u, sdr_v, hdr_y, hdr_uv, *, sdr_gamut: str,
                     hdr_gamut: str, hdr_tf: str, sdr_is_601: bool = False,
                     use_luts: bool = False):
    """B10b wrapper: the plain version on the CPU, the CUDA kernel on
    CUDA tensors (its table arm with use_luts). Same signature and
    result as generate_gainmap_plain."""
    if not hdr_y.is_cuda:
        return generate_gainmap_plain(
            sdr_y, sdr_u, sdr_v, hdr_y, hdr_uv, sdr_gamut=sdr_gamut,
            hdr_gamut=hdr_gamut, hdr_tf=hdr_tf, sdr_is_601=sdr_is_601,
            use_luts=use_luts)
    n, h, w = _check_frame(hdr_y, hdr_uv)
    _check_sdr(sdr_y, sdr_u, sdr_v, n, h, w)
    build.require(hdr_y, "hdr_y", torch.int16)
    build.require(hdr_uv, "hdr_uv", torch.int16)
    for t, name in ((sdr_y, "sdr_y"), (sdr_u, "sdr_u"), (sdr_v, "sdr_v")):
        build.require(t, name, torch.uint8)
    gmap = torch.empty((n, h // 4, w // 4), dtype=torch.uint8,
                       device=hdr_y.device)
    fp, ip = _gain_arrays(sdr_gamut, hdr_gamut, hdr_tf, sdr_is_601)
    srgb = inv = None
    if use_luts:
        srgb = color.lut_tensor("srgb_inv", hdr_y.device).data_ptr()
        if hdr_tf in _INV_LUTS:
            inv = color.lut_tensor(f"{hdr_tf}_inv", hdr_y.device).data_ptr()
    generate_gainmap.launches += 1
    build.launch(hdr_y, "uhdr_generate_gainmap", sdr_y.data_ptr(),
                 sdr_u.data_ptr(), sdr_v.data_ptr(), hdr_y.data_ptr(),
                 hdr_uv.data_ptr(), gmap.data_ptr(), n, h, w, fp.ctypes.data,
                 ip.ctypes.data, srgb, inv)
    return gmap, gainmap_metadata(hdr_tf)


generate_gainmap.launches = 0


def convert_yuv_encoding(y8, u8, v8, src_gamut: str, dst_gamut: str):
    """B10c wrapper: the plain version (convert_yuv_encoding_plain) on
    the CPU, the CUDA kernel on CUDA tensors, for (n, h, w) and
    (n, h/2, w/2) uint8 planes of an even-sized frame. Planes already in
    the destination encoding come back as they are, with no launch, as
    the JAX package runs no program for them."""
    m = color.yuv_conversion_matrix(src_gamut, dst_gamut)
    if not y8.is_cuda or m is None:
        return convert_yuv_encoding_plain(y8, u8, v8, src_gamut, dst_gamut)
    n, h, w = y8.shape
    if h % 2 or w % 2:
        raise ValueError(f"convert_yuv_encoding needs even dims, got "
                         f"{w}x{h}")
    build.require(y8, "y8", torch.uint8)
    for t, name in ((u8, "u8"), (v8, "v8")):
        build.require(t, name, torch.uint8, (n, h // 2, w // 2))
    out = (torch.empty_like(y8), torch.empty_like(u8), torch.empty_like(v8))
    mvals = np.asarray([m[0][1], m[0][2], m[1][1], m[1][2], m[2][1],
                        m[2][2]], np.float32)
    convert_yuv_encoding.launches += 1
    build.launch(y8, "uhdr_convert_yuv", y8.data_ptr(), u8.data_ptr(),
                 v8.data_ptr(), *(t.data_ptr() for t in out), n, h, w,
                 mvals.ctypes.data)
    return out


convert_yuv_encoding.launches = 0


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


def apply_gainmap_plain(y8, u8, v8, gmap, scalars, output_format: str,
                        use_luts: bool = False):
    """(n, h, w) Y, (n, ceil(h/2), ceil(w/2)) U/V and (n, mh, mw) gain
    map uint8 planes, with (n, 4) float32 scalars per frame [log2(min
    boost), log2(max boost), boost factor, display boost] -> HDR pixels:
    (n, h, w, 4) int16 F16 bits for "hdr_linear", (n, h, w) int32
    RGBA1010102 words for "hdr_hlg" / "hdr_pq", (n, 3, h, w) int16
    10-bit linear RGB codes (clip(c, 0, 1) * 1023 truncated) for
    "hdr_linear_rgb_10bit". With use_luts, the sRGB inverse OETF and the
    HLG / PQ OETF are table lookups (gainmap.py:297,323,326)."""
    if output_format not in OUTPUT_FORMATS:
        raise ValueError(f"unsupported output format {output_format}")
    n, h, w = y8.shape
    scale = w // gmap.shape[2]
    y, u, v = yuv420_to_float(y8, u8, v8)
    u = _upsample2(u)[:, :h, :w]
    v = _upsample2(v)[:, :h, :w]
    # Decoded JPEG base: always BT.601 YUV, sRGB transfer
    # (ultrahdr.cpp:437-445).
    srgb_inv = color.srgb_inv_oetf_lut if use_luts else color.srgb_inv_oetf
    rgb = color.apply_channelwise(srgb_inv, color.p3_yuv_to_rgb((y, u, v)))
    gain01 = _idw_upsample(gmap.to(torch.float32) * color.recip(255.0),
                           scale, h, w)
    s = scalars.to(torch.float32).reshape(n, 4, 1, 1)
    log_boost = color.fma(s[:, 0], 1.0 - gain01, s[:, 1] * gain01)
    factor = torch.exp2(log_boost * s[:, 2]) / s[:, 3]
    rgb = tuple(c * factor for c in rgb)
    if output_format == "hdr_linear":
        return color.pack_rgba_f16(rgb)
    if output_format == "hdr_linear_rgb_10bit":
        return torch.stack([(torch.clamp(c, 0.0, 1.0) * 1023.0)
                            .to(torch.int16) for c in rgb], dim=1)
    if output_format == "hdr_hlg":
        oetf = color.hlg_oetf_lut if use_luts else color.hlg_oetf
    else:
        oetf = color.pq_oetf_lut if use_luts else color.pq_oetf
    return color.pack_rgba1010102(color.apply_channelwise(oetf, rgb))


def _plane_strides(t, name):
    if not t.is_cuda or t.dtype != torch.uint8 or t.dim() != 3 \
            or t.stride(2) != 1:
        raise ValueError(f"{name}: expected a (n, h, w) uint8 CUDA tensor "
                         f"with unit column stride")
    return t.stride(0), t.stride(1)


def _check_chroma(y8, u8, v8):
    n, h, w = y8.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if tuple(u8.shape) != (n, ch, cw) or tuple(v8.shape) != (n, ch, cw):
        raise ValueError(f"chroma planes {tuple(u8.shape)}, "
                         f"{tuple(v8.shape)} do not match luma "
                         f"{tuple(y8.shape)}")
    return n, h, w


_OETF_LUTS = {"hdr_hlg": "hlg_oetf", "hdr_pq": "pq_oetf"}
_SRGB_RB: dict = {}


def srgb_rb_tables(device) -> torch.Tensor:
    """B6's (2, 65536) float32 tables on a CUDA device, built there once
    (uhdr_srgb_rb_tables): the sRGB inverse OETF of the BT.601 decode's
    red at luma << 8 | V and of its blue at luma << 8 | U, by the
    kernel's own arithmetic, so that B6 computes only green's pow."""
    key = resolve_device(device)
    if key not in _SRGB_RB:
        with torch.cuda.device(key):
            capturing = torch.cuda.is_current_stream_capturing()
        if capturing:
            raise RuntimeError("apply_gainmap: call it once outside CUDA "
                               "graph capture (it builds its tables)")
        t = torch.empty((2, 65536), dtype=torch.float32, device=key)
        build.launch(t, "uhdr_srgb_rb_tables", t.data_ptr())
        _SRGB_RB[key] = t
    return _SRGB_RB[key]


def apply_gainmap(y8, u8, v8, gmap, scalars, output_format: str,
                  use_luts: bool = False):
    """B6 wrapper (B11 with use_luts): the plain version on the CPU, the
    CUDA kernel on CUDA tensors. Same signature and result as
    apply_gainmap_plain; the kernel reads row-strided planes (crops of
    padded IDCT output) in place. B6 launches count in ``.launches``,
    B11 launches in ``.lut_launches``; launches of the 10-bit planar arm
    (in either variant) count in ``.rgb10_launches`` as well."""
    if not y8.is_cuda:
        return apply_gainmap_plain(y8, u8, v8, gmap, scalars,
                                   output_format, use_luts)
    if output_format not in OUTPUT_FORMATS:
        raise ValueError(f"unsupported output format {output_format}")
    n, h, w = _check_chroma(y8, u8, v8)
    mh, mw = gmap.shape[1:]
    if gmap.shape[0] != n or w % mw or w * mh != h * mw:
        raise ValueError("apply_gainmap: inconsistent plane shapes")
    strides = [s for t, name in ((y8, "y8"), (u8, "u8"), (v8, "v8"),
                                 (gmap, "gmap"))
               for s in _plane_strides(t, name)]
    build.require(scalars, "scalars", torch.float32, (n, 4))
    fmt = OUTPUT_FORMATS[output_format]
    if fmt == 0:
        out = torch.empty((n, h, w, 4), dtype=torch.int16, device=y8.device)
    elif fmt == 3:
        out = torch.empty((n, 3, h, w), dtype=torch.int16, device=y8.device)
    else:
        out = torch.empty((n, h, w), dtype=torch.int32, device=y8.device)
    args = (y8.data_ptr(), u8.data_ptr(), v8.data_ptr(), gmap.data_ptr(),
            *strides, scalars.data_ptr(), out.data_ptr(), n, h, w, mh, mw,
            w // mw, fmt)
    if fmt == 3:
        apply_gainmap.rgb10_launches += 1
    if not use_luts:
        rb = srgb_rb_tables(y8.device)
        apply_gainmap.launches += 1
        build.launch(y8, "uhdr_apply_gainmap", *args, rb.data_ptr())
        return out
    srgb = color.lut_tensor("srgb_inv", y8.device)
    oetf = (color.lut_tensor(_OETF_LUTS[output_format], y8.device)
            if output_format in _OETF_LUTS else None)
    apply_gainmap.lut_launches += 1
    build.launch(y8, "uhdr_apply_gainmap_lut", *args, srgb.data_ptr(),
                 oetf.data_ptr() if oetf is not None else None)
    return out


apply_gainmap.launches = 0
apply_gainmap.lut_launches = 0
apply_gainmap.rgb10_launches = 0


def pow_exact_check(p: float, lo_bits: int, hi_bits: int, device):
    """B6's exactly rounded pow on the card (uhdr_pow_check): over every
    float32 whose bits lie in [lo_bits, hi_bits), (the count whose
    pow_exact(x, p) differs in any bit from pow_rn(x, p), the count that
    took pow_exact's double path). A check of the kernel's arithmetic,
    on no path; it needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("pow_exact_check checks the CUDA kernel: it needs "
                         "a CUDA device")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    build.launch(counts, "uhdr_pow_check", color._f32(p), lo_bits, hi_bits,
                 counts.data_ptr())
    return tuple(int(c) for c in counts.tolist())


def pow_probe(x, p: float, exact: bool = True):
    """x ** p for float32 x as apply.cu computes it (pow_exact, or with
    exact=False its double pow, pow_rn), one launch; both give
    color.pow_rn's bits, which is the plain version on the CPU. On no
    path: the pows alone, for their time."""
    if not x.is_cuda:
        return color.pow_rn(x, p)
    build.require(x, "x", torch.float32)
    out = torch.empty_like(x)
    build.launch(x, "uhdr_pow_probe", x.data_ptr(), out.data_ptr(),
                 x.numel(), color._f32(p), int(exact))
    return out


# ---------------------------------------------------------------------------
# B18: the planes composite of the host-apply decode.
# ---------------------------------------------------------------------------

def _composite_shape(y8, u8, gmap):
    n, h, w = y8.shape
    ch, cw = u8.shape[1:]
    gh = gmap.shape[1]
    return n, -(-(h + ch + gh) // 3) * 3, max(w, 2 * cw)


def planes_composite_plain(y8, u8, v8, gmap):
    """(n, h, w) Y, (n, ceil(h/2), ceil(w/2)) U/V and (n, gh, gw) gain
    map uint8 planes -> the (n, rows, wc) uint8 composite that the
    planes readback ships (JAX gainmap.py:264 planes_composite): rows
    [0, h) Y, then U|V side by side, then the gain map, each edge-padded
    to wc = max(w, 2 * cw) columns; rows padded to a multiple of 3 by
    repeating the last."""
    planes_composite_plain.calls += 1
    n, rows, wc = _composite_shape(y8, u8, gmap)

    def padw(a):
        return torch.cat([a, a[..., -1:].expand(*a.shape[:-1],
                                                 wc - a.shape[-1])], dim=-1)

    comp = torch.cat([padw(y8), padw(torch.cat([u8, v8], dim=-1)),
                      padw(gmap)], dim=1)
    pad = rows - comp.shape[1]
    return torch.cat([comp, comp[:, -1:].expand(n, pad, wc)], dim=1)


planes_composite_plain.calls = 0


def planes_composite(y8, u8, v8, gmap):
    """B18 wrapper: the plain version on the CPU, the CUDA kernel
    (kernels/csrc/packio.cu uhdr_planes_composite, row-strided planes
    read in place) on CUDA tensors. Same arguments and result as
    planes_composite_plain."""
    if not y8.is_cuda:
        return planes_composite_plain(y8, u8, v8, gmap)
    n, h, w = _check_chroma(y8, u8, v8)
    gh, gw = gmap.shape[1:]
    if gmap.shape[0] != n:
        raise ValueError("planes_composite: gain map batch differs")
    strides = [s for t, name in ((y8, "y8"), (u8, "u8"), (v8, "v8"),
                                 (gmap, "gmap"))
               for s in _plane_strides(t, name)]
    _, rows, wc = _composite_shape(y8, u8, gmap)
    out = torch.empty((n, rows, wc), dtype=torch.uint8, device=y8.device)
    planes_composite.launches += 1
    build.launch(y8, "uhdr_planes_composite", y8.data_ptr(), u8.data_ptr(),
                 v8.data_ptr(), gmap.data_ptr(), *strides, out.data_ptr(), n,
                 h, w, u8.shape[1], u8.shape[2], gh, gw, rows, wc)
    return out


planes_composite.launches = 0


def apply_scalars(metadata: GainMapMetadata,
                  max_display_boost: float) -> np.ndarray:
    """[log2(min boost), log2(max boost), boost factor, display boost]
    as float32, as JpegR.decode derives them (jpegr.py:587-599)."""
    display_boost = min(max_display_boost, metadata.max_content_boost)
    boost_factor = (display_boost / metadata.max_content_boost
                    if display_boost > 0 else 1.0)
    return np.asarray([math.log2(metadata.min_content_boost),
                       math.log2(metadata.max_content_boost),
                       boost_factor, display_boost], np.float32)


def apply_gainmap_metadata(y8, u8, v8, gmap, metadata: GainMapMetadata,
                           output_format: str, max_display_boost: float,
                           use_luts: bool = False):
    """HDR pixels of one frame from 2-D uint8 planes Y (h, w), U/V
    (ceil(h/2), ceil(w/2)) and a gain map (mh, mw) on one device, as the
    JAX apply_gainmap computes them (gainmap.py:333-373): the metadata
    checked as the reference checks it (version, gamma 1, zero offsets,
    capacity == content boost; UHDR_CODEC_UNSUPPORTED_FEATURE), the map
    scale an integer, the scalars derived from the metadata, then
    apply_gainmap (B6, B11 with use_luts) without the batch dimension."""
    if metadata.version != GAIN_MAP_VERSION:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"unsupported metadata version {metadata.version}")
    if metadata.gamma != 1.0:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"unsupported gamma {metadata.gamma}")
    if metadata.offset_sdr != 0.0 or metadata.offset_hdr != 0.0:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE", "nonzero offsets")
    if (metadata.hdr_capacity_min != metadata.min_content_boost
            or metadata.hdr_capacity_max != metadata.max_content_boost):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "hdr capacity != content boost")
    h, w = y8.shape
    mh, mw = gmap.shape
    if h % mh or w % mw or (w * mh != h * mw):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"non-integer map scale {w}x{h} vs {mw}x{mh}")
    scalars = torch.from_numpy(apply_scalars(
        metadata, max_display_boost)[None]).to(y8.device)
    return apply_gainmap(y8[None], u8[None], v8[None], gmap[None], scalars,
                         output_format, use_luts)[0]


# ---------------------------------------------------------------------------
# B7: SDR RGBA8888 output. The reference gets it from libjpeg itself
# (DECODE_TO_RGBA, jpegr.cpp:692-697, 770-788): the triangular ("fancy")
# h2v2 chroma upsample and full-range BT.601 YCbCr -> RGB.
# ---------------------------------------------------------------------------

RGBA8888_ALPHA = -(1 << 24)  # 0xFF000000 as int32


def _fancy_upsample2(c):
    """libjpeg h2v2 fancy (triangle) upsample of (n, ch, cw) chroma to
    (n, 2ch, 2cw) int32, in the integer arithmetic of jdsample.c
    h2v2_fancy_upsample, edges replicated (gainmap.py:383-403)."""
    c = c.to(torch.int32)
    n, ch, cw = c.shape
    up = 3 * c + torch.cat([c[:, :1], c[:, :-1]], 1)     # toward the row above
    down = 3 * c + torch.cat([c[:, 1:], c[:, -1:]], 1)   # toward the row below
    rows = torch.stack([up, down], 2).reshape(n, 2 * ch, cw)
    left = (3 * rows + torch.cat([rows[..., :1], rows[..., :-1]], -1)
            + 8) >> 4
    right = (3 * rows + torch.cat([rows[..., 1:], rows[..., -1:]], -1)
             + 7) >> 4
    return torch.stack([left, right], -1).reshape(n, 2 * ch, 2 * cw)


def yuv420_to_rgba8888_plain(y8, u8, v8):
    """(n, h, w) Y and (n, ceil(h/2), ceil(w/2)) U/V uint8 planes of a
    full-range BT.601 base -> (n, h, w) int32 RGBA8888 words (uint32
    bits, alpha 0xFF). The colour matrix is fused as XLA on the CPU
    fuses the JAX expression: r and b one multiply-add each, g two, the
    Cb term first; rounding is half to even."""
    n, h, w = _check_chroma(y8, u8, v8)
    y = y8.to(torch.float32)
    cb = _fancy_upsample2(u8)[:, :h, :w].to(torch.float32) - 128.0
    cr = _fancy_upsample2(v8)[:, :h, :w].to(torch.float32) - 128.0
    r = color.fma(1.40200, cr, y)
    g = color.fma(-0.71414, cr, color.fma(-0.34414, cb, y))
    b = color.fma(1.77200, cb, y)

    def to8(x):
        return torch.clamp(torch.round(x), 0, 255).to(torch.int32)

    return to8(r) | (to8(g) << 8) | (to8(b) << 16) | RGBA8888_ALPHA


def yuv420_to_rgba8888(y8, u8, v8):
    """B7 wrapper: the plain version on the CPU, the CUDA kernel on CUDA
    tensors. Same signature and result as yuv420_to_rgba8888_plain; the
    kernel reads row-strided planes in place, with 32-bit offsets within
    a plane."""
    if not y8.is_cuda:
        return yuv420_to_rgba8888_plain(y8, u8, v8)
    n, h, w = _check_chroma(y8, u8, v8)
    strides = [s for t, name in ((y8, "y8"), (u8, "u8"), (v8, "v8"))
               for s in _plane_strides(t, name)]
    if max(h * w, *(t.shape[1] * t.stride(1) for t in (y8, u8, v8))) \
            >= 1 << 31:
        raise ValueError("yuv420_to_rgba8888: a plane beyond 32-bit offsets")
    out = torch.empty((n, h, w), dtype=torch.int32, device=y8.device)
    yuv420_to_rgba8888.launches += 1
    build.launch(y8, "uhdr_yuv420_to_rgba8888", y8.data_ptr(), u8.data_ptr(),
                 v8.data_ptr(), *strides, out.data_ptr(), n, h, w)
    return out


yuv420_to_rgba8888.launches = 0
