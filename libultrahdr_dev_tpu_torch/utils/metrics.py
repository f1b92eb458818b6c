"""Quality metrics: per-plane PSNR harness used by the CLI's -e flag,
mirroring the demo app's verification path
(libultrahdr examples/ultrahdr_app.cpp:1205-1219): convert both
images to YUV444 and report Y/U/V PSNR. A copy of
libultrahdr_dev_tpu/utils/metrics.py.
"""

from __future__ import annotations

import numpy as np


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def psnr_float(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def yuv420_psnr(y1, u1, v1, y2, u2, v2) -> tuple[float, float, float]:
    """Per-plane PSNR on upsampled-to-444 planes (app behavior)."""
    up = lambda c: np.repeat(np.repeat(np.asarray(c), 2, 0), 2, 1)
    return (psnr_u8(y1, y2),
            psnr_u8(up(u1), up(u2)),
            psnr_u8(up(v1), up(v2)))


def p010_yuv420_psnr(p010_y, p010_uv, y8, u8, v8):
    """PSNR between a P010 source (10-bit) and a YUV420 8-bit image,
    comparing in the 8-bit domain like the demo app does after its
    conversions."""
    ys = (np.asarray(p010_y) >> 8).astype(np.uint8)
    us = (np.asarray(p010_uv)[:, 0::2] >> 8).astype(np.uint8)
    vs = (np.asarray(p010_uv)[:, 1::2] >> 8).astype(np.uint8)
    return yuv420_psnr(ys, us, vs, y8, u8, v8)
