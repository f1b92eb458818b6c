"""ctypes binding to the system libavif (0.11.x ABI) for 10-bit AVIF
encoding: a copy of libultrahdr_dev_tpu/container/libavif.py.

Why this exists: the reference's 10-bit AVIF output rides its patched
libheif (lib/src/ultrahdr.cpp:1207-1287). The packaged
libheif's aom plugin mis-selects AV1 profile 2 for any
10-bit encode and trips an assertion inside libaom (process abort), so
the 10-bit AVIF path goes through libavif instead, which configures
the profile correctly and writes the container itself.

Struct layouts mirror avif.h of libavif 0.11.1 (the pinned system
package); ctypes computes offsets with C alignment rules, so field
order is all that matters.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

from ..types import err

# avifPixelFormat
PIXEL_FORMAT_YUV444 = 1
PIXEL_FORMAT_YUV422 = 2
PIXEL_FORMAT_YUV420 = 3
PIXEL_FORMAT_YUV400 = 4
RANGE_LIMITED = 0
RANGE_FULL = 1
PLANES_YUV = 1


class _RWData(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t)]


class _Fraction(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("d", ctypes.c_int32)]


class _ScalingMode(ctypes.Structure):
    _fields_ = [("horizontal", _Fraction), ("vertical", _Fraction)]


class _IOStats(ctypes.Structure):
    _fields_ = [("colorOBUSize", ctypes.c_size_t),
                ("alphaOBUSize", ctypes.c_size_t)]


class _Diagnostics(ctypes.Structure):
    _fields_ = [("error", ctypes.c_char * 256)]


class _Encoder(ctypes.Structure):
    # avif.h 0.11.1 avifEncoder
    _fields_ = [
        ("codecChoice", ctypes.c_int),
        ("maxThreads", ctypes.c_int),
        ("speed", ctypes.c_int),
        ("keyframeInterval", ctypes.c_int),
        ("timescale", ctypes.c_uint64),
        ("repetitionCount", ctypes.c_int),
        ("extraLayerCount", ctypes.c_uint32),
        ("quality", ctypes.c_int),
        ("qualityAlpha", ctypes.c_int),
        ("minQuantizer", ctypes.c_int),
        ("maxQuantizer", ctypes.c_int),
        ("minQuantizerAlpha", ctypes.c_int),
        ("maxQuantizerAlpha", ctypes.c_int),
        ("tileRowsLog2", ctypes.c_int),
        ("tileColsLog2", ctypes.c_int),
        ("autoTiling", ctypes.c_int),
        ("scalingMode", _ScalingMode),
        ("ioStats", _IOStats),
        ("diag", _Diagnostics),
        ("data", ctypes.c_void_p),
        ("csOptions", ctypes.c_void_p),
    ]


class _PASP(ctypes.Structure):
    _fields_ = [("hSpacing", ctypes.c_uint32),
                ("vSpacing", ctypes.c_uint32)]


class _CLAP(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32)
                for n in ("widthN", "widthD", "heightN", "heightD",
                          "horizOffN", "horizOffD", "vertOffN",
                          "vertOffD")]


class _Image(ctypes.Structure):
    # avif.h 0.11.1 avifImage
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("depth", ctypes.c_uint32),
        ("yuvFormat", ctypes.c_int),
        ("yuvRange", ctypes.c_int),
        ("yuvChromaSamplePosition", ctypes.c_int),
        ("yuvPlanes", ctypes.POINTER(ctypes.c_uint8) * 3),
        ("yuvRowBytes", ctypes.c_uint32 * 3),
        ("imageOwnsYUVPlanes", ctypes.c_int),
        ("alphaPlane", ctypes.POINTER(ctypes.c_uint8)),
        ("alphaRowBytes", ctypes.c_uint32),
        ("imageOwnsAlphaPlane", ctypes.c_int),
        ("alphaPremultiplied", ctypes.c_int),
        ("icc", _RWData),
        ("colorPrimaries", ctypes.c_uint16),
        ("transferCharacteristics", ctypes.c_uint16),
        ("matrixCoefficients", ctypes.c_uint16),
        ("transformFlags", ctypes.c_uint32),
        ("pasp", _PASP),
        ("clap", _CLAP),
        ("irot_angle", ctypes.c_uint8),
        ("imir_mode", ctypes.c_uint8),
        ("exif", _RWData),
        ("xmp", _RWData),
    ]


_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        name = ctypes.util.find_library("avif") or "libavif.so.15"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            return None
        # The struct layouts below are the 0.11.x ABI. find_library
        # loads whatever version is installed; on a different
        # major/minor the avifEncoder field offsets differ and writing
        # enc.contents.quality would poke wrong memory. Refuse cleanly
        # (callers surface UHDR_CODEC_UNSUPPORTED_FEATURE) instead.
        try:
            lib.avifVersion.restype = ctypes.c_char_p
            ver = lib.avifVersion().decode()
            major, minor = (int(x) for x in ver.split(".")[:2])
            if (major, minor) != (0, 11):
                return None
        except Exception:
            return None
        p = ctypes.POINTER
        lib.avifImageCreate.restype = p(_Image)
        lib.avifImageCreate.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
        lib.avifImageAllocatePlanes.restype = ctypes.c_int
        lib.avifImageAllocatePlanes.argtypes = [p(_Image),
                                                ctypes.c_uint32]
        lib.avifImageDestroy.argtypes = [p(_Image)]
        lib.avifImageSetMetadataExif.argtypes = [
            p(_Image), ctypes.c_char_p, ctypes.c_size_t]
        lib.avifEncoderCreate.restype = p(_Encoder)
        lib.avifEncoderWrite.restype = ctypes.c_int
        lib.avifEncoderWrite.argtypes = [p(_Encoder), p(_Image),
                                         p(_RWData)]
        lib.avifEncoderDestroy.argtypes = [p(_Encoder)]
        lib.avifRWDataFree.argtypes = [p(_RWData)]
        lib.avifResultToString.restype = ctypes.c_char_p
        lib.avifResultToString.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def encode_yuv(planes, depth: int, quality: int,
               transfer: str = "hlg", limited_range: bool = True,
               exif: bytes | None = None) -> bytes:
    """Encode YCbCr planes ((H,W) y + subsampled cb/cr; u8 for 8-bit,
    u16 for deeper) into a standalone AVIF with BT.2020 CICP. Chroma
    format is inferred from the cb plane's shape."""
    lib = _load()
    if lib is None:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "libavif shared library not found")
    y = np.ascontiguousarray(
        planes[0], np.uint16 if depth > 8 else np.uint8)
    h, w = y.shape
    ch, cw = planes[1].shape
    if (ch, cw) == ((h + 1) // 2, (w + 1) // 2):
        fmt = PIXEL_FORMAT_YUV420
    elif (ch, cw) == (h, (w + 1) // 2):
        fmt = PIXEL_FORMAT_YUV422
    elif (ch, cw) == (h, w):
        fmt = PIXEL_FORMAT_YUV444
    else:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"bad chroma geometry {(ch, cw)} for {(h, w)}")
    img = lib.avifImageCreate(w, h, depth, fmt)
    if not img:
        raise err("UHDR_CODEC_ERROR", "avifImageCreate failed")
    try:
        ic = img.contents
        ic.yuvRange = RANGE_LIMITED if limited_range else RANGE_FULL
        ic.colorPrimaries = 9                      # BT.2020
        ic.transferCharacteristics = 18 if transfer == "hlg" else 16
        ic.matrixCoefficients = 9                  # BT.2020 NCL
        if lib.avifImageAllocatePlanes(img, PLANES_YUV) != 0:
            raise err("UHDR_CODEC_ERROR",
                      "avifImageAllocatePlanes failed")
        npdt = np.uint16 if depth > 8 else np.uint8
        for ci, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane, npdt)
            ph, pw = plane.shape
            rb = ic.yuvRowBytes[ci]
            dst = np.ctypeslib.as_array(ic.yuvPlanes[ci],
                                        (ph, rb)).view(npdt)
            dst = dst.reshape(ph, rb // plane.itemsize)
            dst[:, :pw] = plane
        if exif is not None:
            lib.avifImageSetMetadataExif(img, exif, len(exif))
        enc = lib.avifEncoderCreate()
        if not enc:
            raise err("UHDR_CODEC_ERROR", "avifEncoderCreate failed")
        try:
            enc.contents.maxThreads = 4
            enc.contents.speed = 8
            enc.contents.quality = int(quality)
            # Map quality onto the quantizer clamp too (belt and
            # braces against the quality field being ignored).
            q = max(0, min(63, round(63 - quality * 0.63)))
            enc.contents.minQuantizer = max(0, q - 8)
            enc.contents.maxQuantizer = min(63, q + 8)
            out = _RWData()
            res = lib.avifEncoderWrite(enc, img, ctypes.byref(out))
            if res != 0:
                msg = lib.avifResultToString(res).decode()
                raise err("UHDR_CODEC_ERROR",
                          f"avifEncoderWrite: {msg}")
            try:
                return ctypes.string_at(out.data, out.size)
            finally:
                lib.avifRWDataFree(ctypes.byref(out))
        finally:
            lib.avifEncoderDestroy(enc)
    finally:
        lib.avifImageDestroy(img)
