"""ctypes binding to the system libheif (>= 1.11) for the coded-image
layer of HeifR: a copy of libultrahdr_dev_tpu/container/libheif.py.

The reference links a patched libheif fork with private gain-map APIs
(lib/src/heifr.cpp:35-36); the stock library only
encodes/decodes individual HEVC/AV1 images, so the gain-map container
is assembled/parsed by container/isobmff.py and this module handles
just pixels <-> coded HEIF bytes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile
import threading

import numpy as np

from ..types import err

# enum values from libheif's public heif.h (stable ABI).
COLORSPACE_YCBCR = 0
COLORSPACE_RGB = 1
COLORSPACE_MONOCHROME = 2
CHROMA_MONOCHROME = 0
CHROMA_420 = 1
CHROMA_444 = 3
CHANNEL_Y = 0
CHANNEL_CB = 1
CHANNEL_CR = 2
CHANNEL_R = 3
CHANNEL_G = 4
CHANNEL_B = 5
COMPRESSION_HEVC = 1
COMPRESSION_AV1 = 4


class _HeifError(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("subcode", ctypes.c_int),
                ("message", ctypes.c_char_p)]


_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        name = ctypes.util.find_library("heif") or "libheif.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            return None
        E = _HeifError
        p = ctypes.POINTER
        lib.heif_context_alloc.restype = ctypes.c_void_p
        lib.heif_context_free.argtypes = [ctypes.c_void_p]
        lib.heif_context_read_from_memory_without_copy.restype = E
        lib.heif_context_read_from_memory_without_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p]
        lib.heif_context_get_primary_image_handle.restype = E
        lib.heif_context_get_primary_image_handle.argtypes = [
            ctypes.c_void_p, p(ctypes.c_void_p)]
        lib.heif_image_handle_get_width.restype = ctypes.c_int
        lib.heif_image_handle_get_width.argtypes = [ctypes.c_void_p]
        lib.heif_image_handle_get_height.restype = ctypes.c_int
        lib.heif_image_handle_get_height.argtypes = [ctypes.c_void_p]
        lib.heif_image_handle_release.argtypes = [ctypes.c_void_p]
        lib.heif_decode_image.restype = E
        lib.heif_decode_image.argtypes = [
            ctypes.c_void_p, p(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.heif_image_get_plane_readonly.restype = p(ctypes.c_uint8)
        lib.heif_image_get_plane_readonly.argtypes = [
            ctypes.c_void_p, ctypes.c_int, p(ctypes.c_int)]
        lib.heif_image_release.argtypes = [ctypes.c_void_p]
        lib.heif_context_get_encoder_for_format.restype = E
        lib.heif_context_get_encoder_for_format.argtypes = [
            ctypes.c_void_p, ctypes.c_int, p(ctypes.c_void_p)]
        lib.heif_encoder_set_lossy_quality.restype = E
        lib.heif_encoder_set_lossy_quality.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.heif_encoder_release.argtypes = [ctypes.c_void_p]
        lib.heif_image_create.restype = E
        lib.heif_image_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            p(ctypes.c_void_p)]
        lib.heif_image_add_plane.restype = E
        lib.heif_image_add_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.heif_image_get_plane.restype = p(ctypes.c_uint8)
        lib.heif_image_get_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int, p(ctypes.c_int)]
        lib.heif_context_encode_image.restype = E
        lib.heif_context_encode_image.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, p(ctypes.c_void_p)]
        lib.heif_context_write_to_file.restype = E
        lib.heif_context_write_to_file.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.heif_nclx_color_profile_alloc.restype = ctypes.c_void_p
        lib.heif_nclx_color_profile_free.argtypes = [ctypes.c_void_p]
        for fn in ("heif_nclx_color_profile_set_color_primaries",
                   "heif_nclx_color_profile_set_transfer_characteristics",
                   "heif_nclx_color_profile_set_matrix_coefficients"):
            getattr(lib, fn).restype = E
            getattr(lib, fn).argtypes = [ctypes.c_void_p,
                                         ctypes.c_uint16]
        lib.heif_image_set_nclx_color_profile.restype = E
        lib.heif_image_set_nclx_color_profile.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.heif_image_get_bits_per_pixel_range.restype = ctypes.c_int
        lib.heif_image_get_bits_per_pixel_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.heif_image_handle_get_luma_bits_per_pixel.restype = \
            ctypes.c_int
        lib.heif_image_handle_get_luma_bits_per_pixel.argtypes = [
            ctypes.c_void_p]
        # EXIF metadata blocks (heifr.cpp:266-268 encode,
        # heifr.cpp:324-331 decode).
        lib.heif_context_add_exif_metadata.restype = E
        lib.heif_context_add_exif_metadata.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.heif_image_handle_get_list_of_metadata_block_IDs.restype = \
            ctypes.c_int
        lib.heif_image_handle_get_list_of_metadata_block_IDs.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, p(ctypes.c_uint32),
            ctypes.c_int]
        lib.heif_image_handle_get_metadata_size.restype = ctypes.c_size_t
        lib.heif_image_handle_get_metadata_size.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32]
        lib.heif_image_handle_get_metadata.restype = E
        lib.heif_image_handle_get_metadata.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _check(e: _HeifError, what: str):
    if e.code != 0:
        msg = e.message.decode("utf-8", "replace") if e.message else ""
        raise err("UHDR_CODEC_ERROR", f"libheif {what}: {msg}")


def _require():
    lib = _load()
    if lib is None:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "libheif shared library not found")
    return lib


def decode_primary(data: bytes, monochrome: bool):
    """Decode the primary image of a (minimal) HEIF to numpy planes:
    gray -> (y,), color -> (y, cb, cr) at 4:2:0; 8-bit."""
    planes, _ = decode_primary_depth(data, monochrome)
    return planes


def decode_primary_depth(data: bytes, monochrome: bool):
    """Like decode_primary but returns (planes, bit_depth); plane
    dtype is u8 for 8-bit content, u16 (values in [0, 2^depth)) for
    deeper content (10-bit HEIC/AVIF primaries)."""
    planes, depth, _ = decode_primary_full(data, monochrome,
                                           want_exif=False)
    return planes, depth


def decode_primary_full(data: bytes, monochrome: bool,
                        want_exif: bool = True):
    """Decode planes + depth and (optionally) the primary item's Exif
    block in ONE container parse: returns (planes, depth, exif|None).
    Callers that need both must use this instead of pairing
    decode_primary_depth with extract_exif (two full parses)."""
    lib = _require()
    ctx = lib.heif_context_alloc()
    try:
        _check(lib.heif_context_read_from_memory_without_copy(
            ctx, data, len(data), None), "read")
        handle = ctypes.c_void_p()
        _check(lib.heif_context_get_primary_image_handle(
            ctx, ctypes.byref(handle)), "primary handle")
        try:
            w = lib.heif_image_handle_get_width(handle)
            h = lib.heif_image_handle_get_height(handle)
            img = ctypes.c_void_p()
            cs, ch = ((COLORSPACE_MONOCHROME, CHROMA_MONOCHROME)
                      if monochrome else (COLORSPACE_YCBCR, CHROMA_420))
            e = lib.heif_decode_image(handle, ctypes.byref(img), cs, ch,
                                      None)
            if e.code != 0 and monochrome:
                # Some encoders store gray as 4:2:0 YCbCr; take Y.
                img = ctypes.c_void_p()
                e = lib.heif_decode_image(handle, ctypes.byref(img),
                                          COLORSPACE_YCBCR, CHROMA_420,
                                          None)
            _check(e, "decode")
            try:
                depth = lib.heif_image_get_bits_per_pixel_range(
                    img, CHANNEL_Y)
                wide = depth > 8

                def plane(channel, ph, pw):
                    stride = ctypes.c_int()
                    ptr = lib.heif_image_get_plane_readonly(
                        img, channel, ctypes.byref(stride))
                    if not ptr:
                        raise err("UHDR_CODEC_ERROR",
                                  f"missing plane {channel}")
                    if wide:
                        p16 = ctypes.cast(
                            ptr, ctypes.POINTER(ctypes.c_uint16))
                        buf = np.ctypeslib.as_array(
                            p16, (ph, stride.value // 2))
                        return np.array(buf[:, :pw], np.uint16,
                                        copy=True)
                    buf = np.ctypeslib.as_array(ptr,
                                                (ph, stride.value))
                    return np.array(buf[:, :pw], np.uint8, copy=True)

                y = plane(CHANNEL_Y, h, w)
                if monochrome:
                    planes = (y,)
                else:
                    cw, chh = (w + 1) // 2, (h + 1) // 2
                    planes = (y, plane(CHANNEL_CB, chh, cw),
                              plane(CHANNEL_CR, chh, cw))
                exif = (_exif_from_handle(lib, handle)
                        if want_exif else None)
                return planes, depth, exif
            finally:
                lib.heif_image_release(img)
        finally:
            lib.heif_image_handle_release(handle)
    finally:
        lib.heif_context_free(ctx)


def _exif_from_handle(lib, handle) -> bytes | None:
    """EXIF payload of an image handle's Exif metadata block, or None.
    The stored ExifDataBlock starts with a u32 tiff-header offset; the
    returned bytes are the payload after that field — the same
    APP1-style blob ("Exif\\0\\0" + TIFF) the JPEG paths carry."""
    exif_id = ctypes.c_uint32()
    n = lib.heif_image_handle_get_list_of_metadata_block_IDs(
        handle, b"Exif", ctypes.byref(exif_id), 1)
    if n != 1:
        return None
    size = lib.heif_image_handle_get_metadata_size(handle, exif_id)
    if size <= 4:
        return None
    buf = (ctypes.c_uint8 * size)()
    _check(lib.heif_image_handle_get_metadata(
        handle, exif_id, buf), "get metadata")
    return bytes(buf)[4:]


def extract_exif(data: bytes) -> bytes | None:
    """EXIF payload of the primary image's Exif metadata block, or
    None (heifr.cpp:324-331, ultrahdr.cpp HEIF addImage)."""
    lib = _require()
    ctx = lib.heif_context_alloc()
    try:
        _check(lib.heif_context_read_from_memory_without_copy(
            ctx, data, len(data), None), "read")
        handle = ctypes.c_void_p()
        _check(lib.heif_context_get_primary_image_handle(
            ctx, ctypes.byref(handle)), "primary handle")
        try:
            return _exif_from_handle(lib, handle)
        finally:
            lib.heif_image_handle_release(handle)
    finally:
        lib.heif_context_free(ctx)


def _add_exif(lib, ctx, handle, exif: bytes):
    _check(lib.heif_context_add_exif_metadata(
        ctx, handle, exif, len(exif)), "add exif")


def encode_rgb10(rgb_u16, codec: str, quality: int,
                 transfer: str = "hlg", exif: bytes | None = None,
                 ) -> bytes:
    """Encode (3, H, W) u16 10-bit RGB planes as a 10-bit 4:4:4 HEIF
    with CICP/nclx signaling (BT.2020 primaries + HLG/PQ transfer) —
    the converter's 10-bit HEIC/AVIF output
    (lib/src/ultrahdr.cpp:1207-1287)."""
    lib = _require()
    fmt = COMPRESSION_HEVC if codec == "heic" else COMPRESSION_AV1
    rgb = np.ascontiguousarray(rgb_u16, np.uint16)
    _, h, w = rgb.shape
    ctx = lib.heif_context_alloc()
    try:
        enc = ctypes.c_void_p()
        _check(lib.heif_context_get_encoder_for_format(
            ctx, fmt, ctypes.byref(enc)), "get encoder")
        try:
            _check(lib.heif_encoder_set_lossy_quality(
                enc, int(quality)), "set quality")
            img = ctypes.c_void_p()
            _check(lib.heif_image_create(w, h, COLORSPACE_RGB,
                                         CHROMA_444,
                                         ctypes.byref(img)), "create")
            try:
                for ci, channel in enumerate((CHANNEL_R, CHANNEL_G,
                                              CHANNEL_B)):
                    _check(lib.heif_image_add_plane(
                        img, channel, w, h, 10), "add plane")
                    stride = ctypes.c_int()
                    ptr = lib.heif_image_get_plane(
                        img, channel, ctypes.byref(stride))
                    dst = np.ctypeslib.as_array(
                        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint16)),
                        (h, stride.value // 2))
                    dst[:, :w] = rgb[ci]
                nclx = lib.heif_nclx_color_profile_alloc()
                try:
                    # CICP: BT.2020 primaries (9), HLG (18) / PQ (16),
                    # identity matrix for RGB (0).
                    lib.heif_nclx_color_profile_set_color_primaries(
                        nclx, 9)
                    tc = 18 if transfer == "hlg" else 16
                    (lib.
                     heif_nclx_color_profile_set_transfer_characteristics(
                         nclx, tc))
                    lib.heif_nclx_color_profile_set_matrix_coefficients(
                        nclx, 0)
                    lib.heif_image_set_nclx_color_profile(img, nclx)
                finally:
                    lib.heif_nclx_color_profile_free(nclx)
                handle = ctypes.c_void_p()
                _check(lib.heif_context_encode_image(
                    ctx, img, enc, None, ctypes.byref(handle)), "encode")
                if exif is not None:
                    _add_exif(lib, ctx, handle, exif)
                lib.heif_image_handle_release(handle)
            finally:
                lib.heif_image_release(img)
        finally:
            lib.heif_encoder_release(enc)
        fd, path = tempfile.mkstemp(suffix=".heif")
        os.close(fd)
        try:
            _check(lib.heif_context_write_to_file(
                ctx, path.encode()), "write")
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)
    finally:
        lib.heif_context_free(ctx)


def encode_image(planes, codec: str, quality: int,
                 exif: bytes | None = None) -> bytes:
    """Encode YUV420 (y, cb, cr) or grayscale (y,) numpy planes into a
    standalone HEIF/AVIF file via the system encoder."""
    lib = _require()
    fmt = COMPRESSION_HEVC if codec == "heic" else COMPRESSION_AV1
    mono = len(planes) == 1
    y = np.ascontiguousarray(planes[0], np.uint8)
    h, w = y.shape
    ctx = lib.heif_context_alloc()
    try:
        enc = ctypes.c_void_p()
        _check(lib.heif_context_get_encoder_for_format(
            ctx, fmt, ctypes.byref(enc)), "get encoder")
        try:
            _check(lib.heif_encoder_set_lossy_quality(
                enc, int(quality)), "set quality")
            img = ctypes.c_void_p()
            cs, ch = ((COLORSPACE_MONOCHROME, CHROMA_MONOCHROME)
                      if mono else (COLORSPACE_YCBCR, CHROMA_420))
            _check(lib.heif_image_create(w, h, cs, ch,
                                         ctypes.byref(img)), "create")
            try:
                def put(channel, plane):
                    ph, pw = plane.shape
                    _check(lib.heif_image_add_plane(
                        img, channel, pw, ph, 8), "add plane")
                    stride = ctypes.c_int()
                    ptr = lib.heif_image_get_plane(
                        img, channel, ctypes.byref(stride))
                    dst = np.ctypeslib.as_array(ptr, (ph, stride.value))
                    dst[:, :pw] = plane

                put(CHANNEL_Y, y)
                if not mono:
                    put(CHANNEL_CB,
                        np.ascontiguousarray(planes[1], np.uint8))
                    put(CHANNEL_CR,
                        np.ascontiguousarray(planes[2], np.uint8))
                handle = ctypes.c_void_p()
                _check(lib.heif_context_encode_image(
                    ctx, img, enc, None, ctypes.byref(handle)),
                    "encode")
                if exif is not None:
                    _add_exif(lib, ctx, handle, exif)
                lib.heif_image_handle_release(handle)
            finally:
                lib.heif_image_release(img)
        finally:
            lib.heif_encoder_release(enc)
        fd, path = tempfile.mkstemp(suffix=".heif")
        os.close(fd)
        try:
            _check(lib.heif_context_write_to_file(
                ctx, path.encode()), "write")
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)
    finally:
        lib.heif_context_free(ctx)
