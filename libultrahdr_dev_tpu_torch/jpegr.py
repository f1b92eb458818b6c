"""JpegR codec entry points of the port: API-0 and API-1 encode,
decode, info.

Mirrors libultrahdr_dev_tpu/jpegr.py for the slice the port covers
(reference: lib/src/jpegr.cpp:167-383 encode, 624-804 info/decode). A
JpegR is bound to one torch device, the CUDA device unless the caller
names another; its kernels run there (their plain PyTorch versions on
a CPU device). Outputs reach the caller as numpy arrays: RGBA F16 as
(h, w, 4) uint16 halves, RGBA1010102 and RGBA8888 as (h, w) uint32
words.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .container import icc as icc_mod
from .container import jfif, mux, xmp
from .parallel import batched
from .types import (ColorGamut, ColorTransfer, GainMapMetadata, MAX_HEIGHT,
                    MAX_WIDTH, MIN_HEIGHT, MIN_WIDTH, OutputFormat,
                    PixelFormat, RawImage, err)

_GAMUT = {ColorGamut.BT709: "bt709", ColorGamut.P3: "p3",
          ColorGamut.BT2100: "bt2100"}
_TF = {ColorTransfer.LINEAR: "linear", ColorTransfer.HLG: "hlg",
       ColorTransfer.PQ: "pq"}
_OUT = {
    OutputFormat.HDR_LINEAR: (PixelFormat.RGBA_F16, ColorTransfer.LINEAR,
                              np.uint16),
    OutputFormat.HDR_PQ: (PixelFormat.RGBA1010102, ColorTransfer.PQ,
                          np.uint32),
    OutputFormat.HDR_HLG: (PixelFormat.RGBA1010102, ColorTransfer.HLG,
                           np.uint32),
    # The JAX SDR branch leaves the transfer unspecified (jpegr.py:461).
    OutputFormat.SDR: (PixelFormat.RGBA8888, ColorTransfer.UNSPECIFIED,
                       np.uint32),
}
_QUEUED_ENCODE = ("is queued in ROADMAP.md Queue A item 10 (the B10 "
                  "routes); the port encodes 16-aligned frames without EXIF")
_QUEUED_DECODE = {OutputFormat.HDR_LINEAR_RGB_10BIT:
                  "item 13 (off-path decode formats)"}


def _validate_p010(img: RawImage):
    if img.fmt != PixelFormat.P010:
        raise err("UHDR_CODEC_INVALID_PARAM", "expected P010 input")
    if img.width % 2 or img.height % 2:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"odd dimensions {img.width}x{img.height}")
    if img.width < MIN_WIDTH or img.height < MIN_HEIGHT:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"image too small {img.width}x{img.height}")
    if img.width > MAX_WIDTH or img.height > MAX_HEIGHT:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"image too large {img.width}x{img.height}")
    if img.gamut not in _GAMUT:
        raise err("UHDR_CODEC_INVALID_PARAM", "unspecified color gamut")


def _validate_tf_quality(hdr_tf: ColorTransfer, quality: int):
    if hdr_tf not in _TF:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"invalid hdr transfer function {hdr_tf}")
    if not 0 <= quality <= 100:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"quality {quality} outside [0, 100]")


def _check_device_route(p010: RawImage, exif: bytes | None):
    """The port encodes on the device route alone: 16-aligned frames
    without EXIF."""
    if p010.width % 16 or p010.height % 16:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"a {p010.width}x{p010.height} frame {_QUEUED_ENCODE}")
    if exif is not None:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"EXIF on encode {_QUEUED_ENCODE}")


@dataclass
class JpegRInfo:
    width: int
    height: int
    gainmap_width: int
    gainmap_height: int
    primary: object = None
    gainmap: object = None
    metadata: GainMapMetadata | None = None


@dataclass
class JpegRDecodeResult:
    width: int
    height: int
    image: RawImage | None = None
    metadata: GainMapMetadata | None = None
    exif: bytes | None = None
    icc: bytes | None = None
    gamut: ColorGamut = ColorGamut.UNSPECIFIED


class JpegR:
    """Codec entry points on one torch device (mirrors class JpegR,
    lib/include/ultrahdr/jpegr.h:59-368)."""

    def __init__(self, device="cuda"):
        self.device = batched.resolve_device(device)

    def encode_api0(self, p010: RawImage, hdr_tf: ColorTransfer,
                    quality: int = 95, exif: bytes | None = None) -> bytes:
        """API-0: JPEG/R from a P010 HDR frame alone (jpegr.cpp:167-247).
        The base carries restart markers every 4 MCUs, as the JAX
        package's on-device encoder writes it."""
        _validate_p010(p010)
        _validate_tf_quality(hdr_tf, quality)
        _check_device_route(p010, exif)
        return batched.batched_encode_api0(
            np.asarray(p010.planes["y"])[None],
            np.asarray(p010.planes["uv"])[None], gamut=_GAMUT[p010.gamut],
            hdr_tf=_TF[hdr_tf], quality=quality, device=self.device)[0]

    def encode_api1(self, p010: RawImage, yuv420: RawImage,
                    hdr_tf: ColorTransfer, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """API-1: JPEG/R from a P010 HDR frame and its YUV420 SDR
        rendition (jpegr.cpp:250-383), validated as the JAX package
        validates them (jpegr.py:263-285). The base is the SDR, re-encoded
        to BT.601, with restart markers every 4 MCUs."""
        _validate_p010(p010)
        _validate_tf_quality(hdr_tf, quality)
        if yuv420.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
        if (yuv420.width, yuv420.height) != (p010.width, p010.height):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "SDR/HDR resolution mismatch")
        if yuv420.gamut not in _GAMUT:
            raise err("UHDR_CODEC_INVALID_PARAM", "unspecified SDR gamut")
        _check_device_route(p010, exif)
        return batched.batched_encode_api1(
            *(np.asarray(p010.planes[k])[None] for k in ("y", "uv")),
            *(np.asarray(yuv420.planes[k])[None] for k in ("y", "u", "v")),
            sdr_gamut=_GAMUT[yuv420.gamut], hdr_gamut=_GAMUT[p010.gamut],
            hdr_tf=_TF[hdr_tf], quality=quality, device=self.device)[0]

    def get_info(self, jpegr_bytes: bytes) -> JpegRInfo:
        """Container split + header parse without pixel decode
        (jpegr.cpp:624-653 getJPEGRInfo)."""
        primary, gmap = mux.extract_primary_and_gainmap(jpegr_bytes)
        pinfo = jfif.parse_jpeg_info(primary)
        ginfo = jfif.parse_jpeg_info(gmap)
        metadata = None
        if ginfo.xmp is not None:
            try:
                metadata = xmp.get_metadata_from_xmp(ginfo.xmp)
            except Exception:
                metadata = None
        return JpegRInfo(width=pinfo.width, height=pinfo.height,
                         gainmap_width=ginfo.width,
                         gainmap_height=ginfo.height,
                         primary=pinfo, gainmap=ginfo, metadata=metadata)

    def decode(self, jpegr_bytes: bytes,
               output_format: OutputFormat = OutputFormat.HDR_LINEAR,
               max_display_boost: float = float("inf"),
               use_luts: bool = False) -> JpegRDecodeResult:
        """Decode to HDR or SDR pixels (jpegr.cpp:655-804). The device
        route first, as the JAX _decode_device_path: a host parse and
        destuff, one upload, then Huffman decode (B4), dequant + IDCT
        (B5) and gain-map apply (B6, or B11 with use_luts) on the device;
        SDR output decodes the base alone and converts it (B7), reading
        nothing of the gain map. Streams whose headers the device
        decoder does not take are Huffman-decoded on the host, which
        raises the reference's errors for what it cannot decode."""
        if max_display_boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"bad max_display_boost {max_display_boost}")
        if output_format not in _OUT:
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"decode to {output_format.value} is queued in "
                      f"ROADMAP.md Queue A {_QUEUED_DECODE[output_format]}")
        frame, = batched.decode_host_stage([jpegr_bytes],
                                           output_format.value)
        out = batched.decode_device_stage(
            [frame], output_format.value, max_display_boost, self.device,
            use_luts)
        fmt, transfer, dtype = _OUT[output_format]
        result = JpegRDecodeResult(width=frame.width, height=frame.height,
                                   metadata=frame.metadata, exif=frame.exif,
                                   icc=frame.icc)
        if frame.icc is not None:
            g = icc_mod.read_icc_color_gamut(frame.icc)
            if g != "unspecified":
                result.gamut = ColorGamut(g)
        result.image = RawImage(
            fmt=fmt, width=frame.width, height=frame.height,
            gamut=result.gamut, transfer=transfer,
            planes={"rgba": out[0].cpu().numpy().view(dtype)})
        return result
