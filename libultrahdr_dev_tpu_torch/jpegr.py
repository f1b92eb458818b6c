"""JpegR codec entry points of the port: the five encode APIs, decode,
info.

Mirrors libultrahdr_dev_tpu/jpegr.py (reference: lib/src/jpegr.cpp):

  API-0 (encode_api0): P010 HDR only            jpegr.cpp:167-247
  API-1 (encode_api1): P010 + YUV420 SDR        jpegr.cpp:250-383
  API-2 (encode_api2): raws + base JPEG         jpegr.cpp:386-435
  API-3 (encode_api3): P010 + base JPEG         jpegr.cpp:438-517
  API-4 (encode_api4): pure mux                 jpegr.cpp:520-561
  API-x (encode_apix): YUV420 + raw gain map    jpegr.cpp:564-622
  decode / get_info                             jpegr.cpp:624-804

A 16-aligned API-0 or API-1 encode without EXIF takes the device route
(parallel/batched.py: B1 or B9, B2, B3, restart markers every 4 MCUs;
dense content as the JAX package writes it: API-0 restart-less through
B19, API-1 on the general route); every other encode takes the general
route, as in the JAX package: B10a tonemap (API-0), B10b gain map, B10c
BT.601 re-encode of the base, and jpeg/codec.py:encode_jpeg (B2, then
B19: no restart markers) for the base and the gain map. A JpegR is
bound to one torch device, the CUDA device unless the caller names
another; its kernels run there
(their plain PyTorch versions on a CPU device). Outputs reach the
caller as numpy arrays: RGBA F16 as (h, w, 4) uint16 halves,
RGBA1010102 and RGBA8888 as (h, w) uint32 words, 10-bit planar RGB as
(3, h, w) uint16 codes; an HDR decode's gain-map plane (h/4, w/4) as
uint8, decoded on first access.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .container import icc as icc_mod
from .container import jfif, mux, xmp
import torch

from .device import resolve_device, upload
from .jpeg import codec
from .ops import gainmap as gm
from .parallel import batched
from .types import (ColorGamut, ColorTransfer, GainMapMetadata,
                    MAP_COMPRESS_QUALITY, MAX_HEIGHT, MAX_WIDTH, MIN_HEIGHT,
                    MIN_WIDTH, OutputFormat, PixelFormat, RawImage, err)

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
    # (3, h, w) 10-bit linear RGB codes (jpegr.py:44, 51).
    OutputFormat.HDR_LINEAR_RGB_10BIT: (PixelFormat.RGB_10BIT_PLANAR,
                                        ColorTransfer.LINEAR, np.uint16),
}


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


def _validate_tf(tf: ColorTransfer):
    if tf not in _TF:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"invalid hdr transfer function {tf}")


def _validate_quality(quality: int):
    if not 0 <= quality <= 100:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"quality {quality} outside [0, 100]")


def _validate_sdr(yuv420: RawImage, p010: RawImage):
    """The SDR raw image of API-1 and API-2 (jpegr.py:269-275)."""
    if yuv420.fmt != PixelFormat.YUV420:
        raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
    if (yuv420.width, yuv420.height) != (p010.width, p010.height):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  "SDR/HDR resolution mismatch")
    if yuv420.gamut not in _GAMUT:
        raise err("UHDR_CODEC_INVALID_PARAM", "unspecified SDR gamut")


def _device_route(p010: RawImage, exif: bytes | None) -> bool:
    """16-aligned frames without EXIF take the device route (B1 / B9,
    B2, B3), as in the JAX package (jpegr.py:245, 285)."""
    return p010.width % 16 == 0 and p010.height % 16 == 0 and exif is None


def _plane(p):
    """A plane as encode_jpeg takes it: a tensor as it is (encoded on its
    device), anything else as a numpy array."""
    return p if isinstance(p, torch.Tensor) else np.asarray(p)


def _compress_gainmap(gmap, device) -> bytes:
    """Grayscale JPEG at the fixed gain-map quality (jpegr.cpp:41,
    806-821)."""
    return codec.encode_jpeg({"y": _plane(gmap)},
                             quality=MAP_COMPRESS_QUALITY, device=device)


def upload_frame(y, uv, sdr, device) -> list:
    """P010 planes (uint16) and SDR planes (uint8, or None) of one frame
    on `device` in one copy, each with a batch dimension of 1: the P010
    samples as int16 of the same bits."""
    arrays = [np.ascontiguousarray(a, np.uint16).view(np.int16)[None]
              for a in (y, uv)]
    arrays += [np.ascontiguousarray(a, np.uint8)[None] for a in (sdr or ())]
    return upload(arrays, device)


@dataclass
class GeneralCoefs:
    """The device stage of a general-route encode: the base's and the
    gain map's JPEG blocks on the device, the gain map's metadata, and
    the base's gamut (named by its ICC)."""

    base: codec.JpegCoefs
    gainmap: codec.JpegCoefs
    metadata: GainMapMetadata
    gamut: str


def general_device_stage(yd, uvd, sdr, sdr_gamut: str, hdr_gamut: str,
                         hdr_tf: str, quality: int) -> GeneralCoefs:
    """The device half of the general route of API-0 (sdr None: B10a's
    tonemap of the P010) and API-1 (jpegr.py:254-261, 298-304): B10b
    gain map, B10c BT.601 re-encode of the base, the padding and B2 of
    both JPEGs. yd, uvd: (1, h, w), (1, h/2, w) int16 P010 planes, sdr:
    (1, h, w), (1, h/2, w/2) uint8 planes, on the device."""
    if sdr is None:
        sdr = gm.tonemap_p010(yd, uvd)
    gmap, metadata = gm.generate_gainmap(*sdr, yd, uvd, sdr_gamut=sdr_gamut,
                                         hdr_gamut=hdr_gamut, hdr_tf=hdr_tf)
    y8, u8, v8 = gm.convert_yuv_encoding(*sdr, sdr_gamut, "p3")
    return GeneralCoefs(
        codec.jpeg_coefs({"y": y8[0], "u": u8[0], "v": v8[0]}, quality),
        codec.jpeg_coefs({"y": gmap[0]}, MAP_COMPRESS_QUALITY), metadata,
        sdr_gamut)


def general_host_stage(c: GeneralCoefs, exif: bytes | None = None) -> bytes:
    """The rest: the gain-map JPEG and the base JPEG with the sRGB ICC
    of its gamut (codec.assemble_jpeg: B19 on the device, the coded
    scans to the host, stuffing and markers; the JAX _compress_gainmap /
    _compress_base, jpegr.py:83-97), then the mux with EXIF."""
    gainmap_jpeg = codec.assemble_jpeg(c.gainmap)
    base_jpeg = codec.assemble_jpeg(
        c.base, icc_mod.write_icc_profile("srgb", c.gamut))
    return mux.append_gainmap(base_jpeg, gainmap_jpeg, c.metadata, exif=exif)


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
    # (host stage frame, device) of an HDR decode, for the gain-map plane.
    _gainmap_parts: tuple | None = None
    _gainmap_cache: np.ndarray | None = None

    @property
    def gainmap(self) -> np.ndarray | None:
        """The decoded uint8 gain-map plane (gh, gw), decoded on first
        access (batched.gainmap_plane) as the JAX result derives it
        (jpegr.py:636-662); None after an SDR decode, whose JAX branch
        keeps no gain-map parts."""
        if self._gainmap_cache is None and self._gainmap_parts is not None:
            self._gainmap_cache = batched.gainmap_plane(
                *self._gainmap_parts).cpu().numpy()
        return self._gainmap_cache

    @gainmap.setter
    def gainmap(self, value):
        self._gainmap_cache = value


class JpegR:
    """Codec entry points on one torch device (mirrors class JpegR,
    lib/include/ultrahdr/jpegr.h:59-368)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def encode_api0(self, p010: RawImage, hdr_tf: ColorTransfer,
                    quality: int = 95, exif: bytes | None = None) -> bytes:
        """API-0: JPEG/R from a P010 HDR frame alone (jpegr.cpp:167-247).
        A 16-aligned frame without EXIF takes the device route, its base
        with restart markers every 4 MCUs, as the JAX package's
        on-device encoder writes it; any other takes the general route
        (B10a tonemap, B10b, B10c, restart-less base and gain map)."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        _validate_quality(quality)
        gamut = _GAMUT[p010.gamut]
        y, uv = (np.asarray(p010.planes[k]) for k in ("y", "uv"))
        if _device_route(p010, exif):
            return batched.batched_encode_api0(
                y[None], uv[None], gamut=gamut, hdr_tf=_TF[hdr_tf],
                quality=quality, device=self.device)[0]
        return self._encode_general(y, uv, None, gamut, gamut, _TF[hdr_tf],
                                    quality, exif)

    def encode_api1(self, p010: RawImage, yuv420: RawImage,
                    hdr_tf: ColorTransfer, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """API-1: JPEG/R from a P010 HDR frame and its YUV420 SDR
        rendition (jpegr.cpp:250-383), validated as the JAX package
        validates them (jpegr.py:263-285). The base is the SDR, re-encoded
        to BT.601: on the device route with restart markers every 4
        MCUs; on the general route (non-16-aligned or EXIF, or dense
        content, which the device route refuses with OverflowError as
        the JAX package's does, jpegr.py:283-297) B10b, B10c and
        restart-less JPEGs."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        _validate_quality(quality)
        _validate_sdr(yuv420, p010)
        sdr_gamut, hdr_gamut = _GAMUT[yuv420.gamut], _GAMUT[p010.gamut]
        y, uv = (np.asarray(p010.planes[k]) for k in ("y", "uv"))
        sdr = [np.asarray(yuv420.planes[k]) for k in ("y", "u", "v")]
        if _device_route(p010, exif):
            try:
                return batched.batched_encode_api1(
                    y[None], uv[None], *(p[None] for p in sdr),
                    sdr_gamut=sdr_gamut, hdr_gamut=hdr_gamut,
                    hdr_tf=_TF[hdr_tf], quality=quality,
                    device=self.device)[0]
            except OverflowError:
                pass
        return self._encode_general(y, uv, sdr, sdr_gamut, hdr_gamut,
                                    _TF[hdr_tf], quality, exif)

    def _gainmap(self, yd, uvd, sdr, sdr_gamut: str, hdr_gamut: str,
                 hdr_tf: str, sdr_is_601: bool = False):
        """B10b's gain map of a frame on the device, compressed:
        (gain-map JPEG, metadata)."""
        gmap, metadata = gm.generate_gainmap(
            *sdr, yd, uvd, sdr_gamut=sdr_gamut, hdr_gamut=hdr_gamut,
            hdr_tf=hdr_tf, sdr_is_601=sdr_is_601)
        return _compress_gainmap(gmap[0], self.device), metadata

    def _encode_general(self, y, uv, sdr, sdr_gamut: str, hdr_gamut: str,
                        hdr_tf: str, quality: int,
                        exif: bytes | None) -> bytes:
        """The general route of API-0 (sdr None) and API-1."""
        yd, uvd, *sdr_d = upload_frame(y, uv, sdr, self.device)
        return general_host_stage(general_device_stage(
            yd, uvd, sdr_d or None, sdr_gamut, hdr_gamut, hdr_tf, quality),
            exif)

    def encode_api2(self, p010: RawImage, yuv420: RawImage,
                    base_jpeg: bytes, hdr_tf: ColorTransfer) -> bytes:
        """API-2: the gain map from the raw pair, the base bitstream used
        as it is (jpegr.cpp:386-435)."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        _validate_sdr(yuv420, p010)
        yd, uvd, *sdr_d = upload_frame(
            p010.planes["y"], p010.planes["uv"],
            [yuv420.planes[k] for k in ("y", "u", "v")], self.device)
        gainmap_jpeg, metadata = self._gainmap(
            yd, uvd, sdr_d, _GAMUT[yuv420.gamut], _GAMUT[p010.gamut],
            _TF[hdr_tf])
        return self.encode_api4(base_jpeg, gainmap_jpeg, metadata)

    def encode_api3(self, p010: RawImage, base_jpeg: bytes,
                    hdr_tf: ColorTransfer) -> bytes:
        """API-3: the SDR rendition is the given JPEG decoded on the
        device (jpeg/codec.py:decode_jpeg); its YUV is BT.601, so the
        gain map is generated with sdr_is_601, in the gamut its ICC
        names, else the HDR's (jpegr.cpp:438-517)."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        dec = codec.decode_jpeg(base_jpeg, self.device)
        if dec.ncomp != 3 or dec.sampling[0] != (2, 2):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "base JPEG must be YCbCr 4:2:0")
        if (dec.width, dec.height) != (p010.width, p010.height):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "JPEG/HDR resolution mismatch")
        gamut = ColorGamut.UNSPECIFIED
        if dec.icc is not None:
            g = icc_mod.read_icc_color_gamut(dec.icc)
            if g != "unspecified":
                gamut = ColorGamut(g)
        if gamut == ColorGamut.UNSPECIFIED:
            gamut = p010.gamut
        yd, uvd = upload_frame(p010.planes["y"], p010.planes["uv"], None,
                               self.device)
        gainmap_jpeg, metadata = self._gainmap(
            yd, uvd, [p[None] for p in dec.planes], _GAMUT[gamut],
            _GAMUT[p010.gamut], _TF[hdr_tf], sdr_is_601=True)
        return self.encode_api4(base_jpeg, gainmap_jpeg, metadata)

    def encode_api4(self, base_jpeg: bytes, gainmap_jpeg: bytes,
                    metadata: GainMapMetadata,
                    exif: bytes | None = None) -> bytes:
        """API-4: pure container mux (jpegr.cpp:520-561)."""
        if not base_jpeg or not gainmap_jpeg:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty bitstream")
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    def encode_apix(self, yuv420: RawImage, gainmap_u8,
                    metadata: GainMapMetadata, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """API-x, the transcode variant: an SDR raw image, a raw gain map
        and its metadata, each compressed as it is (jpegr.cpp:564-622).
        Planes may be numpy arrays (encoded on this JpegR's device) or
        torch tensors (encoded where they lie, with no host copy)."""
        _validate_quality(quality)
        if yuv420.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
        gainmap_jpeg = _compress_gainmap(gainmap_u8, self.device)
        gamut = _GAMUT.get(yuv420.gamut)
        icc = icc_mod.write_icc_profile("srgb", gamut) if gamut else None
        base_jpeg = codec.encode_jpeg(
            {k: _plane(yuv420.planes[k]) for k in ("y", "u", "v")},
            quality=quality, icc=icc, device=self.device)
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    def get_info(self, jpegr_bytes: bytes) -> JpegRInfo:
        """Container split + header parse without pixel decode
        (jpegr.cpp:624-653 getJPEGRInfo)."""
        primary, gmap = mux.read_primary_and_gainmap(jpegr_bytes)
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
               use_luts: bool = False,
               pixels_on_device: bool = False) -> JpegRDecodeResult:
        """Decode to HDR or SDR pixels (jpegr.cpp:655-804). The device
        route first, as the JAX _decode_device_path: a host parse and
        destuff, one upload, then Huffman decode (B4), dequant + IDCT
        (B5) and gain-map apply (B6, or B11 with use_luts) on the device;
        SDR output decodes the base alone and converts it (B7), reading
        nothing of the gain map. Streams whose headers the device
        decoder does not take are Huffman-decoded on the host, which
        raises the reference's errors for what it cannot decode. An HDR
        result's `gainmap` is the decoded gain-map plane, on first
        access. The pixels come to the host as numpy, or with
        pixels_on_device stay a tensor on the device (int32 words, int16
        F16 halves)."""
        if max_display_boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"bad max_display_boost {max_display_boost}")
        frame, = batched.decode_host_stage([jpegr_bytes],
                                           output_format.value)
        out = batched.decode_device_stage(
            [frame], output_format.value, max_display_boost, self.device,
            use_luts)
        fmt, transfer, dtype = _OUT[output_format]
        result = JpegRDecodeResult(width=frame.width, height=frame.height,
                                   metadata=frame.metadata, exif=frame.exif,
                                   icc=frame.icc)
        if output_format != OutputFormat.SDR:
            result._gainmap_parts = (frame, self.device)
        if frame.icc is not None:
            g = icc_mod.read_icc_color_gamut(frame.icc)
            if g != "unspecified":
                result.gamut = ColorGamut(g)
        result.image = RawImage(
            fmt=fmt, width=frame.width, height=frame.height,
            gamut=result.gamut, transfer=transfer,
            planes={"rgba": out[0] if pixels_on_device
                    else out[0].cpu().numpy().view(dtype)})
        return result
