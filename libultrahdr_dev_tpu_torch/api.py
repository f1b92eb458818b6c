"""Stable codec API of the port: staged encoder/decoder contexts.

Mirrors libultrahdr_dev_tpu/api.py (the reference's ultrahdr_api.h,
lib/src/ultrahdr_api.cpp): contexts are configured through setters, and
one encode/decode "sails" the context (further configuration raises,
repeated calls return the first outcome). Each context runs its kernels
on the torch device it was built with, the CUDA device unless the caller
names another.

API selection in encode() follows ultrahdr_api.cpp:695-804, as the JAX
package does (api.py:163-187):
  base + gain map compressed          -> API-4
  HDR raw only                        -> API-0
  HDR raw + SDR compressed            -> API-3
  HDR raw + SDR raw                   -> API-1
  HDR raw + SDR raw + SDR compressed  -> API-2
EXIF (set_exif_data) goes with API-0, API-1 and API-4, where the JAX
package passes it.
"""

from __future__ import annotations

import numpy as np

from .container import mux
from .device import resolve_device
from .jpegr import JpegR
from .types import (ColorGamut, ColorTransfer, CompressedImage,
                    DEFAULT_BASE_QUALITY, GainMapMetadata, OutputFormat,
                    PixelFormat, RawImage, err)

# Intent labels (ultrahdr_api.h:86-91).
HDR_IMG = "hdr"
SDR_IMG = "sdr"
BASE_IMG = "base"
GAIN_MAP_IMG = "gainmap"


class _Sailed:
    """Shared sailed-state machinery (ultrahdr_api.cpp:253-260)."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._sailed = False
        self._outcome: Exception | None = None

    def _check_not_sailed(self, what: str):
        if self._sailed:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      f"{what} not allowed after encode/decode; "
                      "call reset() first")


class UhdrEncoder(_Sailed):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self.reset()

    def reset(self):
        """uhdr_reset_encoder (ultrahdr_api.cpp:834-853)."""
        self._sailed = False
        self._outcome = None
        self._raw: dict[str, RawImage] = {}
        self._compressed: dict[str, CompressedImage] = {}
        self._quality = {BASE_IMG: DEFAULT_BASE_QUALITY}
        self._exif: bytes | None = None
        self._gainmap_metadata: GainMapMetadata | None = None
        self._output: bytes | None = None
        return self

    def set_raw_image(self, img: RawImage, intent: str):
        """uhdr_enc_set_raw_image (ultrahdr_api.h:223-243): the HDR
        intent takes P010, the SDR intent YUV420."""
        self._check_not_sailed("set_raw_image")
        if intent not in (HDR_IMG, SDR_IMG):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"invalid intent {intent} for raw image")
        if intent == HDR_IMG and img.fmt != PixelFormat.P010:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "hdr intent requires P010 input")
        if intent == SDR_IMG and img.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "sdr intent requires YUV420 input")
        img.validate_even_dims()
        if img.gamut == ColorGamut.UNSPECIFIED:
            raise err("UHDR_CODEC_INVALID_PARAM", "unspecified gamut")
        if intent == HDR_IMG and img.transfer not in (
                ColorTransfer.LINEAR, ColorTransfer.HLG, ColorTransfer.PQ):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "hdr intent requires linear/hlg/pq transfer")
        self._raw[intent] = img
        return self

    def set_compressed_image(self, img: CompressedImage, intent: str):
        """uhdr_enc_set_compressed_image (ultrahdr_api.h:245-263): HDR,
        SDR and base intents, as the reference accepts them
        (ultrahdr_api.cpp:485-500); a compressed HDR image is stored,
        and no encode route reads it, as in the JAX package."""
        self._check_not_sailed("set_compressed_image")
        if intent not in (HDR_IMG, SDR_IMG, BASE_IMG):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"invalid intent {intent} for compressed image")
        if not img.data:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty bitstream")
        self._compressed[intent] = img
        return self

    def set_gainmap_image(self, img: CompressedImage,
                          metadata: GainMapMetadata):
        """uhdr_enc_set_gainmap_image: a compressed gain map and its
        metadata, for the API-4 mux."""
        self._check_not_sailed("set_gainmap_image")
        if not img.data:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty bitstream")
        self._compressed[GAIN_MAP_IMG] = img
        self._gainmap_metadata = metadata
        return self

    def set_quality(self, quality: int, intent: str = BASE_IMG):
        """uhdr_enc_set_quality (ultrahdr_api.h:274-283): stored for any
        intent, as the JAX package stores it. Only the base quality is
        read; the gain map is coded at its fixed quality 85
        (MAP_COMPRESS_QUALITY) on every route, as in the JAX package."""
        self._check_not_sailed("set_quality")
        if not 0 <= quality <= 100:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"quality {quality} outside [0, 100]")
        self._quality[intent] = quality
        return self

    def set_output_format(self, media_type: str):
        """uhdr_enc_set_output_format: only "jpg" is valid."""
        if media_type != "jpg":
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"invalid output format {media_type}, "
                      "expects {jpg}")
        self._check_not_sailed("set_output_format")
        return self

    def set_exif_data(self, exif: bytes):
        """uhdr_enc_set_exif_data: EXIF for the primary image."""
        self._check_not_sailed("set_exif_data")
        if not exif:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty exif")
        self._exif = exif
        return self

    def encode(self) -> CompressedImage:
        """uhdr_encode (ultrahdr_api.cpp:666-819), dispatched as the
        module docstring says. Repeat calls return the first outcome."""
        if self._sailed:
            if self._outcome is not None:
                raise self._outcome
            return self.get_encoded_stream()
        self._sailed = True
        try:
            self._output = self._dispatch()
        except Exception as e:
            self._outcome = e
            raise
        return self.get_encoded_stream()

    def _dispatch(self) -> bytes:
        jr = JpegR(self.device)
        quality = self._quality.get(BASE_IMG, DEFAULT_BASE_QUALITY)
        if BASE_IMG in self._compressed and GAIN_MAP_IMG in self._compressed:
            if self._gainmap_metadata is None:
                raise err("UHDR_CODEC_INVALID_OPERATION",
                          "gain map metadata not set")
            return jr.encode_api4(self._compressed[BASE_IMG].data,
                                  self._compressed[GAIN_MAP_IMG].data,
                                  self._gainmap_metadata, exif=self._exif)
        if HDR_IMG in self._raw:
            hdr = self._raw[HDR_IMG]
            tf = hdr.transfer
            raw_sdr = SDR_IMG in self._raw
            jpeg_sdr = SDR_IMG in self._compressed
            if not raw_sdr and not jpeg_sdr:
                return jr.encode_api0(hdr, tf, quality, exif=self._exif)
            if jpeg_sdr and not raw_sdr:
                return jr.encode_api3(hdr, self._compressed[SDR_IMG].data,
                                      tf)
            if raw_sdr and not jpeg_sdr:
                return jr.encode_api1(hdr, self._raw[SDR_IMG], tf, quality,
                                      exif=self._exif)
            return jr.encode_api2(hdr, self._raw[SDR_IMG],
                                  self._compressed[SDR_IMG].data, tf)
        raise err("UHDR_CODEC_INVALID_OPERATION",
                  "resources required for encode() are not present")

    def get_encoded_stream(self) -> CompressedImage:
        if self._output is None:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      "no encoded stream available")
        return CompressedImage(data=self._output,
                               gamut=ColorGamut.UNSPECIFIED)


class UhdrDecoder(_Sailed):
    def __init__(self, device="cuda", pixels_on_device: bool = False):
        """pixels_on_device: decode() leaves planes["rgba"] a tensor on
        the device (int32 words or int16 F16 halves), for the caller to
        read back itself (parallel/link.py fetch_pixels_packed), as the
        JAX decoder leaves a device array."""
        super().__init__(device)
        self.pixels_on_device = pixels_on_device
        self.reset()

    def reset(self):
        """uhdr_reset_decoder (ultrahdr_api.cpp:1281-1309)."""
        self._sailed = False
        self._outcome = None
        self._probed = False
        self._input: bytes | None = None
        # Defaults: F16 linear output (ultrahdr_api.cpp:1287-1289).
        self._out_fmt = PixelFormat.RGBA_F16
        self._out_ct = ColorTransfer.LINEAR
        self._boost = float("inf")
        self._info = None
        self._result = None
        return self

    def set_image(self, data: bytes):
        self._check_not_sailed("set_image")
        if not data:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty input")
        self._input = bytes(data)
        self._probed = False
        return self

    def set_out_img_format(self, fmt: PixelFormat):
        self._check_not_sailed("set_out_img_format")
        if fmt not in (PixelFormat.RGBA8888, PixelFormat.RGBA_F16,
                       PixelFormat.RGBA1010102):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"invalid output format {fmt}")
        self._out_fmt = fmt
        return self

    def set_out_color_transfer(self, ct: ColorTransfer):
        self._check_not_sailed("set_out_color_transfer")
        if ct not in (ColorTransfer.LINEAR, ColorTransfer.HLG,
                      ColorTransfer.PQ, ColorTransfer.SRGB):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"invalid output transfer {ct}")
        self._out_ct = ct
        return self

    def set_out_max_display_boost(self, boost: float):
        self._check_not_sailed("set_out_max_display_boost")
        if boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"invalid display boost {boost}")
        self._boost = boost
        return self

    def probe(self):
        """uhdr_dec_probe (ultrahdr_api.cpp:1038-1108); idempotent."""
        if self._probed:
            return self._info
        if self._input is None:
            raise err("UHDR_CODEC_INVALID_OPERATION", "no input image set")
        self._info = JpegR(self.device).get_info(self._input)
        if self._info.metadata is None:
            raise err("UHDR_CODEC_ERROR", "could not parse gain map XMP")
        self._probed = True
        return self._info

    def get_image_width(self) -> int:
        return self.probe().width

    def get_image_height(self) -> int:
        return self.probe().height

    def get_gainmap_width(self) -> int:
        return self.probe().gainmap_width

    def get_gainmap_height(self) -> int:
        return self.probe().gainmap_height

    def get_exif(self) -> bytes | None:
        return self.probe().primary.exif

    def get_icc(self) -> bytes | None:
        return self.probe().primary.icc

    def get_gainmap_metadata(self) -> GainMapMetadata:
        return self.probe().metadata

    def _output_format(self) -> OutputFormat:
        """Validated (fmt, ct) pairing (ultrahdr_api.cpp:1201-1253):
        srgb<->rgba8888, linear<->F16, hlg/pq<->1010102."""
        ct, fmt = self._out_ct, self._out_fmt
        if ct == ColorTransfer.SRGB and fmt == PixelFormat.RGBA8888:
            return OutputFormat.SDR
        if ct == ColorTransfer.LINEAR and fmt == PixelFormat.RGBA_F16:
            return OutputFormat.HDR_LINEAR
        if ct == ColorTransfer.HLG and fmt == PixelFormat.RGBA1010102:
            return OutputFormat.HDR_HLG
        if ct == ColorTransfer.PQ and fmt == PixelFormat.RGBA1010102:
            return OutputFormat.HDR_PQ
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"unsupported output combination {fmt}/{ct}")

    def decode(self) -> RawImage:
        """uhdr_decode (ultrahdr_api.cpp:1201-1253)."""
        if self._sailed:
            if self._outcome is not None:
                raise self._outcome
            return self._result.image
        self.probe()
        self._sailed = True
        try:
            self._result = JpegR(self.device).decode(
                self._input, self._output_format(), self._boost,
                pixels_on_device=self.pixels_on_device)
        except Exception as e:
            self._outcome = e
            raise
        return self._result.image

    def get_decoded_image(self) -> RawImage:
        if self._result is None:
            raise err("UHDR_CODEC_INVALID_OPERATION", "decode() not called")
        return self._result.image

    def get_gain_map_image(self) -> np.ndarray:
        """uhdr_get_gain_map_image: the decoded uint8 gain-map plane of
        an HDR decode (JpegRDecodeResult.gainmap; api.py:326-330)."""
        if self._result is None or self._result.gainmap is None:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      "no gain map image available")
        return self._result.gainmap


def is_uhdr_image(data: bytes) -> bool:
    """ultrahdr_api.cpp:855-881."""
    return mux.is_uhdr_image(data)
