"""UltraHdr converter session of the port: ingest JPEG/R, JPEG or raw
planes, apply an effect chain on the device, produce a JPEG/R, a JPEG
or raw pixels.

Mirrors libultrahdr_dev_tpu/ultrahdr.py (reference: the dev fork's
converter, ultrahdr.h:243-331, ultrahdr.cpp:578-1505): add_image sniffs
JPEG vs JPEG/R, add_raw takes P010 or YUV420, add_gainmap a raw gain
map; the session decodes or tone-maps lazily and converts with the same
priority chain and errors as the JAX package.

Planes live on the session's torch device (the CUDA device unless the
caller passes another): a JPEG or JPEG/R is decoded there
(jpeg/codec.py:decode_jpeg, B4 + B5), a P010 frame is tone-mapped and
its gain map generated there (B10a, B10b), effects run there (B13,
ops/editor.py), and encodes run there (B2 and B19, then the host's
stuffing, markers and mux: JpegR.encode_apix, codec.encode_jpeg). Raw
outputs are computed there (B6 / B11 for HDR, B7 for RGBA8888) and
reach the caller as numpy arrays. What the session derives itself
(decodes, tone maps, gain maps) stays on the device as tensors; planes
a caller passes as numpy arrays are read again by each convert and
convert_to_raw, as the JAX session reads them, and uploaded once per
call; API-1 and API-2 without effects take the session's SDR as the
JAX JpegR takes it, on the host.

HEIC / AVIF input and output (the JAX package's HeifR arms) raise
UHDR_CODEC_UNSUPPORTED_FEATURE: they are queued in ROADMAP.md Queue A
("The converter's HEIF/AVIF arms").
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .container import icc as icc_mod
from .container import jfif, mux, xmp
from .device import resolve_device, upload
from .jpeg import codec
from .jpegr import _OUT, JpegR, upload_frame
from .ops import editor, gainmap as gm
from .types import (ColorGamut, ColorTransfer, GainMapMetadata,
                    OutputFormat, PixelFormat, RawImage, err)

_HEIF_QUEUED = ("is queued in ROADMAP.md Queue A, \"The converter's "
                "HEIF/AVIF arms\"")


def sniff_format(data: bytes) -> str:
    """JPEG / JPEG_R / HEIF container sniffing (ultrahdr.cpp:69-129)."""
    if len(data) >= 3 and data[0] == 0xFF and data[1] == 0xD8:
        return "jpeg_r" if mux.is_uhdr_image(data) else "jpeg"
    if len(data) >= 12 and data[4:8] == b"ftyp":
        brand = data[8:12]
        if brand in (b"avif", b"avis"):
            return "avif"
        if brand in (b"heic", b"heix", b"heim", b"heis", b"mif1",
                     b"hevc", b"hevx", b"hevm", b"hevs", b"msf1"):
            return "heic"
    return "unknown"


@dataclass
class UltraHdrConfig:
    """ultrahdr_configuration (ultrahdr.h:222-241)."""

    # Output codec names map 1:1 onto ultrahdr_codec (ultrahdr.h:79-88):
    #   jpeg | jpeg_r | heic | heic_r | heic_10bit | avif | avif_r |
    #   avif_10bit   (raw pixels go via convert_to_raw()).
    output_codec: str = "jpeg_r"
    quality: int = 95
    gamut: ColorGamut = ColorGamut.BT709
    transfer: ColorTransfer = ColorTransfer.HLG
    effects: list = field(default_factory=list)
    max_display_boost: float = float("inf")
    output_format: OutputFormat = OutputFormat.HDR_LINEAR
    # For convert_to_raw: explicit raw output layout (P010 / YUV420
    # passthrough outputs, ultrahdr.cpp:1296-1441); None derives the
    # layout from output_format.
    output_pixel_format: PixelFormat | None = None


def _host_image(img: RawImage) -> RawImage:
    """`img` with numpy planes (tensor planes copied to the host)."""
    return replace(img, planes={
        k: p.cpu().numpy() if isinstance(p, torch.Tensor) else p
        for k, p in img.planes.items()})


class UltraHdr:
    """Converter session: add_image / add_raw, then convert()."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.sdr_jpeg: bytes | None = None
        self.sdr_raw: RawImage | None = None
        self.hdr_raw: RawImage | None = None
        self.gainmap_jpeg: bytes | None = None
        self.gainmap_raw = None          # 2-D uint8 plane
        self.metadata: GainMapMetadata | None = None
        self.exif: bytes | None = None
        self._dev_cache: dict = {}

    # ------------------------------------------------------------------
    # Ingest (ultrahdr.cpp:578-808 addImage)
    # ------------------------------------------------------------------

    def add_image(self, data: bytes):
        kind = sniff_format(data)
        if kind == "jpeg":
            self.sdr_jpeg = data
            info = jfif.parse_jpeg_info(data)
            if info.exif is not None:
                self.exif = info.exif
            return self
        if kind == "jpeg_r":
            primary, gmap = mux.extract_primary_and_gainmap(data)
            self.sdr_jpeg = primary
            self.gainmap_jpeg = gmap
            ginfo = jfif.parse_jpeg_info(gmap)
            if ginfo.xmp is not None:
                self.metadata = xmp.get_metadata_from_xmp(ginfo.xmp)
            self.gainmap_raw = codec.decode_jpeg(gmap, self.device).planes[0]
            pinfo = jfif.parse_jpeg_info(primary)
            if pinfo.exif is not None:
                self.exif = pinfo.exif
            return self
        if kind in ("heic", "avif"):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"{kind} input {_HEIF_QUEUED}")
        raise err("UHDR_CODEC_INVALID_PARAM", "unrecognized image format")

    def add_raw(self, img: RawImage):
        if img.fmt == PixelFormat.P010:
            self.hdr_raw = img
        elif img.fmt == PixelFormat.YUV420:
            self.sdr_raw = img
        else:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"unsupported raw format {img.fmt}")
        return self

    def add_gainmap(self, gainmap_u8, metadata: GainMapMetadata):
        self.gainmap_raw = (gainmap_u8 if isinstance(gainmap_u8, torch.Tensor)
                            else np.asarray(gainmap_u8))
        self.metadata = metadata
        return self

    # ------------------------------------------------------------------
    # Planes on the device
    # ------------------------------------------------------------------

    def _cached(self, key, src, make):
        """make(src), kept while the session's `key` is still `src`,
        within one convert or convert_to_raw call: each call starts with
        an empty cache, so a caller's planes edited in place between
        calls are read again."""
        hit = self._dev_cache.get(key)
        if hit is None or hit[0] is not src:
            hit = (src, make(src))
            self._dev_cache[key] = hit
        return hit[1]

    def _sdr_dev(self) -> RawImage:
        """The SDR rendition with its planes on the session's device."""
        def make(img):
            names = [k for k in ("y", "u", "v") if k in img.planes]
            if all(isinstance(img.planes[k], torch.Tensor) for k in names):
                planes = [img.planes[k].to(self.device) for k in names]
            else:
                planes = upload([np.ascontiguousarray(
                    img.planes[k], np.uint8) for k in names], self.device)
            return replace(img, planes=dict(zip(names, planes)))
        return self._cached("sdr", self.sdr_raw, make)

    def _hdr_dev(self):
        """The P010 frame's planes on the device: (1, h, w), (1, h/2, w)
        int16 of the uint16 bits."""
        return self._cached("hdr", self.hdr_raw, lambda img: upload_frame(
            img.planes["y"], img.planes["uv"], None, self.device))

    def _gainmap_dev(self) -> torch.Tensor:
        def make(g):
            if isinstance(g, torch.Tensor):
                return g.to(self.device)
            return torch.from_numpy(np.array(g, np.uint8)).to(self.device)
        return self._cached("gainmap", self.gainmap_raw, make)

    # ------------------------------------------------------------------
    # Lazy derivations (ultrahdr.cpp:1443-1505)
    # ------------------------------------------------------------------

    def _maybe_decode_jpeg_sdr(self):
        if self.sdr_raw is None and self.sdr_jpeg is not None:
            dec = codec.decode_jpeg(self.sdr_jpeg, self.device)
            if dec.ncomp != 3:
                raise err("UHDR_CODEC_ERROR", "SDR JPEG is not YCbCr")
            gamut = ColorGamut.UNSPECIFIED
            if dec.icc is not None:
                g = icc_mod.read_icc_color_gamut(dec.icc)
                if g != "unspecified":
                    gamut = ColorGamut(g)
            self.sdr_raw = RawImage(
                fmt=PixelFormat.YUV420, width=dec.width, height=dec.height,
                gamut=gamut, transfer=ColorTransfer.SRGB,
                planes={"y": dec.planes[0], "u": dec.planes[1],
                        "v": dec.planes[2]})

    def _maybe_tonemap_raw_hdr(self):
        if self.sdr_raw is None and self.hdr_raw is not None:
            y8, u8, v8 = gm.tonemap_p010(*self._hdr_dev())
            self.sdr_raw = RawImage(
                fmt=PixelFormat.YUV420, width=self.hdr_raw.width,
                height=self.hdr_raw.height, gamut=self.hdr_raw.gamut,
                transfer=ColorTransfer.SRGB,
                planes={"y": y8[0], "u": u8[0], "v": v8[0]})

    def _gainmap_as_image(self) -> RawImage:
        g = self._gainmap_dev()
        return RawImage(fmt=PixelFormat.MONOCHROME, width=g.shape[1],
                        height=g.shape[0], planes={"y": g})

    def _edited(self, effects):
        """(SDR, gain map) on the device with the chain applied, the gain
        map's chain scaled to its resolution (ultrahdr.cpp:997-1009)."""
        sdr = editor.apply_effects(self._sdr_dev(), effects)
        gmap = self._gainmap_as_image()
        if effects:
            scale = self.sdr_raw.width // gmap.width
            gmap = editor.apply_effects(
                gmap, editor.scale_effects(effects, scale))
        return sdr, gmap.planes["y"]

    # ------------------------------------------------------------------
    # Convert (ultrahdr.cpp:866-1441)
    # ------------------------------------------------------------------

    def convert(self, config: UltraHdrConfig) -> bytes:
        self._dev_cache.clear()
        if config.output_codec == "jpeg":
            return self._convert_to_jpeg(config)
        if config.output_codec == "jpeg_r":
            return self._convert_to_jpegr(config)
        if config.output_codec in ("heic", "heic_r", "heic_10bit", "avif",
                                   "avif_r", "avif_10bit"):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"{config.output_codec} output {_HEIF_QUEUED}")
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"unknown output codec {config.output_codec}")

    def _sdr_or_raise(self):
        self._maybe_decode_jpeg_sdr()
        self._maybe_tonemap_raw_hdr()
        if self.sdr_raw is None:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      "no SDR rendition available")

    def convert_to_raw(self, config: UltraHdrConfig) -> RawImage:
        """Raw-pixel outputs (ultrahdr.cpp:1296-1441), computed from the
        session's planes on the device, effects honored, numpy planes:

          P010          - HDR passthrough (requires a raw HDR input)
          YUV420        - SDR rendition + effects (B13)
          RGBA8888/SDR  - SDR rendition + effects, packed (B7)
          F16/1010102/10-bit planar - gain-map reconstruction (B6 / B11)
        """
        self._dev_cache.clear()
        fmt = config.output_pixel_format
        if fmt == PixelFormat.P010:
            if self.hdr_raw is None:
                raise err("UHDR_CODEC_INVALID_OPERATION",
                          "no raw HDR input for P010 output")
            return self.hdr_raw
        if fmt == PixelFormat.YUV420:
            self._sdr_or_raise()
            return _host_image(editor.apply_effects(self._sdr_dev(),
                                                    config.effects))
        if (config.output_format == OutputFormat.SDR
                or fmt == PixelFormat.RGBA8888):
            self._sdr_or_raise()
            img = editor.apply_effects(self._sdr_dev(), config.effects)
            rgba = gm.yuv420_to_rgba8888(
                *(img.planes[k][None] for k in ("y", "u", "v")))
            return RawImage(fmt=PixelFormat.RGBA8888, width=img.width,
                            height=img.height, gamut=img.gamut,
                            planes={"rgba": rgba[0].cpu().numpy()
                                    .view(np.uint32)})

        # HDR reconstruction: base + gain map through the apply kernel at
        # the requested output format.
        self._sdr_or_raise()
        self._ensure_gainmap(config)
        sdr, gmap = self._edited(config.effects)
        out_fmt = config.output_format
        if fmt == PixelFormat.RGB_10BIT_PLANAR:
            out_fmt = OutputFormat.HDR_LINEAR_RGB_10BIT
        out = gm.apply_gainmap_metadata(
            sdr.planes["y"], sdr.planes["u"], sdr.planes["v"], gmap,
            self.metadata, out_fmt.value, config.max_display_boost)
        pixel_fmt, transfer, dtype = _OUT[out_fmt]
        return RawImage(fmt=pixel_fmt, width=sdr.width, height=sdr.height,
                        gamut=sdr.gamut, transfer=transfer,
                        planes={"rgba": out.cpu().numpy().view(dtype)})

    def _convert_to_jpeg(self, config: UltraHdrConfig) -> bytes:
        # Pass through when no effects and a JPEG already exists
        # (ultrahdr.cpp:872-881).
        if self.sdr_jpeg is not None and not config.effects:
            return self.sdr_jpeg
        self._sdr_or_raise()
        img = editor.apply_effects(self._sdr_dev(), config.effects)
        icc = None
        if img.gamut in (ColorGamut.BT709, ColorGamut.P3,
                         ColorGamut.BT2100):
            icc = icc_mod.write_icc_profile("srgb", img.gamut.value)
        return codec.encode_jpeg(
            {k: img.planes[k] for k in ("y", "u", "v")},
            quality=config.quality, icc=icc, device=self.device)

    def _convert_to_jpegr(self, config: UltraHdrConfig) -> bytes:
        jr = JpegR(self.device)
        # Priority chain (ultrahdr.cpp:919-1047), as ultrahdr.py:459-510.
        # API-4: compressed base + compressed gain map, no effects.
        if (self.gainmap_jpeg is not None and self.sdr_jpeg is not None
                and self.metadata is not None and not config.effects):
            return jr.encode_api4(self.sdr_jpeg, self.gainmap_jpeg,
                                  self.metadata, exif=None)
        # API-x: raw SDR + raw gain map + metadata.
        if (self.sdr_raw is not None and self.gainmap_raw is not None
                and self.metadata is not None):
            return self._encode_apix(jr, config)
        # API-2: raw HDR + raw SDR + compressed SDR.
        if (self.hdr_raw is not None and self.sdr_raw is not None
                and self.sdr_jpeg is not None and not config.effects):
            return jr.encode_api2(self.hdr_raw, _host_image(self.sdr_raw),
                                  self.sdr_jpeg, config.transfer)
        # API-3: raw HDR + compressed SDR.
        if (self.hdr_raw is not None and self.sdr_jpeg is not None
                and self.sdr_raw is None and not config.effects):
            return jr.encode_api3(self.hdr_raw, self.sdr_jpeg,
                                  config.transfer)
        # API-1: raw HDR + raw SDR.
        if self.hdr_raw is not None and self.sdr_raw is not None:
            if not config.effects:
                return jr.encode_api1(self.hdr_raw, _host_image(self.sdr_raw),
                                      config.transfer,
                                      quality=config.quality,
                                      exif=self.exif)
            return self._encode_with_effects(jr, config)
        # API-0: raw HDR only.
        if self.hdr_raw is not None:
            if not config.effects:
                return jr.encode_api0(self.hdr_raw, config.transfer,
                                      quality=config.quality,
                                      exif=self.exif)
            self._maybe_tonemap_raw_hdr()
            return self._encode_with_effects(jr, config)
        # JPEG_R passthrough re-encode from decoded parts.
        if (self.sdr_jpeg is not None and self.gainmap_raw is not None
                and self.metadata is not None):
            self._maybe_decode_jpeg_sdr()
            return self._encode_with_effects(jr, config)
        raise err("UHDR_CODEC_INVALID_OPERATION",
                  "insufficient inputs for jpeg_r conversion")

    def _ensure_gainmap(self, config: UltraHdrConfig):
        """Generate the gain map from the raw pair when the session
        doesn't carry one yet (ultrahdr.cpp:997-1009): B10b."""
        if self.gainmap_raw is not None and self.metadata is not None:
            return
        if self.hdr_raw is None or self.sdr_raw is None:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      "cannot generate gain map without HDR input")
        sdr = self._sdr_dev()
        gmap, md = gm.generate_gainmap(
            *(sdr.planes[k][None] for k in ("y", "u", "v")),
            *self._hdr_dev(), sdr_gamut=self.sdr_raw.gamut.value,
            hdr_gamut=self.hdr_raw.gamut.value,
            hdr_tf=config.transfer.value)
        self.gainmap_raw = gmap[0]
        self.metadata = md

    def _encode_apix(self, jr: JpegR, config: UltraHdrConfig) -> bytes:
        sdr, gmap = self._edited(config.effects)
        return jr.encode_apix(sdr, gmap, self.metadata,
                              quality=config.quality, exif=self.exif)

    def _encode_with_effects(self, jr: JpegR,
                             config: UltraHdrConfig) -> bytes:
        """Generate (or reuse) the gain map, apply the effect chain to
        SDR + gain map, then encode via API-x
        (ultrahdr.cpp:997-1009, 1124-1180)."""
        self._maybe_tonemap_raw_hdr()
        self._ensure_gainmap(config)
        return self._encode_apix(jr, config)
