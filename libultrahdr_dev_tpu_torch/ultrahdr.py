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

HEIC / AVIF input and output run through HeifR (heifr.py: the
gain-map container by container/isobmff.py, coded images by the system
libheif, 10-bit AVIF by libavif), its pixel math on the session's
device: B10a / B10b for the gain-map encodes, B6 for the 10-bit outputs
(then the host's BT.2020 YUV for 10-bit AVIF, as in the JAX package),
B7 where a decode wants SDR pixels. Without libheif those arms raise
UHDR_CODEC_UNSUPPORTED_FEATURE, as the reference does without its codec
plugins.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .container import icc as icc_mod
from .container import jfif, mux
from .device import resolve_device, upload
from .jpeg import codec
from .jpegr import _OUT, JpegR, upload_frame
from .ops import editor, gainmap as gm
from .types import (ColorGamut, ColorTransfer, GainMapMetadata,
                    OutputFormat, PixelFormat, RawImage, err)

def _is_jpeg(data: bytes) -> bool:
    return len(data) >= 3 and data[0] == 0xFF and data[1] == 0xD8


def sniff_format(data: bytes) -> str:
    """JPEG / JPEG_R / HEIF container sniffing (ultrahdr.cpp:69-129)."""
    if _is_jpeg(data):
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


def _rgb10_to_bt2020_yuv420(planes):
    """(3,H,W) 10-bit OETF-encoded RGB -> narrow-range BT.2020
    YCbCr 4:2:0 10-bit ((H,W) y, (H/2,W/2) cb/cr), on the host as in
    the JAX package (ultrahdr.py:67). Narrow-range constants match the
    P010 conventions the ingest side assumes (gainmapmath.cpp:583-601:
    (y-64)/876, (uv-512)/896)."""
    r, g, b = (planes.astype(np.float32) / 1023.0)
    y = 0.2627 * r + 0.6780 * g + 0.0593 * b
    u = (b - y) / 1.8814
    v = (r - y) / 1.4746
    h, w = y.shape
    if h % 2 or w % 2:  # pad to even for the 2x2 chroma mean
        y = np.pad(y, ((0, h % 2), (0, w % 2)), mode="edge")
        u = np.pad(u, ((0, h % 2), (0, w % 2)), mode="edge")
        v = np.pad(v, ((0, h % 2), (0, w % 2)), mode="edge")
    yq = np.clip(np.round(64 + 876 * y[:h, :w]), 0, 1023)
    uq = np.clip(np.round(
        512 + 896 * u.reshape(-1, 2, u.shape[1] // 2, 2).mean((1, 3))),
        0, 1023)
    vq = np.clip(np.round(
        512 + 896 * v.reshape(-1, 2, v.shape[1] // 2, 2).mean((1, 3))),
        0, 1023)
    return (yq.astype(np.uint16), uq.astype(np.uint16),
            vq.astype(np.uint16))


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
        if _is_jpeg(data):
            return self._add_jpeg(data)
        kind = sniff_format(data)
        if kind in ("heic", "avif"):
            return self._add_heif(data)
        raise err("UHDR_CODEC_INVALID_PARAM", "unrecognized image format")

    def _add_jpeg(self, data: bytes):
        """JPEG and JPEG/R ingest: the blob split once and each image's
        headers read once (jfif.read_images), sniff_format's test
        (mux.uhdr_metadata) made on them; a JPEG/R's gain map decoded
        from its headers."""
        images = jfif.read_images(data)
        metadata = mux.uhdr_metadata(images)
        if metadata is None:   # a plain JPEG
            self.sdr_jpeg = data
            info = jfif.parse_jpeg_info(images[0] if images else data)
            if info.exif is not None:
                self.exif = info.exif
            return self
        primary, gmap = images
        self.sdr_jpeg = data[primary.start:primary.start + primary.end]
        self.gainmap_jpeg = data[gmap.start:gmap.start + gmap.end]
        self.metadata = metadata
        self.gainmap_raw = codec.decode_jpeg(gmap, self.device).planes[0]
        if primary.exif is not None:
            self.exif = primary.exif
        return self

    def _add_heif(self, data: bytes):
        """HEIF/AVIF ingest (ultrahdr.cpp:631-743, JAX ultrahdr.py:133):
        gain-map containers populate SDR + gain map + metadata (host
        planes from libheif; no device work until a convert); plain HEIFs
        populate the SDR rendition, or the raw HDR slot as P010 for a
        10-bit primary."""
        from .container import isobmff as iso, libheif as lh
        from .heifr import HeifR

        hp = iso.parse_heif(data)
        tmaps = [i for i, it in hp.items.items()
                 if it.item_type == "tmap"]
        if tmaps:
            refs = hp.refs.get(("dimg", tmaps[0]))
            if not refs or len(refs) < 2:
                raise err("UHDR_CODEC_ERROR", "tmap item lacks dimg refs")
            root_type = hp.items[refs[0]].item_type
            if root_type == "grid":
                kids = hp.refs.get(("dimg", refs[0]), [])
                root_type = (hp.items[kids[0]].item_type if kids
                             else "hvc1")
            hr = HeifR("avif" if root_type == "av01" else "heic",
                       self.device)
            hr._require_codec()
            (y8, u8, v8), gmap, metadata, exif = hr._decode_coded(data)
            self.sdr_raw = RawImage(
                fmt=PixelFormat.YUV420, width=y8.shape[1],
                height=y8.shape[0], gamut=ColorGamut.UNSPECIFIED,
                transfer=ColorTransfer.SRGB,
                planes={"y": y8, "u": u8, "v": v8})
            self.gainmap_raw = np.asarray(gmap)
            self.metadata = metadata
            if exif is not None:
                self.exif = exif
            return self
        # Plain HEIF: 8-bit primary is the SDR rendition, a 10-bit one
        # populates the raw HDR slot as P010 (ultrahdr.cpp:661-692:
        # luma_bits_per_pixel 10 -> hdr_raw, 8 -> sdr_raw).
        if not lh.available():
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      "heif input requires the libheif shared library")
        planes, depth, heif_exif = lh.decode_primary_full(
            data, monochrome=False)
        if heif_exif is not None:
            self.exif = heif_exif
        y, u, v = planes
        h, w = y.shape
        if depth > 8:
            shift = 16 - depth  # P010: 10-bit MSB-aligned u16
            uv = np.empty((u.shape[0], u.shape[1] * 2), np.uint16)
            uv[:, 0::2] = u.astype(np.uint16) << shift
            uv[:, 1::2] = v.astype(np.uint16) << shift
            self.hdr_raw = RawImage(
                fmt=PixelFormat.P010, width=w, height=h,
                gamut=ColorGamut.BT2100,
                transfer=ColorTransfer.UNSPECIFIED,
                planes={"y": y.astype(np.uint16) << shift, "uv": uv})
            return self
        self.sdr_raw = RawImage(
            fmt=PixelFormat.YUV420, width=w, height=h,
            gamut=ColorGamut.UNSPECIFIED, transfer=ColorTransfer.SRGB,
            planes={"y": y, "u": u, "v": v})
        return self

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
        if config.output_codec in ("heic_r", "avif_r"):
            return self._convert_to_heifr(
                config, config.output_codec[:4])
        if config.output_codec in ("heic", "avif"):
            return self._convert_to_heif_sdr(config,
                                             config.output_codec)
        if config.output_codec in ("heic_10bit", "avif_10bit"):
            return self._convert_to_heif10(
                config, config.output_codec.split("_")[0])
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"unknown output codec {config.output_codec}")

    def _convert_to_heif_sdr(self, config: UltraHdrConfig,
                             codec: str) -> bytes:
        """Plain 8-bit SDR HEIC/AVIF output — ULTRAHDR_CODEC_HEIC/AVIF
        (ultrahdr.cpp:1181-1206): tone map (B10a) / decode the SDR
        rendition, apply effects (B13), encode heif-only with EXIF
        attached (heifr.cpp:271-279)."""
        from .heifr import HeifR

        self._maybe_tonemap_raw_hdr()
        self._maybe_decode_jpeg_sdr()
        if self.sdr_raw is None:
            raise err("UHDR_CODEC_INVALID_OPERATION",
                      "no SDR rendition available")
        sdr = editor.apply_effects(self._sdr_dev(), config.effects)
        return HeifR(codec, self.device).encode_sdr(
            sdr, quality=config.quality, exif=self.exif)

    def _convert_to_heifr(self, config: UltraHdrConfig,
                          codec: str) -> bytes:
        """Gain-map HEIC/AVIF output (ultrahdr.cpp:1049-1180), same
        priority chain as jpeg_r minus the compressed-passthrough
        cases (JAX ultrahdr.py:287-337)."""
        from .heifr import HeifR

        hr = HeifR(codec, self.device)

        def apix():
            sdr, gmap = self._edited(config.effects)
            return hr.encode_apix(sdr, gmap, self.metadata,
                                  quality=config.quality, exif=self.exif)

        # Raw SDR + raw gain map + metadata (API-x), effects applied.
        if (self.sdr_raw is not None and self.gainmap_raw is not None
                and self.metadata is not None):
            return apix()
        if self.hdr_raw is not None and self.sdr_raw is not None:
            if not config.effects:
                return hr.encode_api1(self.hdr_raw, self.sdr_raw,
                                      config.transfer,
                                      quality=config.quality,
                                      exif=self.exif)
        if self.hdr_raw is not None and not config.effects:
            return hr.encode_api0(self.hdr_raw, config.transfer,
                                  quality=config.quality,
                                  exif=self.exif)
        if self.hdr_raw is not None or (
                self.sdr_jpeg is not None and self.gainmap_raw is not None
                and self.metadata is not None):
            # Effects (or decoded-JPEG source): generate/reuse the gain
            # map, apply chain, encode API-x.
            self._maybe_decode_jpeg_sdr()
            self._maybe_tonemap_raw_hdr()
            self._ensure_gainmap(config)
            return apix()
        raise err("UHDR_CODEC_INVALID_OPERATION",
                  f"insufficient inputs for {codec}_r conversion")

    def _convert_to_heif10(self, config: UltraHdrConfig,
                           codec: str) -> bytes:
        """10-bit HEIC/AVIF output: reconstruct HDR as 10-bit RGB
        planes (B6 at HLG or PQ, as the JAX package does) and encode
        4:4:4 10-bit with CICP signaling (ultrahdr.cpp:1207-1287)."""
        from .container import libheif as lh

        raw = self.convert_to_raw(UltraHdrConfig(
            output_format=(OutputFormat.HDR_HLG
                           if config.transfer == ColorTransfer.HLG
                           else OutputFormat.HDR_PQ),
            # carry the caller's color config: _ensure_gainmap reads
            # hdr_tf off the config it is given, and the inner
            # config's default (HLG) would mis-linearize PQ input when
            # the gain map has not been generated yet
            transfer=config.transfer,
            gamut=config.gamut,
            effects=config.effects,
            max_display_boost=config.max_display_boost))
        packed = np.asarray(raw.planes["rgba"])  # RGBA1010102 u32
        planes = np.stack([(packed >> s10) & 0x3FF
                           for s10 in (0, 10, 20)]).astype(np.uint16)
        if codec == "avif":
            # libheif's aom plugin mis-selects AV1 profile 2 for any
            # 10-bit encode (libaom assertion -> process abort), so
            # 10-bit AVIF goes through libavif directly as BT.2020
            # narrow-range YCbCr 4:2:0 (AV1 Main profile).
            from .container import libavif as la
            return la.encode_yuv(
                _rgb10_to_bt2020_yuv420(planes), 10, config.quality,
                transfer=config.transfer.value, exif=self.exif)
        return lh.encode_rgb10(planes, codec, config.quality,
                               transfer=config.transfer.value,
                               exif=self.exif)

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
