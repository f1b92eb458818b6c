"""HeifR of the port: gain-map HEIC/AVIF encode and decode.

Mirrors libultrahdr_dev_tpu/heifr.py (the reference's heifr.cpp:141-410,
written against a patched libheif fork with gain-map items). The stock
libheif has no gain-map API, so the work splits as in the JAX package:

  - pixel math on the session's torch device (the CUDA device unless the
    caller names another): the tone map (B10a, ops/gainmap.py
    tonemap_p010), the gain map (B10b, generate_gainmap), its apply (B6,
    apply_gainmap) and the SDR output (B7, yuv420_to_rgba8888);
  - coded images (HEVC/AV1) through the system libheif by ctypes
    (container/libheif.py), one standalone encode per image, its planes
    handed over as host numpy arrays, one readback each;
  - the gain-map container, written and parsed directly
    (container/isobmff.py) in the reference fork's ISO 21496-1-style
    'tmap' layout;
  - metadata as the fork's fractional payload (heifr.cpp:108-138).

Without libheif every entry point raises UHDR_CODEC_UNSUPPORTED_FEATURE,
never a silently gain-map-less file. A kernel that fails raises too: no
arm of this module falls back to the host.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .container import isobmff as iso
from .container import libheif as lh
from .device import resolve_device, upload
from .jpegr import _OUT, upload_frame
from .ops import gainmap as gm
from .types import (ColorGamut, ColorTransfer, GainMapMetadata,
                    OutputFormat, PixelFormat, RawImage, err)
from .utils.profiler import StageTimes, span

_GAINMAP_QUALITY = 85  # matches kMapCompressQualityDefault usage

# Maximum coded-image dimension before the encoder splits into a HEIF
# 'grid' of tiles (the reference's libheif does the same for HEVC
# profile limits). Tests shrink this to exercise the tiling cheaply.
GRID_TILE_LIMIT = 4096


# The stages HeifR(times=...) records: encode_api0's device stage and
# coded encode, decode's coded decode and device stage.
STAGES = ("API-0 device stage (upload, B10a, B10b, readbacks)",
          "coded encode (libheif, host)", "coded decode (libheif, host)",
          "decode device stage (upload, B6 or B7, readback)")


def heif_available() -> bool:
    return lh.available()


def _host(p) -> np.ndarray:
    """A plane as a host numpy array (a tensor read back once)."""
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


class HeifRDecodeResult:
    def __init__(self, width, height, image, metadata, gainmap,
                 base_yuv=None, exif=None):
        self.width = width
        self.height = height
        self.image = image
        self.metadata = metadata
        self.gainmap = gainmap
        # (y8, u8, v8) planes of the decoded base image — kept so
        # ingest paths don't pay a second HEVC/AV1 decode.
        self.base_yuv = base_yuv
        # EXIF blob from the container's Exif item (heifr.cpp:324-331).
        self.exif = exif


class HeifR:
    """Mirrors class HeifR (lib/include/ultrahdr/heifr.h:72-204):
    encode API-0/1/x and decode for HEIC_R / AVIF_R, with its device
    work on `device`. Where `times` (a StageTimes) is given, encode_api0
    and decode record their device stages (each ending with its
    readback) and libheif's stages in it under STAGES' names."""

    def __init__(self, codec: str = "heic", device="cuda",
                 times: StageTimes | None = None):
        if codec not in ("heic", "avif"):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"unknown heif codec {codec}")
        self.codec = codec
        self.device = resolve_device(device)
        self.times = times

    def _require_codec(self):
        if not lh.available():
            raise err(
                "UHDR_CODEC_UNSUPPORTED_FEATURE",
                f"{self.codec}-R needs the libheif shared library "
                "(HEVC/AV1 entropy layer); none is installed. The "
                "gain-map math itself is available via "
                "ops.gainmap.generate_gainmap/apply_gainmap.")

    # -- device stages ---------------------------------------------------

    def _api0_planes(self, p010: RawImage, hdr_tf: ColorTransfer):
        """API-0's device stage: the P010 frame uploaded in one copy,
        tone-mapped (B10a) and its gain map generated (B10b); -> host
        (y8, u8, v8, gain map) and the metadata."""
        y, uv = upload_frame(p010.planes["y"], p010.planes["uv"], None,
                             self.device)
        y8, u8, v8 = gm.tonemap_p010(y, uv)
        gmap, metadata = gm.generate_gainmap(
            y8, u8, v8, y, uv, sdr_gamut=p010.gamut.value,
            hdr_gamut=p010.gamut.value, hdr_tf=hdr_tf.value)
        return (*(_host(p[0]) for p in (y8, u8, v8, gmap)), metadata)

    def _reconstruct(self, y8, u8, v8, gmap, metadata: GainMapMetadata,
                     output_format: OutputFormat,
                     max_display_boost: float) -> RawImage:
        """Decode's device stage: host base planes and gain map uploaded
        in one copy, then B7 (SDR) or B6 (HDR); one readback of the
        pixels."""
        h, w = y8.shape
        planes = upload([np.ascontiguousarray(p, np.uint8)
                         for p in (y8, u8, v8, gmap)], self.device)
        if output_format == OutputFormat.SDR:
            rgba = gm.yuv420_to_rgba8888(*(p[None] for p in planes[:3]))
            return RawImage(fmt=PixelFormat.RGBA8888, width=w, height=h,
                            gamut=ColorGamut.UNSPECIFIED,
                            planes={"rgba": rgba[0].cpu().numpy()
                                    .view(np.uint32)})
        out = gm.apply_gainmap_metadata(*planes, metadata,
                                        output_format.value,
                                        max_display_boost)
        pixel_fmt, transfer, dtype = _OUT[output_format]
        return RawImage(fmt=pixel_fmt, width=w, height=h,
                        gamut=ColorGamut.UNSPECIFIED, transfer=transfer,
                        planes={"rgba": out.cpu().numpy().view(dtype)})

    # -- encode (heifr.cpp:141-299) ------------------------------------

    def encode_api0(self, p010: RawImage, hdr_tf: ColorTransfer,
                    quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """Tone map + gain map on the device, then assemble base +
        gain-map HEIF with ISO 21496-1-style metadata."""
        self._require_codec()
        with span(STAGES[0], self.times):
            y8, u8, v8, gmap, metadata = self._api0_planes(p010, hdr_tf)
        with span(STAGES[1], self.times):
            return self._encode_gainmap_heif(y8, u8, v8, gmap, metadata,
                                             quality, exif)

    def encode_api1(self, p010: RawImage, yuv420: RawImage,
                    hdr_tf: ColorTransfer, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """The gain map of a given SDR rendition on the device (B10b),
        the P010 frame and the SDR planes uploaded in one copy."""
        self._require_codec()
        sdr = [_host(yuv420.planes[k]) for k in ("y", "u", "v")]
        y, uv, *dev_sdr = upload_frame(p010.planes["y"], p010.planes["uv"],
                                       sdr, self.device)
        gmap, metadata = gm.generate_gainmap(
            *dev_sdr, y, uv, sdr_gamut=yuv420.gamut.value,
            hdr_gamut=p010.gamut.value, hdr_tf=hdr_tf.value)
        return self._encode_gainmap_heif(*sdr, _host(gmap[0]), metadata,
                                         quality, exif)

    def encode_apix(self, yuv420: RawImage, gainmap_u8,
                    metadata: GainMapMetadata,
                    quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """Transcode variant: provided SDR + gain map + metadata
        (heifr.cpp API-x); planes on a device are read back once."""
        self._require_codec()
        return self._encode_gainmap_heif(
            *(_host(yuv420.planes[k]) for k in ("y", "u", "v")),
            _host(gainmap_u8), metadata, quality, exif)

    def encode_sdr(self, yuv420: RawImage, quality: int = 95,
                   exif: bytes | None = None) -> bytes:
        """Plain 8-bit SDR HEIC/AVIF — no gain map
        (heifr.cpp:271-279 "only encode heif", reached from
        ultrahdr.cpp:1181-1206 ULTRAHDR_CODEC_HEIC/AVIF)."""
        self._require_codec()
        planes = tuple(np.asarray(_host(yuv420.planes[k]), np.uint8)
                       for k in ("y", "u", "v"))
        return lh.encode_image(planes, self.codec, quality, exif=exif)

    def _encode_image_items(self, planes, quality: int) -> list:
        """Encode planes into OutItems: a single coded item when the
        image fits HEVC/AV1 profile limits, else a 'grid' of coded
        tiles (grid root at index 0, tiles hidden) so >4K dimensions
        encode — the reference gets this transparently from libheif."""
        h, w = planes[0].shape
        limit = GRID_TILE_LIMIT
        if w <= limit and h <= limit:
            f = lh.encode_image(planes, self.codec, quality)
            p = iso.parse_heif(f)
            return iso.extract_image_items(f, p, p.primary or 1)

        cols = math.ceil(w / limit)
        rows = math.ceil(h / limit)
        tile_w = math.ceil(w / cols)
        tile_h = math.ceil(h / rows)
        tile_w += tile_w % 2  # 4:2:0 chroma needs even tile dims
        tile_h += tile_h % 2
        mono = len(planes) == 1
        # Edge-replicate to the full tile lattice; the grid's ispe
        # crops back to (w, h) at decode.
        full_w, full_h = cols * tile_w, rows * tile_h

        def padded(p, sub):
            ph, pw = (h + sub - 1) // sub, (w + sub - 1) // sub
            fh, fw = full_h // sub, full_w // sub
            return np.pad(np.asarray(p, np.uint8)[:ph, :pw],
                          ((0, fh - ph), (0, fw - pw)), mode="edge")

        yp = padded(planes[0], 1)
        if not mono:
            up, vp = padded(planes[1], 2), padded(planes[2], 2)
        items = [iso.OutItem("grid",
                             iso.grid_payload(rows, cols, w, h),
                             [iso.ispe_prop(w, h),
                              iso.pixi_prop(1 if mono else 3)])]

        def tile_planes(r, c):
            ys, xs = r * tile_h, c * tile_w
            tp = [yp[ys:ys + tile_h, xs:xs + tile_w]]
            if not mono:
                tp += [up[ys // 2:(ys + tile_h) // 2,
                          xs // 2:(xs + tile_w) // 2],
                       vp[ys // 2:(ys + tile_h) // 2,
                          xs // 2:(xs + tile_w) // 2]]
            return tuple(tp)

        # Tiles encode concurrently: each lh.encode_image call is an
        # independent libheif context and ctypes releases the GIL for
        # the duration of the HEVC/AV1 encode (JobQueue caps at
        # min(cores, 4) in ultrahdr.cpp). Assembly below stays in tile
        # order, so output is deterministic regardless of completion
        # order.
        ntiles = rows * cols
        workers = max(1, min(os.cpu_count() or 1, ntiles, 4))
        with ThreadPoolExecutor(workers) as pool:
            coded = list(pool.map(
                lambda rc: lh.encode_image(tile_planes(*rc),
                                           self.codec, quality),
                [(r, c) for r in range(rows) for c in range(cols)]))

        tile_roots = []
        for f in coded:
            hp = iso.parse_heif(f)
            titems = iso.extract_image_items(f, hp, hp.primary or 1)
            off = len(items)
            tile_roots.append(off + 1)
            for j, it in enumerate(titems):
                items.append(iso.OutItem(
                    it.item_type, it.payload, it.props, it.name,
                    True if j == 0 else it.hidden,
                    [t + off for t in it.dimg]))
        items[0].dimg = tile_roots
        return items

    def _encode_gainmap_heif(self, y8, u8, v8, gmap,
                             metadata: GainMapMetadata,
                             quality: int,
                             exif: bytes | None = None) -> bytes:
        base_items = self._encode_image_items((y8, u8, v8), quality)
        gm_items = self._encode_image_items((gmap,), _GAINMAP_QUALITY)
        return iso.build_tmap_container(
            self.codec, base_items, gm_items,
            iso.encode_tmap_metadata(metadata), exif=exif)

    # -- decode (heifr.cpp:302-410) ------------------------------------

    def _decode_coded(self, data: bytes):
        """Decode's host stage: split the gain-map container and decode
        base and gain map through libheif. -> ((y8, u8, v8), gain map,
        metadata, EXIF)."""
        hp = iso.parse_heif(data)
        tmap_ids = [i for i, it in hp.items.items()
                    if it.item_type == "tmap"]
        if not tmap_ids:
            raise err("UHDR_CODEC_ERROR",
                      "no gain-map (tmap) item in HEIF container")
        tmap = tmap_ids[0]
        refs = hp.refs.get(("dimg", tmap))
        if not refs or len(refs) < 2:
            raise err("UHDR_CODEC_ERROR", "tmap item lacks dimg refs")
        base_id, gm_id = refs[0], refs[1]
        metadata = iso.decode_tmap_metadata(
            iso.item_payload(data, hp, tmap))
        exif = iso.find_exif(data, hp, base_id)

        root_type = hp.items[base_id].item_type
        if root_type == "grid":
            kids = hp.refs.get(("dimg", base_id), [])
            root_type = hp.items[kids[0]].item_type if kids else "hvc1"
        codec = "avif" if root_type == "av01" else "heic"

        def rebuild(item_id):
            return iso.build_image_subtree(
                codec, iso.extract_image_items(data, hp, item_id))

        base = lh.decode_primary(rebuild(base_id), monochrome=False)
        gmap, = lh.decode_primary(rebuild(gm_id), monochrome=True)
        return tuple(base), gmap, metadata, exif

    def decode(self, data: bytes,
               output_format: OutputFormat = OutputFormat.HDR_LINEAR,
               max_display_boost: float = float("inf"),
               ) -> HeifRDecodeResult:
        """Split the gain-map container, decode base + gain map via
        libheif, reconstruct on the device."""
        self._require_codec()
        if max_display_boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"bad max_display_boost {max_display_boost}")
        with span(STAGES[2], self.times):
            base, gmap, metadata, exif = self._decode_coded(data)
        with span(STAGES[3], self.times):
            image = self._reconstruct(*base, gmap, metadata, output_format,
                                      max_display_boost)
        return HeifRDecodeResult(image.width, image.height, image, metadata,
                                 gmap, base, exif)
