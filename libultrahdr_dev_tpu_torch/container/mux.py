"""JPEG/R container mux/demux.

Assembles the JPEG/R byte stream exactly as JpegR::appendGainMap
(lib/src/jpegr.cpp:917-1130):

  SOI | [EXIF APP1] | XMP APP1 (GContainer) | [ICC APP2] | MPF APP2 |
  primary-image-bytes (sans its SOI) |
  SOI | XMP APP1 (hdrgm) | gainmap-bytes (sans its SOI)

and splits it back (extractPrimaryImageAndGainMap,
jpegr.cpp:823-876).
"""

from __future__ import annotations

from ..jpeg.headers import JpegHeaders
from ..types import GainMapMetadata, err
from . import jfif, mpf, xmp

_XMP_NS = xmp.XMP_NAMESPACE.encode() + b"\x00"  # 29 bytes


def _app1(payload: bytes) -> bytes:
    length = 2 + len(payload)
    return bytes([0xFF, 0xE1, (length >> 8) & 0xFF, length & 0xFF]) + payload


def _app2(payload: bytes) -> bytes:
    length = 2 + len(payload)
    return bytes([0xFF, 0xE2, (length >> 8) & 0xFF, length & 0xFF]) + payload


def append_gainmap(primary_jpeg: bytes, gainmap_jpeg: bytes,
                   metadata: GainMapMetadata, exif: bytes | None = None,
                   icc: bytes | None = None) -> bytes:
    """Mux a primary JPEG + gain map JPEG + metadata into one JPEG/R blob.

    Validation mirrors jpegr.cpp:960-1000; if the primary already
    carries EXIF it is hoisted to the front (and external EXIF is then
    rejected), per jpegr.cpp:1003-1032.
    """
    if metadata.version != "1.0":
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"bad metadata version {metadata.version}")
    if metadata.max_content_boost < metadata.min_content_boost:
        raise err("UHDR_CODEC_INVALID_PARAM", "max boost < min boost")
    if (metadata.hdr_capacity_max < metadata.hdr_capacity_min
            or metadata.hdr_capacity_min < 1.0):
        raise err("UHDR_CODEC_INVALID_PARAM", "bad hdr capacity range")
    if metadata.offset_sdr < 0.0 or metadata.offset_hdr < 0.0:
        raise err("UHDR_CODEC_INVALID_PARAM", "negative offsets")
    if metadata.gamma <= 0.0:
        raise err("UHDR_CODEC_INVALID_PARAM", "non-positive gamma")

    # Secondary image (gain map) XMP; its length feeds the primary XMP.
    xmp_secondary = xmp.generate_xmp_for_secondary_image(metadata).encode()
    xmp_secondary_length = 2 + len(_XMP_NS) + len(xmp_secondary)
    secondary_image_size = 2 + xmp_secondary_length + len(gainmap_jpeg)

    xmp_primary = xmp.generate_xmp_for_primary_image(
        secondary_image_size, metadata).encode()

    # Hoist EXIF out of the primary if present.
    stripped, exif_from_jpeg = jfif.strip_exif(primary_jpeg)
    if exif_from_jpeg is not None:
        if exif is not None:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "EXIF provided while the primary image has EXIF")
        exif = exif_from_jpeg
        primary_jpeg = stripped

    out = bytearray()
    out += bytes([0xFF, 0xD8])  # SOI

    if exif is not None:
        out += _app1(exif)

    out += _app1(_XMP_NS + xmp_primary)

    if icc:
        out += _app2(icc)

    # MPF: sizes/offsets per jpegr.cpp:1077-1094.
    mpf_segment_length = 2 + mpf.calculate_mpf_size()
    pos = len(out)
    primary_image_size = (pos + 2 + mpf_segment_length
                          + len(primary_jpeg) - 2)
    # Offset from after [APP2 + length + 'MPF\0' signature (8 bytes)]
    # to the secondary image's SOI.
    secondary_image_offset = primary_image_size - pos - 8
    out += _app2(mpf.generate_mpf(primary_image_size, 0,
                                  secondary_image_size,
                                  secondary_image_offset))

    out += primary_jpeg[2:]  # primary sans SOI

    out += bytes([0xFF, 0xD8])  # secondary SOI
    out += _app1(_XMP_NS + xmp_secondary)
    out += gainmap_jpeg[2:]

    return bytes(out)


def read_primary_and_gainmap(jpegr) -> tuple[JpegHeaders, JpegHeaders]:
    """Split a JPEG/R blob into its primary and gain-map images, each
    one's headers read once (jfif.read_images; jpegr.cpp:823-876)."""
    images = jfif.read_images(jpegr, limit=2)
    if not images:
        raise err("UHDR_CODEC_ERROR", "no images found")
    if len(images) == 1:
        raise err("UHDR_CODEC_ERROR", "gain map image not found")
    return tuple(images)


def extract_primary_and_gainmap(jpegr: bytes) -> tuple[bytes, bytes]:
    """Split a JPEG/R blob into (primary_jpeg, gainmap_jpeg) byte ranges
    (jpegr.cpp:823-876)."""
    return tuple(jpegr[h.start:h.start + h.end]
                 for h in read_primary_and_gainmap(jpegr))


def uhdr_metadata(images) -> GainMapMetadata | None:
    """The gain-map metadata where a blob's images (jfif.read_images)
    make a JPEG/R with parseable gain-map XMP, else None."""
    if len(images) < 2 or images[1].xmp is None:
        return None
    try:
        return xmp.get_metadata_from_xmp(images[1].xmp)
    except Exception:
        return None


def is_uhdr_image(data: bytes) -> bool:
    """True if the blob is a JPEG/R with parseable gain-map metadata
    (ultrahdr_api.cpp:855-881 is_uhdr_image)."""
    try:
        return uhdr_metadata(jfif.read_images(data)) is not None
    except Exception:
        return False
