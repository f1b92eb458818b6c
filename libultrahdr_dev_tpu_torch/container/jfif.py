"""The images of a JPEG/R blob and the metadata of one JPEG, from their
headers (jpeg/headers.py) without entropy-decoding anything: replaces
the vendored image_io JpegScanner/JpegInfoBuilder (third_party/image_io,
used at lib/src/jpegr.cpp:823-876)."""

from __future__ import annotations

from ..jpeg import headers
from ..jpeg.headers import JpegHeaders


def read_images(data, limit: int = 2) -> list[JpegHeaders]:
    """The headers of up to `limit` complete JPEG images in a JPEG/R
    blob, each read once and cut at the EOI that ends its first scan
    (the end of the blob without one) — the analog of image_io
    JpegScanner with SetImageLimit(2) (jpegr.cpp:836-847). The search
    stops at the first image whose marker walk fails."""
    images = []
    pos = 0
    n = len(data)
    while len(images) < limit and pos + 4 <= n:
        soi = data.find(b"\xff\xd8", pos)
        if soi < 0:
            break
        try:
            hdr = headers.read_headers(data, soi)
        except Exception:
            break
        if hdr.eoi >= 0:
            hdr.end = hdr.eoi + 2
        images.append(hdr)
        pos = soi + hdr.end
    return images


def find_image_ranges(data: bytes, limit: int = 2):
    """(start, end) byte ranges of up to `limit` complete JPEG images in
    a JPEG/R blob (read_images)."""
    return [(h.start, h.start + h.end) for h in read_images(data, limit)]


def parse_jpeg_info(data) -> JpegHeaders:
    """The headers of one JPEG (bytes, or its JpegHeaders), whose size,
    EXIF, XMP and ICC are the PARSE_ONLY view of getCompressedImage-
    Parameters (lib/src/jpegdecoderhelper.cpp:216-341)."""
    return headers.of(data)


def strip_exif(jpeg: bytes) -> tuple[bytes, bytes | None]:
    """Remove the EXIF APP1 from a JPEG; returns (jpeg_without_exif,
    exif_payload_or_None) (jpegr.cpp:63-73 copyJpegWithoutExif)."""
    info = parse_jpeg_info(jpeg)
    if info.exif is None:
        return jpeg, None
    pos = info.exif_offset - 4  # back to the 0xFF byte
    seg_total = 2 + 2 + len(info.exif)  # FF E1 + length bytes + payload
    return jpeg[:pos] + jpeg[pos + seg_total:], info.exif
