"""CIPA DC-007 Multi-Picture Format APP2 payload, byte-exact port of
generateMpf (lib/src/multipictureformat.cpp:20-92):
big-endian TIFF IFD with version / image count / MP entries for exactly
two images (primary + gain map)."""

from __future__ import annotations

import struct

_MPF_SIG = b"MPF\x00"
_BIG_ENDIAN = bytes([0x4D, 0x4D, 0x00, 0x2A])

_VERSION_TAG = 0xB000
_NUMBER_OF_IMAGES_TAG = 0xB001
_MP_ENTRY_TAG = 0xB002
_TYPE_LONG = 0x4
_TYPE_UNDEFINED = 0x7
_MP_ENTRY_SIZE = 16
_NUM_PICTURES = 2
_TAG_SERIALIZED_COUNT = 3
_TAG_SIZE = 12

_ATTR_FORMAT_JPEG = 0x0000000
_ATTR_TYPE_PRIMARY = 0x030000


def calculate_mpf_size() -> int:
    return (len(_MPF_SIG) + 4 + 4 + 2
            + _TAG_SERIALIZED_COUNT * _TAG_SIZE + 4
            + _NUM_PICTURES * _MP_ENTRY_SIZE)


def generate_mpf(primary_image_size: int, primary_image_offset: int,
                 secondary_image_size: int,
                 secondary_image_offset: int) -> bytes:
    be16 = lambda v: struct.pack(">H", v & 0xFFFF)
    be32 = lambda v: struct.pack(">I", v & 0xFFFFFFFF)

    out = bytearray()
    out += _MPF_SIG
    out += _BIG_ENDIAN
    # Index IFD offset: right after endianness + this offset field.
    out += be32(4 + len(_MPF_SIG))
    out += be16(_TAG_SERIALIZED_COUNT)

    out += be16(_VERSION_TAG)
    out += be16(_TYPE_UNDEFINED)
    out += be32(4)
    out += b"0100"

    out += be16(_NUMBER_OF_IMAGES_TAG)
    out += be16(_TYPE_LONG)
    out += be32(1)
    out += be32(_NUM_PICTURES)

    out += be16(_MP_ENTRY_TAG)
    out += be16(_TYPE_UNDEFINED)
    out += be32(_MP_ENTRY_SIZE * _NUM_PICTURES)
    mp_entry_offset = len(out) - len(_MPF_SIG) + 4 + 4
    out += be32(mp_entry_offset)

    out += struct.pack("<I", 0)  # attribute IFD offset (absent)

    out += be32(_ATTR_FORMAT_JPEG | _ATTR_TYPE_PRIMARY)
    out += be32(primary_image_size)
    out += be32(primary_image_offset)
    out += struct.pack("<HH", 0, 0)

    out += be32(_ATTR_FORMAT_JPEG)
    out += be32(secondary_image_size)
    out += be32(secondary_image_offset)
    out += struct.pack("<HH", 0, 0)

    assert len(out) == calculate_mpf_size()
    return bytes(out)
