"""ICC profile generation / gamut sniffing for JPEG/R, byte-exact.

Re-implements IccHelper (lib/src/icc.cpp,
lib/include/ultrahdr/icc.h): ICC v4.3 profiles (v4.4
when a CICP tag is present), desc/cprt mluc text tags, XYZ colorant
tags from the skcms-derived D50-adapted primaries, para/curv TRC tags,
and for PQ a Lab-PCS A2B0/B2A0 pair with a 17^3 tone-mapping CLUT.
Output includes the "ICC_PROFILE\\0" identifier + chunk bytes as
emitted into the JPEG APP2 segment.

The 17^3 CLUT fill (icc.cpp:493-538) is vectorized with numpy instead
of the reference's triple scalar loop.
"""

from __future__ import annotations

import math
import struct

import numpy as np

ICC_IDENTIFIER = b"ICC_PROFILE\x00"

_D50 = (0.9642, 1.0000, 0.8249)

_TRC_TABLE_SIZE = 65
_GRID_SIZE = 17

# Fixed-point (16.16) colorant matrices, icc.h:115-135 (kSRGB from skcms
# hex constants; P3/Rec2020 as float literals).
_FIXED = 1.52587890625e-5
SRGB_TO_XYZD50 = [
    [0x6FA2 * _FIXED, 0x6299 * _FIXED, 0x24A0 * _FIXED],
    [0x38F5 * _FIXED, 0xB785 * _FIXED, 0x0F84 * _FIXED],
    [0x0390 * _FIXED, 0x18DA * _FIXED, 0xB6CF * _FIXED],
]
DISPLAYP3_TO_XYZD50 = [
    [0.515102, 0.291965, 0.157153],
    [0.241182, 0.692236, 0.0665819],
    [-0.00104941, 0.0418818, 0.784378],
]
REC2020_TO_XYZD50 = [
    [0.673459, 0.165661, 0.125100],
    [0.279033, 0.675338, 0.0456288],
    [-0.00193139, 0.0299794, 0.797162],
]

_GAMUT_MATRICES = {
    "bt709": SRGB_TO_XYZD50,
    "p3": DISPLAYP3_TO_XYZD50,
    "bt2100": REC2020_TO_XYZD50,
}

# sRGB 7-parameter transfer function (gainmapmath.h:67-68).
_SRGB_TRANSFUN = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045, 0.0, 0.0)
_LINEAR_TRANSFUN = (1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)

_CICP_PRIMARIES = {"bt709": 1, "p3": 12, "bt2100": 9}
_CICP_TRFN = {"srgb": 1, "linear": 8, "pq": 16, "hlg": 18}


def _tag(a: str) -> int:
    b = a.encode()
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


def _be32(x: int) -> bytes:
    return struct.pack(">I", x & 0xFFFFFFFF)


def _be16(x: int) -> bytes:
    return struct.pack(">H", x & 0xFFFF)


def _float_round_to_fixed(x: float) -> int:
    """s15.16 fixed with round-half-up (icc.h float_round_to_fixed)."""
    v = math.floor(x * 65536.0 + 0.5)
    return int(max(min(v, 2147483520), -2147483520))


def _float_round_to_unorm16(x: float) -> int:
    v = x * 65535.0 + 0.5
    return int(min(max(v, 0), 65535))


def _pad4(data: bytes) -> bytes:
    """The reference sizes buffers as ((n+2)>>2)<<2 and leaves the
    remainder zero-filled (DataStruct allocates zeroed)."""
    total = ((len(data) + 2) >> 2) << 2
    return data + b"\x00" * (total - len(data))


def _write_text_tag(text: str) -> bytes:
    n = len(text)
    header = (_be32(_tag("mluc")) + _be32(0) + _be32(1) + _be32(12)
              + _be32(_tag("enUS")) + _be32(2 * n) + _be32(28))
    body = b"".join(b"\x00" + bytes([c]) for c in text.encode("ascii"))
    return _pad4(header + body)


def _write_xyz_tag(x: float, y: float, z: float) -> bytes:
    return (_be32(_tag("XYZ ")) + _be32(0)
            + _be32(_float_round_to_fixed(x))
            + _be32(_float_round_to_fixed(y))
            + _be32(_float_round_to_fixed(z)))


def _write_trc_tag_table(table_u16: np.ndarray) -> bytes:
    out = _be32(_tag("curv")) + _be32(0) + _be32(len(table_u16))
    out += table_u16.astype(">u2").tobytes()
    return _pad4(out)


def _write_trc_tag_para(fn) -> bytes:
    g, a, b, c, d, e, f = fn
    if a == 1.0 and b == 0.0 and c == 0.0 and d == 0.0 and e == 0.0 and f == 0.0:
        # Pure-gamma curve. NOTE: the reference writes the 2-byte curve
        # type through a 32-bit write of Endian_SwapBE16(type)
        # (icc.cpp:227), i.e. the u16 big-endian value in the low bytes
        # of a native-endian u32 -> bytes [00 00 00 00] for type 0.
        return (_be32(_tag("para")) + _be32(0)
                + struct.pack("<I", struct.unpack("<H", struct.pack(">H", 0))[0])
                + _be32(_float_round_to_fixed(g)))
    out = (_be32(_tag("para")) + _be32(0)
           + struct.pack("<I", struct.unpack("<H", struct.pack(">H", 4))[0]))
    for v in (g, a, b, c, d, e, f):
        out += _be32(_float_round_to_fixed(v))
    return out


def _compute_tone_map_gain(tf: str, lum: np.ndarray) -> np.ndarray:
    """Tone-map gain (icc.cpp:247-272), vectorized."""
    lum = np.asarray(lum, np.float64)
    if tf == "pq":
        in_max = 10000.0 / 203.0
        scaled = lum * in_max
        a = 1.0 / (in_max * in_max)
        b = 1.0
        gain = in_max * (1.0 + a * scaled) / (1.0 + b * scaled)
        return np.where(lum <= 0.0, 1.0, gain)
    if tf == "hlg":
        lw = 203.0
        gamma = 1.2 + 0.42 * math.log(lw / 1000.0) / math.log(10.0)
        return np.where(lum <= 0.0, 1.0,
                        np.power(np.maximum(lum, 1e-30), gamma - 1.0))
    return np.ones_like(lum)


def _write_cicp_tag(primaries: int, trfn: int) -> bytes:
    return (_be32(_tag("cicp")) + _be32(0)
            + bytes([primaries, trfn, 0, 1]))


def _pq_oetf_np(x):
    m1, m2 = 2610 / 16384, 2523 / 4096 * 128
    c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
    x = np.asarray(x, np.float64)
    xp = np.maximum(x, 0.0) ** m1
    return np.where(x <= 0, 0.0, ((c1 + c2 * xp) / (1 + c3 * xp)) ** m2)


def _hlg_oetf_np(x):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    x = np.asarray(x, np.float64)
    return np.where(x <= 1 / 12, np.sqrt(np.maximum(3 * x, 0)),
                    a * np.log(np.maximum(12 * x - b, 1e-30)) + c)


def _compute_a2b_grid(to_xyzd50) -> np.ndarray:
    """PQ A2B0 CLUT: grid^3 x 3 u16 Lab entries (icc.cpp:286-345,
    493-538), vectorized."""
    g = _GRID_SIZE
    idx = np.arange(g, dtype=np.float64) / (g - 1)
    r, gg, b = np.meshgrid(idx, idx, idx, indexing="ij")
    rgb = np.stack([r, gg, b], axis=-1).reshape(-1, 3)

    # compute_lut_entry: PQ-OETF?? The reference calls pqOetf on the
    # *signal* — icc.cpp:306 "Convert the source signal to linear" but
    # invokes pqOetf (intentional per upstream; reproduced for parity).
    rgb = _pq_oetf_np(rgb)

    rec2020 = np.asarray(REC2020_TO_XYZD50, np.float64)
    src = np.asarray(to_xyzd50, np.float64)
    src_to_rec2020 = np.linalg.inv(rec2020) @ src
    rgb = rgb @ src_to_rec2020.T

    lum = rgb @ np.asarray([0.2627, 0.6780, 0.0593])
    gain = _compute_tone_map_gain("pq", lum)
    rgb = rgb * gain[:, None]

    xyz = rgb @ rec2020.T

    # XYZ D50 -> Lab -> unorm16 (icc.cpp:100-123).
    v = xyz / np.asarray(_D50)
    v = np.where(v > 0.008856, np.cbrt(v), v * 7.787 + 16.0 / 116.0)
    L = v[:, 1] * 116.0 - 16.0
    a = (v[:, 0] - v[:, 1]) * 500.0
    bb = (v[:, 1] - v[:, 2]) * 200.0
    lab = np.stack([L / 100.0, (a + 128.0) / 255.0, (bb + 128.0) / 255.0],
                   axis=-1)
    u16 = np.clip(lab * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
    return u16.reshape(-1)


def _write_clut(grid_points, grid_u16: np.ndarray) -> bytes:
    out = bytes(grid_points[i] if i < 3 else 0 for i in range(16))
    out += bytes([2, 0, 0, 0])
    out += grid_u16.astype(">u2").tobytes()
    return _pad4(out)


def _write_mab_mba_tag(type_tag: str, has_a_curves: bool,
                       grid_u16=None) -> bytes:
    b_curves_offset = 32
    b_curve = _write_trc_tag_para(_LINEAR_TRANSFUN)
    b_curves = b_curve * 3
    clut = b""
    a_curves = b""
    clut_offset = 0
    a_curves_offset = 0
    if has_a_curves:
        clut_offset = b_curves_offset + len(b_curves)
        clut = _write_clut([_GRID_SIZE] * 3, grid_u16)
        a_curves_offset = clut_offset + len(clut)
        a_curves = b_curve * 3
    header = (_be32(_tag(type_tag)) + _be32(0)
              + bytes([3, 3]) + _be16(0)
              + _be32(b_curves_offset) + _be32(0) + _be32(0)
              + _be32(clut_offset) + _be32(a_curves_offset))
    total = b_curves_offset + len(b_curves) + len(clut) + len(a_curves)
    # Upstream quirk reproduced for byte parity: the reference's write
    # loop returns right after the FIRST successful b-curve write
    # (icc.cpp:396-400 `if (dataStruct->write(...)) return dataStruct;`),
    # so the CLUT/a-curves region stays zero-initialized in the emitted
    # profile while the total tag length still accounts for it.
    out = header + b_curve
    return out + b"\x00" * (total - len(out))


def _desc_string(tf: str, gamut: str) -> str:
    g = {"bt709": "sRGB", "p3": "Display P3", "bt2100": "Rec2020"}.get(
        gamut, "Unknown")
    t = {"srgb": "sRGB", "linear": "Linear", "pq": "PQ", "hlg": "HLG"}.get(
        tf, "Unknown")
    return f"{g} Gamut with {t} Transfer"


def _icc_header(profile_size: int, version: int, pcs_lab: bool,
                tag_count: int) -> bytes:
    h = b""
    h += _be32(profile_size)
    h += _be32(0)  # cmm type
    h += _be32(version)
    h += _be32(_tag("mntr"))
    h += _be32(_tag("RGB "))
    h += _be32(_tag("Lab ") if pcs_lab else _tag("XYZ "))
    h += b"\x00" * 12  # creation date/time
    h += _be32(_tag("acsp"))
    h += _be32(0)  # platform
    h += _be32(0)  # flags
    h += _be32(0)  # device manufacturer
    h += _be32(0)  # device model
    h += b"\x00" * 8  # device attributes
    h += _be32(1)  # rendering intent
    h += _be32(_float_round_to_fixed(_D50[0]))
    h += _be32(_float_round_to_fixed(_D50[1]))
    h += _be32(_float_round_to_fixed(_D50[2]))
    h += _be32(0)  # creator
    h += b"\x00" * 16  # profile id
    h += b"\x00" * 28  # reserved
    h += _be32(tag_count)
    return h


def write_icc_profile(tf: str, gamut: str) -> bytes:
    """Full APP2 ICC payload: identifier + chunk 1/1 + profile
    (icc.cpp:410-600 writeIccProfile)."""
    matrix = _GAMUT_MATRICES.get(gamut)
    if matrix is None:
        raise ValueError(f"unsupported gamut {gamut}")

    tags: list[tuple[int, bytes]] = []
    tags.append((_tag("desc"), _write_text_tag(_desc_string(tf, gamut))))
    tags.append((_tag("rXYZ"),
                 _write_xyz_tag(matrix[0][0], matrix[1][0], matrix[2][0])))
    tags.append((_tag("gXYZ"),
                 _write_xyz_tag(matrix[0][1], matrix[1][1], matrix[2][1])))
    tags.append((_tag("bXYZ"),
                 _write_xyz_tag(matrix[0][2], matrix[1][2], matrix[2][2])))
    tags.append((_tag("wtpt"), _write_xyz_tag(*_D50)))

    if tf != "pq":
        if tf == "hlg":
            xs = np.arange(_TRC_TABLE_SIZE, dtype=np.float64) / (
                _TRC_TABLE_SIZE - 1.0)
            ys = _hlg_oetf_np(xs)
            ys = ys * _compute_tone_map_gain("hlg", ys)
            table = np.asarray([_float_round_to_unorm16(v) for v in ys],
                               np.uint16)
            trc = _write_trc_tag_table(table)
        else:
            trc = _write_trc_tag_para(_SRGB_TRANSFUN)
        tags.append((_tag("rTRC"), trc))
        tags.append((_tag("gTRC"), trc))
        tags.append((_tag("bTRC"), trc))

    version = 0x04300000
    if tf in ("hlg", "pq"):
        version = 0x04400000
        primaries = _CICP_PRIMARIES.get(gamut, 0)
        if gamut == "bt2100":
            primaries = 0  # reference only maps sRGB/P3 (icc.cpp:478-483)
        tags.append((_tag("cicp"),
                     _write_cicp_tag(primaries, _CICP_TRFN.get(tf, 0))))

    if tf == "pq":
        grid = _compute_a2b_grid(matrix)
        tags.append((_tag("A2B0"), _write_mab_mba_tag("mAB ", True, grid)))
        tags.append((_tag("B2A0"), _write_mab_mba_tag("mBA ", False)))

    tags.append((_tag("cprt"), _write_text_tag("Google Inc. 2022")))

    header_size = 132
    tag_table_size = 12 * len(tags)
    tag_data_size = sum(len(t[1]) for t in tags)
    profile_size = header_size + tag_table_size + tag_data_size

    out = ICC_IDENTIFIER + bytes([1, 1])
    out += _icc_header(profile_size, version, tf == "pq", len(tags))

    offset = header_size + tag_table_size
    for sig, data in tags:
        out += _be32(sig) + _be32(offset) + _be32(len(data))
        offset += len(data)
    for _, data in tags:
        out += data
    return out


def read_icc_color_gamut(icc: bytes) -> str:
    """Sniff the gamut by byte-comparing the colorant tags against the
    three known matrices (icc.cpp:602-685). Returns gamut name or
    'unspecified'."""
    ident_size = 14
    if len(icc) < ident_size + 132 or not icc.startswith(ICC_IDENTIFIER):
        return "unspecified"
    body = icc[ident_size:]
    tag_count = struct.unpack(">I", body[128:132])[0]
    primaries = {}
    for i in range(tag_count):
        entry = body[132 + i * 12: 132 + (i + 1) * 12]
        if len(entry) < 12:
            return "unspecified"
        sig, off, size = struct.unpack(">III", entry)
        for name, t in (("r", "rXYZ"), ("g", "gXYZ"), ("b", "bXYZ")):
            if sig == _tag(t) and name not in primaries:
                primaries[name] = (off, size)
    if len(primaries) != 3:
        return "unspecified"
    colorant_size = 20
    vals = {}
    for name, (off, size) in primaries.items():
        if size != colorant_size or off + size > len(body):
            return "unspecified"
        vals[name] = body[off:off + colorant_size]
    for gamut, m in _GAMUT_MATRICES.items():
        if (vals["r"] == _write_xyz_tag(m[0][0], m[1][0], m[2][0])
                and vals["g"] == _write_xyz_tag(m[0][1], m[1][1], m[2][1])
                and vals["b"] == _write_xyz_tag(m[0][2], m[1][2], m[2][2])):
            return gamut
    return "unspecified"
