"""Minimal ISOBMFF (HEIF/AVIF) container codec for gain-map images: a
copy of libultrahdr_dev_tpu/container/isobmff.py (pure host code).

The reference implements gain-map HEIC/AVIF against a patched libheif
fork (lib/src/heifr.cpp:35-36) whose private API writes the ISO
21496-1-style structure seen in its tests/data/sample_heicr.heic:

  item 1: coded base image (av01/hvc1), primary
  item 2: 'tmap' derived item named "GMap" whose payload is the gain
          map metadata (fractional fields, heifr.cpp:108-138)
  item 3: coded gain-map image (hidden, named "GMap")
  iref  : 'dimg' from item 2 -> [item 1, item 3]
  grpl  : 'altr' alternatives group {tmap, base}

The stock libheif (1.15 as packaged) can encode/decode individual coded
images but knows nothing of 'tmap', so this module does the container
work directly: parse any HEIF into items/properties/extents, extract a
coded item into a minimal standalone HEIF for decoding, and assemble
the tmap container from two independently encoded images.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..types import GainMapMetadata, err


def _u16(v):
    return struct.pack(">H", v)


def _u32(v):
    return struct.pack(">I", v)


def _box(typ: bytes, payload: bytes) -> bytes:
    return _u32(8 + len(payload)) + typ + payload


def _fullbox(typ: bytes, version: int, flags: int,
             payload: bytes) -> bytes:
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big")
                + payload)


def iter_boxes(data: bytes, start: int, end: int):
    """Yield (type, payload_start, payload_end) for each box."""
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack(">I4s", data[pos:pos + 8])
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                break
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise err("UHDR_CODEC_ERROR", f"bad box at {pos}")
        yield typ, pos + hdr, pos + size
        pos += size


@dataclass
class HeifItem:
    item_id: int
    item_type: str
    name: str = ""
    hidden: bool = False
    extents: list = field(default_factory=list)  # (abs_offset, length)
    props: list = field(default_factory=list)    # (ipco_index, essential)


@dataclass
class HeifParse:
    brand: str = ""
    primary: int = 0
    items: dict = field(default_factory=dict)       # id -> HeifItem
    ipco: list = field(default_factory=list)        # raw property boxes
    refs: dict = field(default_factory=dict)        # (type, from) -> [to]
    idat: bytes = b""

    def item_payload(self, data: bytes, item_id: int) -> bytes:
        it = self.items[item_id]
        out = b"".join(data[o:o + ln] for o, ln in it.extents)
        return out

    def prop(self, item_id: int, fourcc: str) -> bytes | None:
        """Raw box bytes of the item's first property of the type."""
        for idx, _ in self.items[item_id].props:
            raw = self.ipco[idx]
            if raw[4:8].decode("latin1") == fourcc:
                return raw
        return None


def parse_heif(data: bytes) -> HeifParse:
    out = HeifParse()
    meta = None
    for typ, p0, p1 in iter_boxes(data, 0, len(data)):
        if typ == b"ftyp":
            out.brand = data[p0:p0 + 4].decode("latin1")
        elif typ == b"meta":
            meta = (p0 + 4, p1)  # fullbox: skip version/flags
    if meta is None:
        raise err("UHDR_CODEC_ERROR", "no meta box")

    iloc_raw = None
    for typ, p0, p1 in iter_boxes(data, meta[0], meta[1]):
        if typ == b"pitm":
            v = data[p0]
            out.primary = (struct.unpack(">I", data[p0 + 4:p0 + 8])[0]
                           if v else
                           struct.unpack(">H", data[p0 + 4:p0 + 6])[0])
        elif typ == b"iinf":
            v = data[p0]
            n_off = p0 + 4
            count = (struct.unpack(">H", data[n_off:n_off + 2])[0]
                     if v == 0 else
                     struct.unpack(">I", data[n_off:n_off + 4])[0])
            pos = n_off + (2 if v == 0 else 4)
            for _ in range(count):
                for t2, q0, q1 in iter_boxes(data, pos, meta[1]):
                    if t2 != b"infe":
                        raise err("UHDR_CODEC_ERROR", "expected infe")
                    ver = data[q0]
                    flags = int.from_bytes(data[q0 + 1:q0 + 4], "big")
                    if ver < 2:
                        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                                  "infe version < 2")
                    if ver == 2:
                        iid = struct.unpack(">H", data[q0 + 4:q0 + 6])[0]
                        base = q0 + 8
                    else:
                        iid = struct.unpack(">I", data[q0 + 4:q0 + 8])[0]
                        base = q0 + 10
                    itype = data[base:base + 4].decode("latin1")
                    name_end = data.find(b"\0", base + 4, q1)
                    name = data[base + 4:name_end if name_end >= 0
                                else q1].decode("utf-8", "replace")
                    out.items[iid] = HeifItem(iid, itype, name,
                                              bool(flags & 1))
                    pos = q1
                    break
        elif typ == b"iloc":
            iloc_raw = (p0, p1)
        elif typ == b"iref":
            v = data[p0]
            idsz = 2 if v == 0 else 4
            pos = p0 + 4
            while pos + 8 <= p1:
                for t2, q0, q1 in iter_boxes(data, pos, p1):
                    fro = int.from_bytes(data[q0:q0 + idsz], "big")
                    cnt = struct.unpack(
                        ">H", data[q0 + idsz:q0 + idsz + 2])[0]
                    tos = [int.from_bytes(
                        data[q0 + idsz + 2 + i * idsz:
                             q0 + idsz + 2 + (i + 1) * idsz], "big")
                        for i in range(cnt)]
                    out.refs[(t2.decode("latin1"), fro)] = tos
                    pos = q1
                    break
                else:
                    break
        elif typ == b"iprp":
            for t2, q0, q1 in iter_boxes(data, p0, p1):
                if t2 == b"ipco":
                    for t3, r0, r1 in iter_boxes(data, q0, q1):
                        out.ipco.append(data[r0 - 8:r1])
                elif t2 == b"ipma":
                    v = data[q0]
                    flags = int.from_bytes(data[q0 + 1:q0 + 4], "big")
                    cnt = struct.unpack(">I", data[q0 + 4:q0 + 8])[0]
                    pos = q0 + 8
                    for _ in range(cnt):
                        if v == 0:
                            iid = struct.unpack(
                                ">H", data[pos:pos + 2])[0]
                            pos += 2
                        else:
                            iid = struct.unpack(
                                ">I", data[pos:pos + 4])[0]
                            pos += 4
                        an = data[pos]
                        pos += 1
                        props = []
                        for _ in range(an):
                            if flags & 1:
                                pv = struct.unpack(
                                    ">H", data[pos:pos + 2])[0]
                                pos += 2
                                ess = bool(pv & 0x8000)
                                pidx = pv & 0x7FFF
                            else:
                                pv = data[pos]
                                pos += 1
                                ess = bool(pv & 0x80)
                                pidx = pv & 0x7F
                            if pidx:
                                props.append((pidx - 1, ess))
                        if iid in out.items:
                            out.items[iid].props = props
        elif typ == b"idat":
            out.idat = data[p0:p1]

    if iloc_raw:
        p0, p1 = iloc_raw
        v = data[p0]
        sizes = data[p0 + 4]
        offset_size, length_size = sizes >> 4, sizes & 15
        b2 = data[p0 + 5]
        base_offset_size = b2 >> 4
        index_size = (b2 & 15) if v in (1, 2) else 0
        pos = p0 + 6
        if v < 2:
            count = struct.unpack(">H", data[pos:pos + 2])[0]
            pos += 2
        else:
            count = struct.unpack(">I", data[pos:pos + 4])[0]
            pos += 4

        def rd(n):
            nonlocal pos
            val = int.from_bytes(data[pos:pos + n], "big")
            pos += n
            return val

        for _ in range(count):
            iid = rd(2 if v < 2 else 4)
            cm = 0
            if v in (1, 2):
                cm = rd(2) & 15
            rd(2)  # data_reference_index
            base = rd(base_offset_size)
            ec = rd(2)
            exts = []
            for _ in range(ec):
                if index_size:
                    rd(index_size)
                off = rd(offset_size)
                ln = rd(length_size)
                exts.append((base + off, ln))
            if iid in out.items:
                if cm == 1:  # idat-relative
                    exts = [("idat", o, ln) for o, ln in exts]
                    payload = b"".join(
                        out.idat[o:o + ln] for _, o, ln in exts)
                    # store as a pseudo-extent resolved immediately
                    out.items[iid].extents = [("idat", payload)]
                else:
                    out.items[iid].extents = exts
    # Resolve idat pseudo-extents into item_payload-compatible form.
    for it in out.items.values():
        if it.extents and it.extents[0] and it.extents[0][0] == "idat":
            payload = it.extents[0][1]
            it.extents = []
            it._idat_payload = payload  # type: ignore[attr-defined]
    return out


def item_payload(data: bytes, hp: HeifParse, item_id: int) -> bytes:
    it = hp.items[item_id]
    if hasattr(it, "_idat_payload"):
        return it._idat_payload  # type: ignore[attr-defined]
    return b"".join(data[o:o + ln] for o, ln in it.extents)


# ---------------------------------------------------------------------------
# Writers.
# ---------------------------------------------------------------------------

_BRANDS = {
    "avif": (b"avif", [b"avif", b"mif1", b"miaf"]),
    "heic": (b"heic", [b"heic", b"mif1", b"miaf"]),
}


def _ftyp(codec: str) -> bytes:
    major, compat = _BRANDS[codec]
    return _box(b"ftyp", major + _u32(0) + b"".join(compat))


_HDLR = _fullbox(b"hdlr", 0, 0,
                 _u32(0) + b"pict" + _u32(0) * 3 + b"\0")


def _infe(item_id: int, item_type: str, name: str = "",
          hidden: bool = False) -> bytes:
    return _fullbox(b"infe", 2, 1 if hidden else 0,
                    _u16(item_id) + _u16(0)
                    + item_type.encode("latin1")
                    + name.encode("utf-8") + b"\0")


def _iloc(entries) -> bytes:
    """entries: list of (item_id, abs_offset, length); v0, 4-byte
    offset/length/base (matches the fork's output layout)."""
    payload = bytes([0x44, 0x40]) + _u16(len(entries))
    for iid, off, ln in entries:
        payload += (_u16(iid) + _u16(0) + _u32(0) + _u16(1)
                    + _u32(off) + _u32(ln))
    return _fullbox(b"iloc", 0, 0, payload)


def _ipma(assoc) -> bytes:
    """assoc: list of (item_id, [(prop_index0, essential)])."""
    payload = _u32(len(assoc))
    for iid, props in assoc:
        payload += _u16(iid) + bytes([len(props)])
        for pidx, ess in props:
            payload += bytes([(0x80 if ess else 0) | (pidx + 1)])
    return _fullbox(b"ipma", 0, 0, payload)


@dataclass
class OutItem:
    """Item description for build_heif (1-based ids assigned by list
    position)."""

    item_type: str
    payload: bytes
    props: list = field(default_factory=list)   # raw property boxes
    name: str = ""
    hidden: bool = False
    dimg: list = field(default_factory=list)    # referenced 1-based ids
    cdsc: list = field(default_factory=list)    # described 1-based ids


_ESSENTIAL_PROPS = (b"av1C", b"hvcC", b"av2C", b"vvcC")


def build_heif(codec: str, items: list, primary: int,
               altr: list | None = None) -> bytes:
    """Assemble a HEIF/AVIF from OutItem descriptions. Item ids are
    1-based positions in `items`; `primary` and ids inside dimg/altr
    use the same numbering. Properties are deduplicated byte-wise."""
    ipco: list[bytes] = []
    assoc = []
    for idx, it in enumerate(items):
        pl = []
        for raw in it.props:
            if raw in ipco:
                pi = ipco.index(raw)
            else:
                ipco.append(raw)
                pi = len(ipco) - 1
            pl.append((pi, raw[4:8] in _ESSENTIAL_PROPS))
        if pl:
            assoc.append((idx + 1, pl))

    irefs = b""
    for idx, it in enumerate(items):
        if it.dimg:
            irefs += _box(b"dimg", _u16(idx + 1) + _u16(len(it.dimg))
                          + b"".join(_u16(t) for t in it.dimg))
        if it.cdsc:
            irefs += _box(b"cdsc", _u16(idx + 1) + _u16(len(it.cdsc))
                          + b"".join(_u16(t) for t in it.cdsc))

    def meta(offsets) -> bytes:
        inner = (_HDLR
                 + _fullbox(b"pitm", 0, 0, _u16(primary))
                 + _iloc([(i + 1, off, len(it.payload))
                          for i, (it, off) in
                          enumerate(zip(items, offsets))])
                 + _fullbox(b"iinf", 0, 0, _u16(len(items))
                            + b"".join(_infe(i + 1, it.item_type,
                                             it.name, it.hidden)
                                       for i, it in enumerate(items)))
                 + _box(b"iprp", _box(b"ipco", b"".join(ipco))
                        + _ipma(assoc)))
        if irefs:
            inner += _fullbox(b"iref", 0, 0, irefs)
        return _fullbox(b"meta", 0, 0, inner)

    grpl = b""
    if altr:
        grpl = _box(b"grpl", _fullbox(
            b"altr", 0, 0, _u32(1) + _u32(len(altr))
            + b"".join(_u32(i) for i in altr)))
    ftyp = _ftyp(codec)
    m0 = meta([0] * len(items))
    data_start = len(ftyp) + len(m0) + len(grpl) + 8
    offsets = []
    pos = data_start
    for it in items:
        offsets.append(pos)
        pos += len(it.payload)
    return (ftyp + meta(offsets) + grpl
            + _box(b"mdat", b"".join(it.payload for it in items)))


def extract_image_items(data: bytes, hp: HeifParse,
                        root_id: int) -> list:
    """Copy an image item and its transitive 'dimg' children (grid
    tiles etc.) out of a parsed HEIF as OutItems; index 0 is the root
    and dimg lists use local 1-based ids."""
    order = []

    def visit(iid):
        if iid in order:
            return
        order.append(iid)
        for t in hp.refs.get(("dimg", iid), []):
            visit(t)

    visit(root_id)
    local = {iid: i + 1 for i, iid in enumerate(order)}
    out = []
    for iid in order:
        it = hp.items[iid]
        out.append(OutItem(
            item_type=it.item_type,
            payload=item_payload(data, hp, iid),
            props=[hp.ipco[i] for i, _ in it.props],
            name=it.name, hidden=it.hidden,
            dimg=[local[t] for t in hp.refs.get(("dimg", iid), [])]))
    return out


def build_single_image(codec: str, props: list, payload: bytes,
                       item_type: str) -> bytes:
    """Minimal one-item HEIF/AVIF wrapping an already-coded image
    payload with its raw property boxes (config/ispe/pixi/colr...)."""
    return build_heif(codec,
                      [OutItem(item_type, payload, list(props))], 1)


def build_image_subtree(codec: str, items: list) -> bytes:
    """Standalone HEIF from extract_image_items output (handles grid
    images whose tiles ride along). The root becomes the primary item,
    so its hidden flag is cleared (libheif won't decode a hidden
    primary)."""
    items = [OutItem(it.item_type, it.payload, it.props, it.name,
                     it.hidden if i else False, list(it.dimg))
             for i, it in enumerate(items)]
    return build_heif(codec, items, 1)


def grid_payload(rows: int, cols: int, w: int, h: int) -> bytes:
    """ImageGrid derived-item payload (ISO 23008-12 §6.6.2.3.2):
    version, flags (bit0 = 32-bit output fields), rows-1, cols-1,
    output dimensions."""
    if w <= 0xFFFF and h <= 0xFFFF:
        return bytes([0, 0, rows - 1, cols - 1]) + _u16(w) + _u16(h)
    return bytes([0, 1, rows - 1, cols - 1]) + _u32(w) + _u32(h)


def ispe_prop(w: int, h: int) -> bytes:
    return _fullbox(b"ispe", 0, 0, _u32(w) + _u32(h))


def pixi_prop(channels: int, depth: int = 8) -> bytes:
    return _fullbox(b"pixi", 0, 0,
                    bytes([channels]) + bytes([depth]) * channels)


def encode_exif_item_payload(exif: bytes) -> bytes:
    """ExifDataBlock: u32 tiff-header offset + payload. The JPEG-side
    blobs this framework carries start with the APP1 "Exif\\0\\0"
    signature, putting the TIFF header at offset 6."""
    offset = 6 if exif.startswith(b"Exif\x00\x00") else 0
    return _u32(offset) + exif


def decode_exif_item_payload(payload: bytes) -> bytes | None:
    """Inverse of encode_exif_item_payload (and of libheif's
    heif_context_add_exif_metadata): strip the u32 offset field."""
    if len(payload) <= 4:
        return None
    return payload[4:]


def find_exif(data: bytes, hp: HeifParse,
              described_id: int | None = None) -> bytes | None:
    """EXIF payload of the container's Exif item (optionally the one
    cdsc-linked to `described_id`), or None."""
    for iid, it in hp.items.items():
        if it.item_type != "Exif":
            continue
        if described_id is not None:
            tos = hp.refs.get(("cdsc", iid))
            if tos and described_id not in tos:
                continue
        return decode_exif_item_payload(item_payload(data, hp, iid))
    return None


def build_tmap_container(codec: str, base_items: list, gm_items: list,
                         tmap_metadata: bytes,
                         exif: bytes | None = None) -> bytes:
    """Assemble the gain-map container in the reference fork's layout
    (see module docstring / sample_heicr.heic): base image (+children),
    'tmap' metadata item, hidden gain-map image (+children), plus an
    optional Exif item cdsc-linked to the base image
    (heifr.cpp:266-268 heif_context_add_exif_metadata)."""
    items = [
        OutItem(it.item_type, it.payload, it.props, it.name, it.hidden,
                list(it.dimg))
        for it in base_items
    ]
    nb = len(items)
    tmap_idx = nb + 1
    gm_base = nb + 1  # tmap occupies one slot; gm root follows
    items.append(OutItem("tmap", tmap_metadata, [], "GMap"))
    for j, it in enumerate(gm_items):
        items.append(OutItem(
            it.item_type, it.payload, it.props, "GMap" if j == 0
            else it.name, True if j == 0 else it.hidden,
            [t + gm_base for t in it.dimg]))
    items[tmap_idx - 1].dimg = [1, gm_base + 1]
    if exif is not None:
        items.append(OutItem("Exif", encode_exif_item_payload(exif),
                             cdsc=[1]))
    return build_heif(codec, items, primary=1, altr=[tmap_idx, 1])


# ---------------------------------------------------------------------------
# ISO 21496-1-style gain-map metadata payload (fork-compatible; the
# fractional field semantics mirror heifr.cpp:108-138).
# ---------------------------------------------------------------------------

_SCALE = 1_000_000


def encode_tmap_metadata(md: GainMapMetadata) -> bytes:
    """Single-channel payload: version byte, flags byte (bit1 =
    use_base_color_space), base/alternate HDR headroom rationals, then
    per-channel min/max/gamma/base-offset/alternate-offset rationals."""
    out = bytearray()
    out += bytes([0, 0x02])
    out += _u32(0) + _u32(0)  # base hdr headroom N/D
    out += _u32(0) + _u32(0)  # alternate hdr headroom N/D
    for val in (md.min_content_boost, md.max_content_boost, md.gamma,
                md.offset_sdr, md.offset_hdr):
        out += _u32(round(val * _SCALE) & 0xFFFFFFFF) + _u32(_SCALE)
    return bytes(out)


def decode_tmap_metadata(payload: bytes) -> GainMapMetadata:
    if len(payload) < 58:
        raise err("UHDR_CODEC_ERROR", "tmap metadata too short")
    multichannel = bool(payload[1] & 0x01)
    pos = 2 + 16  # skip headrooms

    def frac():
        nonlocal pos
        n, d = struct.unpack(">iI", payload[pos:pos + 8])
        pos += 8
        return n / d if d else 0.0

    vals = [frac() for _ in range(5)]
    if multichannel:
        # Channels are equal in everything this framework (and the
        # reference, heifr.cpp:119-131) writes; read channel 0.
        pass
    mn, mx, gamma, osdr, ohdr = vals
    mn = mn if mn > 0 else 1.0
    mx = mx if mx > 0 else 1.0
    return GainMapMetadata(
        max_content_boost=mx, min_content_boost=mn,
        gamma=gamma if gamma > 0 else 1.0,
        offset_sdr=osdr, offset_hdr=ohdr,
        hdr_capacity_min=mn, hdr_capacity_max=mx)
