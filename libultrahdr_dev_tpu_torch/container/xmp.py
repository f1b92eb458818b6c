"""XMP generation and parsing for JPEG/R, byte-exact vs the reference.

Writer reproduces the exact serialization of the reference's
image_io XmlWriter (third_party/image_io/src/xml/
xml_writer.cc) as driven by generateXmpForPrimaryImage /
generateXmpForSecondaryImage (lib/src/jpegrutils.cpp:
547-609): two-space indents, one attribute per line, lazy '>' closes,
'/>' directly after the last attribute, floats in C++ default ostream
formatting (6 significant digits).

Parser mirrors getMetadataFromXMP (jpegrutils.cpp:436-545): namespace
check, packet header/wrapper/padding stripping, required
Version/GainMapMax/HDRCapacityMax, defaults for the rest, log2-space
boost/capacity values, BaseRenditionIsHDR=True rejected.
"""

from __future__ import annotations

import math
import re

from ..types import GainMapMetadata, err

XMP_NAMESPACE = "http://ns.adobe.com/xap/1.0/"

_CONTAINER_URI = "http://ns.google.com/photos/1.0/container/"
_ITEM_URI = "http://ns.google.com/photos/1.0/container/item/"
_GAINMAP_URI = "http://ns.adobe.com/hdr-gain-map/1.0/"


def _fmt(value: float) -> str:
    """C++ `ostream << float` default formatting: %g with 6 sig digits."""
    return "%g" % float(value)


class _XmlWriter:
    """Byte-compatible re-implementation of image_io::XmlWriter."""

    def __init__(self):
        self.out: list[str] = []
        self.indent = ""
        # stack of [name, has_attributes, has_content, has_children]
        self.stack: list[list] = []

    def _maybe_close_bracket(self, newline: bool):
        if self.stack:
            top = self.stack[-1]
            if not top[2] and not top[3]:
                self.out.append(">")
                if newline:
                    self.out.append("\n")
                return True
        return False

    def start_element(self, name: str) -> int:
        self._maybe_close_bracket(True)
        depth = len(self.stack)
        if self.stack:
            self.stack[-1][3] = True
        self.stack.append([name, False, False, False])
        self.out.append(f"{self.indent}<{name}")
        self.indent += "  "
        return depth

    def attribute(self, name: str, value: str):
        if self.stack:
            self.out.append(f'\n{self.indent}{name}="{value}"')
            self.stack[-1][1] = True

    def xmlns(self, prefix: str, uri: str):
        self.attribute(f"xmlns:{prefix}", uri)

    def finish_element(self):
        if not self.stack:
            return
        self.indent = self.indent[:-2]
        name, has_attrs, has_content, has_children = self.stack.pop()
        if not has_content and not has_children:
            if not has_attrs or has_children:
                self.out.append(self.indent)
            self.out.append("/>\n")
        else:
            if not has_content:
                self.out.append(self.indent)
            self.out.append(f"</{name}>\n")

    def finish_to_depth(self, depth: int):
        while len(self.stack) > depth:
            self.finish_element()

    def finish(self) -> str:
        self.finish_to_depth(0)
        return "".join(self.out)


def _begin_xmpmeta(w: _XmlWriter):
    w.start_element("x:xmpmeta")
    w.xmlns("x", "adobe:ns:meta/")
    w.attribute("x:xmptk", "Adobe XMP Core 5.1.2")
    w.start_element("rdf:RDF")
    w.xmlns("rdf", "http://www.w3.org/1999/02/22-rdf-syntax-ns#")
    w.start_element("rdf:Description")


def generate_xmp_for_primary_image(secondary_image_length: int,
                                   metadata: GainMapMetadata) -> str:
    """GContainer Directory XMP for the primary image
    (jpegrutils.cpp:547-583)."""
    w = _XmlWriter()
    _begin_xmpmeta(w)
    w.xmlns("Container", _CONTAINER_URI)
    w.xmlns("Item", _ITEM_URI)
    w.xmlns("hdrgm", _GAINMAP_URI)
    w.attribute("hdrgm:Version", metadata.version)

    w.start_element("Container:Directory")
    w.start_element("rdf:Seq")

    item_depth = w.start_element("rdf:li")
    w.attribute("rdf:parseType", "Resource")
    w.start_element("Container:Item")
    w.attribute("Item:Semantic", "Primary")
    w.attribute("Item:Mime", "image/jpeg")
    w.finish_to_depth(item_depth)

    w.start_element("rdf:li")
    w.attribute("rdf:parseType", "Resource")
    w.start_element("Container:Item")
    w.attribute("Item:Semantic", "GainMap")
    w.attribute("Item:Mime", "image/jpeg")
    w.attribute("Item:Length", str(int(secondary_image_length)))
    return w.finish()


def generate_xmp_for_secondary_image(metadata: GainMapMetadata) -> str:
    """hdrgm metadata XMP (log2-space boosts) for the gain map image
    (jpegrutils.cpp:585-609)."""
    w = _XmlWriter()
    _begin_xmpmeta(w)
    w.xmlns("hdrgm", _GAINMAP_URI)
    w.attribute("hdrgm:Version", metadata.version)
    w.attribute("hdrgm:GainMapMin", _fmt(math.log2(metadata.min_content_boost)))
    w.attribute("hdrgm:GainMapMax", _fmt(math.log2(metadata.max_content_boost)))
    w.attribute("hdrgm:Gamma", _fmt(metadata.gamma))
    w.attribute("hdrgm:OffsetSDR", _fmt(metadata.offset_sdr))
    w.attribute("hdrgm:OffsetHDR", _fmt(metadata.offset_hdr))
    w.attribute("hdrgm:HDRCapacityMin", _fmt(math.log2(metadata.hdr_capacity_min)))
    w.attribute("hdrgm:HDRCapacityMax", _fmt(math.log2(metadata.hdr_capacity_max)))
    w.attribute("hdrgm:BaseRenditionIsHDR", "False")
    return w.finish()


_ATTR_RE = re.compile(rb'([A-Za-z_][\w.:-]*)\s*=\s*"([^"]*)"')
_DESC_RE = re.compile(rb"<rdf:Description\b(.*?)(/?)>", re.DOTALL)


def _collect_description_attrs(xml: bytes) -> dict:
    attrs: dict[bytes, bytes] = {}
    for m in _DESC_RE.finditer(xml):
        for k, v in _ATTR_RE.findall(m.group(1)):
            attrs.setdefault(k, v)
    return attrs


def get_metadata_from_xmp(xmp: bytes) -> GainMapMetadata:
    """Parse gain-map metadata from a gainmap-image XMP APP1 payload
    (including the namespace signature); raises UhdrError on failure.
    Mirrors getMetadataFromXMP (jpegrutils.cpp:436-545).
    """
    ns = XMP_NAMESPACE.encode() + b"\x00"
    if len(xmp) < len(ns) + 1:
        raise err("UHDR_CODEC_ERROR", "xmp data too short")
    if not xmp.startswith(XMP_NAMESPACE.encode()):
        raise err("UHDR_CODEC_ERROR", "xmp namespace mismatch")
    body = xmp[len(ns):]

    # Strip packet header: advance to first '<' not followed by '?'.
    for i in range(len(body)):
        if body[i:i + 1] == b"<" and body[i + 1:i + 2] != b"?":
            body = body[i:]
            break
    # Strip packet trailer: cut after last '>' not preceded by '?'.
    for i in range(len(body) - 1, 0, -1):
        if body[i:i + 1] == b">" and body[i - 1:i] != b"?":
            body = body[:i + 1]
            break
    # Strip padding.
    while len(body) > 1 and not body.endswith(b">"):
        body = body[:-1]

    attrs = _collect_description_attrs(body)

    def get_float(name: bytes):
        if name not in attrs:
            return None
        try:
            return float(attrs[name])
        except ValueError:
            raise err("UHDR_CODEC_ERROR",
                      f"invalid float for {name.decode()}")

    if b"hdrgm:Version" not in attrs:
        raise err("UHDR_CODEC_ERROR", "missing hdrgm:Version")
    md = GainMapMetadata(version=attrs[b"hdrgm:Version"].decode())

    v = get_float(b"hdrgm:GainMapMax")
    if v is None:
        raise err("UHDR_CODEC_ERROR", "missing hdrgm:GainMapMax")
    md.max_content_boost = 2.0 ** v

    v = get_float(b"hdrgm:HDRCapacityMax")
    if v is None:
        raise err("UHDR_CODEC_ERROR", "missing hdrgm:HDRCapacityMax")
    md.hdr_capacity_max = 2.0 ** v

    v = get_float(b"hdrgm:GainMapMin")
    md.min_content_boost = 2.0 ** v if v is not None else 1.0
    v = get_float(b"hdrgm:Gamma")
    md.gamma = v if v is not None else 1.0
    v = get_float(b"hdrgm:OffsetSDR")
    md.offset_sdr = v if v is not None else 1.0 / 64.0
    v = get_float(b"hdrgm:OffsetHDR")
    md.offset_hdr = v if v is not None else 1.0 / 64.0
    v = get_float(b"hdrgm:HDRCapacityMin")
    md.hdr_capacity_min = 2.0 ** v if v is not None else 1.0

    if attrs.get(b"hdrgm:BaseRenditionIsHDR", b"False") == b"True":
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "BaseRenditionIsHDR=True is not supported")
    return md
