"""ctypes loaders for the port's host C++ code.

The port carries its own copies of the JAX package's native sources and
compiles each with g++ at first use into the package's git-ignored
build directory, keyed by a hash of the source and the flags. Nothing
outside the port's package is read.

- ``jpeg/entropy.cpp``: the host Huffman entropy codec and the
  progressive scan decoders (``get_lib``).
- ``jpeg/arith.cpp``: the arithmetic (QM) entropy codec (``get_arith``).
- ``parallel/packio.cpp``: the upload's segment pack and the planes
  readback's Rice unpack (``get_packio``).
- ``ops/apply.cpp``: the gain-map apply on the host (``get_apply``).

The last two are built with the JAX package's own flags
(libultrahdr_dev_tpu/jpeg/native/__init__.py), so their float results
are bitwise the JAX ones'; ``-march=native`` ties the object to the
host's instruction set, so its key includes the CPU's feature flags.

There is no pure-Python fallback: if g++ cannot build a source, the
first call that needs it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SRC = os.path.join(_HERE, "entropy.cpp")
ARITH_SRC = os.path.join(_HERE, "arith.cpp")
PACKIO_SRC = os.path.join(_PKG, "parallel", "packio.cpp")
APPLY_SRC = os.path.join(_PKG, "ops", "apply.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
HOST_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
              "-fno-math-errno", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: dict = {}


def _cpu_flags() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith(("flags", "Features")):
                return line
    return ""


def _so_path(src_bytes: bytes, stem: str = "entropy",
             flags=_FLAGS) -> str:
    tag = " ".join(flags)
    if "-march=native" in flags:
        tag += platform.machine() + _cpu_flags()
    key = hashlib.sha1(src_bytes + tag.encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{stem}-{key[:12]}.so")


def build_shared(src: str, flags=_FLAGS) -> str:
    """Compile `src` with g++ into the build directory (if not there
    yet) and return the shared object's path; raise if g++ fails."""
    with open(src, "rb") as f:
        so = _so_path(f.read(), os.path.basename(src)[:-4], flags)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *flags, src, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds race harmlessly
    return so


def _load(src: str, flags, bind):
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build_shared(src, flags))
            bind(lib)
            _libs[src] = lib
        return lib


def _bind_entropy(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.uhdr_huff_encode.restype = ctypes.c_long
    lib.uhdr_huff_encode.argtypes = [
        i16p, ctypes.c_long, u8p, ctypes.c_int, u8p, u8p,
        u8p, u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_long]
    lib.uhdr_huff_decode.restype = ctypes.c_long
    lib.uhdr_huff_decode.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, u8p, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
        i16p]
    lib.uhdr_destuff_rst.restype = ctypes.c_long
    lib.uhdr_destuff_rst.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.uhdr_find_eoi.restype = ctypes.c_long
    lib.uhdr_find_eoi.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_long]
    lib.uhdr_decode_tables.restype = ctypes.c_long
    lib.uhdr_decode_tables.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_void_p, ctypes.c_long]
    lib.uhdr_huff_scan_offsets.restype = ctypes.c_long
    lib.uhdr_huff_scan_offsets.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, u8p, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int, u8p,
        ctypes.POINTER(ctypes.c_long)]
    lib.uhdr_prog_dc_first.restype = ctypes.c_long
    lib.uhdr_prog_dc_first.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, u8p, ctypes.c_int,
        u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i16p]
    lib.uhdr_prog_dc_refine.restype = ctypes.c_long
    lib.uhdr_prog_dc_refine.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i16p]
    for name in ("uhdr_prog_ac_first", "uhdr_prog_ac_refine"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, u8p, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i16p]


def _bind_arith(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lng, cint = ctypes.c_long, ctypes.c_int
    lib.uhdr_arith_decode_seq.restype = lng
    lib.uhdr_arith_decode_seq.argtypes = [
        u8p, lng, lng, u8p, cint, u8p, u8p, u8p, u8p, u8p, cint, cint,
        i16p]
    lib.uhdr_arith_encode_seq.restype = lng
    lib.uhdr_arith_encode_seq.argtypes = [
        i16p, lng, u8p, cint, u8p, u8p, u8p, u8p, u8p, cint, cint,
        u8p, lng]
    lib.uhdr_arith_prog_dc_first.restype = lng
    lib.uhdr_arith_prog_dc_first.argtypes = [
        u8p, lng, lng, u8p, cint, u8p, u8p, u8p, cint, cint, cint, i16p]
    lib.uhdr_arith_prog_dc_refine.restype = lng
    lib.uhdr_arith_prog_dc_refine.argtypes = [
        u8p, lng, lng, cint, cint, cint, i16p]
    lib.uhdr_arith_prog_ac_first.restype = lng
    lib.uhdr_arith_prog_ac_first.argtypes = [
        u8p, lng, lng, cint, cint, cint, cint, cint, i16p]
    lib.uhdr_arith_prog_ac_refine.restype = lng
    lib.uhdr_arith_prog_ac_refine.argtypes = [
        u8p, lng, lng, cint, cint, cint, cint, i16p]


def _bind_packio(lib):
    p = ctypes.c_void_p
    lng = ctypes.c_long
    # kmap, uwmap, blob, rem word offsets, unary word offsets, n, h, w,
    # scratch, out[, nthreads]
    for name in ("uhdr_rice8_unpack", "uhdr_med8_unpack", "uhdr_rice_unpack",
                 "uhdr_med_unpack", "uhdr_rice16_unpack",
                 "uhdr_med16_unpack"):
        for suffix, extra in (("", []), ("_mt", [lng])):
            fn = getattr(lib, name + suffix)
            fn.restype = lng
            fn.argtypes = [p] * 5 + [ctypes.c_int64] * 3 + [p, p] + extra
    # bmap, blob, bucket word offsets, n, h, w, scratch, out
    lib.uhdr_rctseg_unpack.restype = lng
    lib.uhdr_rctseg_unpack.argtypes = [p] * 3 + [ctypes.c_int64] * 3 + [p, p]
    lib.uhdr_seg_widths.restype = lng
    lib.uhdr_seg_widths.argtypes = [p, ctypes.c_int64, ctypes.c_int64, p, p]
    lib.uhdr_seg_fill.restype = lng
    lib.uhdr_seg_fill.argtypes = [p, ctypes.c_int64, ctypes.c_int64,
                                  p, p, p, p]


def _bind_apply(lib):
    i64 = ctypes.c_int64
    f = ctypes.c_float
    lib.uhdr_apply_gainmap.restype = ctypes.c_long
    lib.uhdr_apply_gainmap.argtypes = [
        ctypes.c_void_p] + [i64] * 8 + [f] * 4 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long]


def get_lib():
    """The ctypes library with uhdr_huff_encode, uhdr_huff_decode,
    uhdr_destuff_rst, uhdr_find_eoi, uhdr_decode_tables,
    uhdr_huff_scan_offsets and the progressive scan decoders
    (uhdr_prog_dc_first, uhdr_prog_dc_refine, uhdr_prog_ac_first,
    uhdr_prog_ac_refine) bound. Builds on first call; raises if the
    build fails."""
    return _load(SRC, _FLAGS, _bind_entropy)


def get_arith():
    """The ctypes library of jpeg/arith.cpp with the seven
    uhdr_arith_* entry points bound (sequential decode and encode, the
    four progressive scan decoders). Builds on first call; raises if the
    build fails."""
    return _load(ARITH_SRC, _FLAGS, _bind_arith)


def get_packio():
    """The ctypes library of parallel/packio.cpp with the segment pack
    (uhdr_seg_widths, uhdr_seg_fill), the Rice unpacks at 8, 10 and 16
    bits (uhdr_{rice,med}{8,,16}_unpack and their _mt forms) and the
    fine-width unpack (uhdr_rctseg_unpack) bound."""
    return _load(PACKIO_SRC, HOST_FLAGS, _bind_packio)


def get_apply():
    """The ctypes library of ops/apply.cpp with uhdr_apply_gainmap
    bound."""
    return _load(APPLY_SRC, HOST_FLAGS, _bind_apply)
