"""ctypes loader for the host Huffman entropy codec.

The port carries its own copy of the codec, ``jpeg/entropy.cpp`` (it
includes only <cstdint>/<cstring>), and compiles it with g++ at first
use into the package's git-ignored build directory. Nothing outside
the port's package is read.

There is no pure-Python fallback: if g++ cannot build the codec, the
first call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "entropy.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _so_path(src_bytes: bytes) -> str:
    key = hashlib.sha1(src_bytes + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"entropy-{key[:12]}.so")


def _build() -> str:
    with open(SRC, "rb") as f:
        so = _so_path(f.read())
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *_FLAGS, SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds race harmlessly
    return so


def get_lib():
    """The ctypes library with uhdr_huff_encode, uhdr_huff_decode and
    uhdr_huff_scan_offsets bound. Builds on first call; raises if the
    build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
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
        lib.uhdr_huff_scan_offsets.restype = ctypes.c_long
        lib.uhdr_huff_scan_offsets.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, u8p, ctypes.c_int,
            u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int, u8p,
            ctypes.POINTER(ctypes.c_long)]
        _lib = lib
        return _lib
