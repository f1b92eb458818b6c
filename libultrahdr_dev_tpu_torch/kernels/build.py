"""Build and bind the port's CUDA kernels.

The sources in ``csrc/*.cu`` export a plain C interface, so nvcc builds
them in seconds into one shared object, without PyTorch's headers: one
nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/kernels-<hash>.so *.o

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions and the JAX reference compute them; the kernels
are bound by memory traffic, so fused multiply-adds would buy nothing.

The build runs on the first kernel launch, never at import, into the
package's git-ignored ``_build`` directory, keyed by a hash of the
sources and flags. Each C entry point enqueues on the stream it is
given, allocates nothing, and returns ``cudaGetLastError()``;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils import counters
from ..utils.profiler import span

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: every entry point returns cudaError_t as int and takes
# the CUDA stream last.
SIGNATURES = {
    # y, uv, gmap, y601, u601, v601, n, h, w, cr, cb, gcb, gcr,
    # lum_r, lum_g, lum_b, hdr_white, tf, convert, min_b, max_b,
    # log2_min, inv_denom, m01, m02, m11, m12, m21, m22, sat, floor, stream
    "uhdr_encode_front": [_P] * 6 + [_I] * 3 + [_F] * 8 + [_I] * 2
                         + [_F] * 10 + [_I] * 2 + [_P],
    # y, uv, sdr y, u, v, gmap, y601, u601, v601, n, h, w, float params
    # (host), int params (host), stream
    "uhdr_encode_front_api1": [_P] * 9 + [_I] * 3 + [_P] * 3,
    # y, uv, y8, u8, v8, n, h, w, stream
    "uhdr_tonemap_p010": [_P] * 5 + [_I] * 3 + [_P],
    # sdr y, u, v, y, uv, gmap, n, h, w, float params (host), int params
    # (host), sRGB table (or null), inverse-OETF table (or null), stream
    "uhdr_generate_gainmap": [_P] * 6 + [_I] * 3 + [_P] * 5,
    # y, u, v, y out, u out, v out, n, h, w, matrix (host), stream
    "uhdr_convert_yuv": [_P] * 6 + [_I] * 3 + [_P] * 2,
    # plane, q, kron B fragments, out, n, h, w, recip, d, inv_zig, stream
    "uhdr_fdct_quant": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # tiles, kron B fragments, out, n_tiles, stream
    "uhdr_mma_row_sums": [_P, _P, _P, _I, _P],
    # coefs, q, out, n, bh, bw, d, inv_zig, stream
    "uhdr_dequant_idct": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    # y, u, v, g, 4 x (batch stride, row stride), scalars, out, n, h,
    # w, mh, mw, scale, fmt, sRGB red / blue tables, stream
    "uhdr_apply_gainmap": [_P] * 4 + [_L] * 8 + [_P, _P] + [_I] * 7
                          + [_P, _P],
    # tables (2 x 65536 f32), stream
    "uhdr_srgb_rb_tables": [_P, _P],
    # as uhdr_apply_gainmap, then the sRGB and OETF tables, stream
    "uhdr_apply_gainmap_lut": [_P] * 4 + [_L] * 8 + [_P, _P] + [_I] * 7
                              + [_P] * 3,
    # p, lo bits, hi bits, counts, stream
    "uhdr_pow_check": [_F, ctypes.c_uint, ctypes.c_uint, _P, _P],
    # x, y, n, p, exact, stream
    "uhdr_pow_probe": [_P, _P, _I, _F, _I, _P],
    # y, u, v, 3 x (batch stride, row stride), out, n, h, w, stream
    "uhdr_yuv420_to_rgba8888": [_P] * 3 + [_L] * 6 + [_P] + [_I] * 3
                               + [_P],
    # y, u, v, tables, bits, blen, tval, tbit, meta, n, nc, r, color,
    # hs, vs, mcus_x, n_mcus, ny, nuv, K, P, T, stream
    "uhdr_huff_encode_count": [_P] * 9 + [_I] * 13 + [_P],
    # y, u, v, tables, bits, blen, tbit, out, n, nc, r, color, hs, vs,
    # mcus_x, n_mcus, ny, nuv, K, P, T, max_words, stream
    "uhdr_huff_encode_write": [_P] * 8 + [_I] * 14 + [_P],
    # y, u, v, tables, blen, tsum, toff, meta, n, color, hs, vs, mcus_x,
    # n_mcus, ny, nuv, stream
    "uhdr_huff_encode_rl_count": [_P] * 8 + [_I] * 8 + [_P],
    # y, u, v, tables, blen, toff, out, n, color, hs, vs, mcus_x, n_mcus,
    # ny, nuv, stream
    "uhdr_huff_encode_rl_write": [_P] * 7 + [_I] * 8 + [_P],
    # src, frames, lanes, tables, lookups, y, u, v, dcsum, n, n_lanes,
    # gray, hs, vs, mcus_x, mcus_y, stream
    "uhdr_huff_decode": [_P] * 9 + [_I] * 7 + [_P],
    # src, frames, lanes, tables, lookups, log entries, block starts,
    # counts, y, u, v, dcsum, n, n_lanes, gray, hs, vs, mcus_x, mcus_y,
    # stream
    "uhdr_huff_decode_log": [_P] * 12 + [_I] * 7 + [_P],
    # bytes of one frame's lookup scratch
    "uhdr_huff_lookup_bytes": [],
    # per plane (src, src row stride, dst) and (oh, ow, steps) (host),
    # planes, steps, stream
    "uhdr_edit_planes": [_P, _P, _I, _I, _P],
    # y hi, y lob, uv hi, uv lob, y out, uv out, y quads, uv quads, stream
    "uhdr_p010_dense_unpack": [_P] * 6 + [_L] * 2 + [_P],
    # blob, rows, w, nsegw, yrows, n2, n5, n10, y out, uv out, stream
    "uhdr_p010_seg_unpack": [_P] + [_I] * 7 + [_P] * 3,
    # src, rows, w, nsegw, mode, bits, nh, zs0, zs1, maps, stream
    "uhdr_rice_stats": [_P, _L, _I, _I, _I, _I, _L, _P, _P, _P, _P],
    # kmap, uwmap, nseg, nk, sidx_rem, sidx_un, offs, head, med, rem pads
    # (host), unary pads (host), pad bytes, their count, scratch, stream
    "uhdr_rice_order": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                        _I, _P, _P],
    # int32 scratch of the tiled order (B16, B17) for nseg segments
    "uhdr_rice_order_scratch": [_I],
    # zs, kmap, sidx_rem, sidx_un, offs, nseg, nk, start, nw, woff (host),
    # blob, stream
    "uhdr_rice_emit": [_P] * 5 + [_I, _I] + [_P] * 5,
    # src, nh, w, nsegw, zs, bc, stream
    "uhdr_rct_widths": [_P, _L, _I, _I, _P, _P, _P],
    # bc, nseg, sidx, totals (or null), scratch, stream
    "uhdr_rct_order": [_P, _I, _P, _P, _P, _P],
    # zs, bc, nseg, sidx, scratch, npads (host), offs (host), blob, stream
    "uhdr_rct_pack": [_P, _P, _I, _P, _P, _P, _P, _P, _P],
    # arr, h, w, nsegw, zs, bc, stream
    "uhdr_plane_widths": [_P, _I, _I, _I, _P, _P, _P],
    # zs, gidx, n2, n5, n10, blob, stream
    "uhdr_plane_pack": [_P, _P, _I, _I, _I, _P, _P],
    # y, u, v, g, 4 x (batch stride, row stride), out, n, h, w, ch, cw,
    # gh, gw, rows, wc, stream
    "uhdr_planes_composite": [_P] * 4 + [_L] * 8 + [_P] + [_I] * 9 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _so_path(srcs) -> str:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:12]}.so")


def _run(cmds) -> str:
    """Run the commands in parallel; raise on a failure, else return
    their standard error (where ptxas -v reports)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = [p.communicate()[1] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(c)}):\n{log}")
    return "".join(logs)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the build directory (if not yet there)
    and return the shared object's path. A build that runs nvcc is a
    span "kernels.build" and bumps counter "kernels_built"."""
    srcs = _sources()
    so = _so_path(srcs)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in srcs]
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    tmp = f"{so}.{tag}"
    with span("kernels.build"):
        log = _run([[nvcc, *FLAGS, *ptxas, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)])
        _run([[nvcc, ARCH, "-shared", "-o", tmp, *objs]])
    counters.bump("kernels_built")
    for o in objs:
        os.remove(o)
    if verbose:
        print(log, end="")
    os.replace(tmp, so)
    return so


def get_lib():
    """The ctypes handle of the built kernels (builds on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch(t, name: str, *args):
    """Call the C entry point `name` with `args` and the current stream
    of CUDA tensor `t`'s device, with that device current for the call
    (the entry points allocate nothing, but size their grids and set
    kernel attributes on the current device), then raise on an error
    code. Every kernel launch of the package goes through here, so a
    tensor on any card launches on its own card. When that card is
    already current (one GPU, or a caller inside torch.cuda.device)
    nothing is switched; reading the current device is legal inside
    CUDA-graph capture."""
    import torch

    fn = getattr(_lib if _lib is not None else get_lib(), name)
    if t.device.index == torch.cuda.current_device():
        rc = fn(*args, stream_of(t))
    else:
        with torch.cuda.device(t.device):
            rc = fn(*args, stream_of(t))
    check(rc, name)


def host_call(name: str, *args) -> int:
    """The result of a host-only C entry point (a scratch size); it
    launches nothing and takes no stream."""
    return getattr(get_lib(), name)(*args)


def require(t, name: str, dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
