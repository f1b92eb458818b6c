"""The port's plain colour functions (libultrahdr_dev_tpu_torch/ops/
color.py) against the JAX package's (libultrahdr_dev_tpu/ops/color.py),
jitted as the JAX package runs them, on the same numpy inputs.

Tolerances: float32 results within 2 ULP (the two frameworks' exp, log
and pow differ in the last bits); the u8 gain code equal, including the
reference's saturate-at-254 boundary; the F16 and RGBA1010102 packs
bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.ops import color as jc
from libultrahdr_dev_tpu_torch.ops import color as tc
import test_torch_threads  # noqa: F401  (caps torch's threads)

N = 20000


def _inputs(lo=0.0, hi=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, N).astype(np.float32)
    # Exact boundaries and the region around the piecewise splits.
    edges = np.array([0.0, 1e-4, 0.04045, 1 / 12, 0.5, 1.0], np.float32)
    return np.concatenate([edges[(edges >= lo) & (edges <= hi)], x])


def _ulps(a, b):
    """ULP distance of two float32 arrays (monotone integer mapping)."""
    def key(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("name", ["srgb_inv_oetf", "hlg_oetf",
                                  "hlg_inv_oetf", "pq_oetf",
                                  "pq_inv_oetf"])
def test_transfer_functions(name):
    x = _inputs()
    want = np.asarray(jax.jit(getattr(jc, name))(x))
    got = getattr(tc, name)(torch.from_numpy(x)).numpy()
    ulps = _ulps(got, want)
    if not name.startswith("pq_"):
        assert int(ulps.max()) <= 2
        return
    # PQ's powers (outer exponent 78.8 in the OETF, 6.3 after a
    # cancelling difference in the inverse) amplify a 1-ULP difference
    # of the two frameworks' inner pow() on a few inputs: there the
    # bound is relative, 1e-4, and 2 ULP must hold on >= 99.9%.
    assert float((ulps <= 2).mean()) >= 0.999
    rel = np.abs(got.astype(np.float64) - want) / np.maximum(want, 1e-30)
    assert float(rel[want > 1e-6].max()) <= 1e-4


@pytest.mark.parametrize("gamut", ["bt709", "p3", "bt2100"])
def test_yuv_to_rgb_and_luminance(gamut):
    rng = np.random.default_rng(1)
    y = rng.uniform(0, 1, N).astype(np.float32)
    u, v = (rng.uniform(-0.5, 0.5, N).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda a, b, c: jc.luminance_fn(gamut)(
        jc.yuv_to_rgb_fn(gamut)((a, b, c))))(y, u, v)
    got = tc.luminance_fn(gamut)(tc.yuv_to_rgb_fn(gamut)(
        tuple(torch.from_numpy(a) for a in (y, u, v))))
    assert int(_ulps(got.numpy(), np.asarray(want)).max()) <= 2


def test_matrices_match():
    for src in ("bt709", "p3", "bt2100"):
        for dst in ("bt709", "p3", "bt2100"):
            assert tc.yuv_conversion_matrix(src, dst) == \
                jc.yuv_conversion_matrix(src, dst)
    for tf in ("linear", "hlg", "pq"):
        assert tc.hdr_inv_oetf_fn(tf)[1] == jc.hdr_inv_oetf_fn(tf)[1]


@pytest.mark.parametrize("max_boost", [1000 / 203, 10000 / 203])
def test_encode_gain_equal(max_boost):
    rng = np.random.default_rng(2)
    sdr = rng.uniform(0, 300, N).astype(np.float32)
    hdr = rng.uniform(0, 3000, N).astype(np.float32)
    # Saturated (gain >= max boost -> 254), floor, zero-SDR cases.
    sdr[:4] = [10.0, 10.0, 0.0, 50.0]
    hdr[:4] = [10.0 * max_boost * 2, 5.0, 7.0, 50.0]
    want = np.asarray(jax.jit(lambda a, b: jc.encode_gain(
        a, b, 1.0, max_boost))(sdr, hdr))
    got = tc.encode_gain(torch.from_numpy(sdr), torch.from_numpy(hdr), 1.0,
                         max_boost).numpy()
    # At HLG's max boost the reference saturates at 254, not 255.
    assert got[0] == want[0] == (254 if max_boost < 10 else 255)
    np.testing.assert_array_equal(got, want)


def test_packs_bit_equal():
    rng = np.random.default_rng(3)
    rgb = [rng.uniform(-0.2, 1.3, N).astype(np.float32) for _ in range(3)]
    t = tuple(torch.from_numpy(c) for c in rgb)
    want = np.asarray(jax.jit(jc.pack_rgba1010102)(tuple(rgb)))
    got = tc.pack_rgba1010102(t).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    big = [c * 70000.0 for c in rgb]  # includes F16 overflow to inf
    want = np.asarray(jax.jit(jc.pack_rgba_f16)(tuple(big)))
    got = tc.pack_rgba_f16(tuple(torch.from_numpy(c) for c in big))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    assert jnp.dtype(want.dtype) == jnp.uint16


def test_import_makes_the_first_vector_math_call():
    """The cause of a flaky hlg_oetf case: MKL's vector math (torch's
    CPU sqrt, log, exp, log2) sets itself up on its first call, and when
    that call is a parallel region a worker thread can return ~12-bit
    results (torch.sqrt of this file's 20,006 inputs up to 3,930 ULP
    off). Importing the port makes that first call on one thread: a
    fresh interpreter's VML mode word carries the bits a torch VML call
    sets (0x140000) right after the import."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import ctypes, os, torch\n"
        "lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__),"
        " 'lib', 'libtorch_cpu.so'))\n"
        "if not hasattr(lib, 'vmlGetMode'):\n"
        "    print('none'); raise SystemExit\n"
        "before = lib.vmlGetMode()\n"
        "import libultrahdr_dev_tpu_torch.ops.color\n"
        "print(before, lib.vmlGetMode())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=root).stdout.split()
    if out == ["none"]:
        pytest.skip("this torch has no MKL vector math")
    before, after = map(int, out)
    assert before & 0x140000 == 0
    assert after & 0x140000 == 0x140000
