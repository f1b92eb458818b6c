"""The port's packed pixel readbacks (libultrahdr_dev_tpu_torch/
parallel/packio.py, link.py) against the JAX package's (parallel/
packio.py, sharding.py), on the CPU, where each kernel runs its plain
version: the RCT fine-width pack (B17), the device pack of a 10-bit
plane (B21) and fetch_pixels_packed; and the inputs and the per-test
plan reset of test_torch_readback_b15.py (Rice pass 1 at 10 and 16
bits), test_torch_readback_b16.py (the Rice pack, two-phase and fused)
and test_torch_readback_fetch{,16}.py (the fetches over rounds, the
native unpacks). The tests are split by kernel so that pytest-xdist's
--dist loadfile spreads their JAX compiles over its workers. Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.parallel import packio as jpackio, sharding
from libultrahdr_dev_tpu.types import PixelFormat as JPixelFormat
from libultrahdr_dev_tpu_torch.parallel import link, packio
from libultrahdr_dev_tpu_torch.types import PixelFormat

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)


def _smooth(rng, shape, amp, hi):
    """8x8-block content below `hi` with noise below `amp` (decoded-like:
    compresses well)."""
    n, h, w, c = shape
    base = np.kron(rng.integers(0, hi, (n, h // 8 + 1, w // 8 + 1, c)),
                   np.ones((1, 8, 8, 1), np.int64))[:, :h, :w]
    return np.clip(base + rng.integers(0, amp, base.shape), 0, hi - 1)


def rgba1010102(n, h, w, seed=0, noise=False):
    """uint32 RGBA1010102 words, alpha 3: correlated smooth channels, or
    uniform noise (the packer declines it)."""
    rng = np.random.default_rng(seed)
    if noise:
        c = rng.integers(0, 1024, (n, h, w, 3))
    else:
        g = _smooth(rng, (n, h, w, 1), 3, 1024)
        c = np.clip(g + rng.integers(-2, 3, (n, h, w, 3)), 0, 1023)
    c = c.astype(np.uint32)
    return (c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)
            | np.uint32(0xC0000000))


def rgba_f16(n, h, w, seed=0, noise=False):
    """uint16 RGBA F16 halves of positive values below 1.0, alpha 1.0:
    smooth, or uniform noise over all 16 bits."""
    rng = np.random.default_rng(seed)
    if noise:
        c = rng.integers(0, 65536, (n, h, w, 3))
    else:
        c = _smooth(rng, (n, h, w, 3), 40, 0x0C00) + 0x3000
    out = np.full((n, h, w, 4), 0x3C00, np.uint16)
    out[..., :3] = c
    return out


def _src(bits, n, h, w, seed=0, noise=False):
    """(numpy pixels, port tensor) of one format."""
    if bits == 10:
        x = rgba1010102(n, h, w, seed, noise)
        return x, torch.from_numpy(x.view(np.int32))
    x = rgba_f16(n, h, w, seed, noise)
    return x, torch.from_numpy(x.view(np.int16))


def _kset(bits):
    return (jpackio._RICE16_KS, jpackio._RICE16_ZERO) if bits == 16 else (
        jpackio._RICE_KS, jpackio._RICE_ZERO)


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    """Empty plan caches and speed samples in both packages, auto pick
    not forced, fused fetch on, serial unpack."""
    for mod in (packio, jpackio):
        monkeypatch.setattr(mod, "_PLAN_CACHE", {})
        monkeypatch.setattr(mod, "_BPS", {})
    for var in ("UHDR_READBACK_SCHEME", "UHDR_FUSED_FETCH",
                "UHDR_FETCH_SYNC_STAGES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("UHDR_UNPACK_THREADS", "1")


SHAPES = [(2, 64, 200), (1, 40, 300), (2, 32, 512)]


def _plan(bits, t, med):
    (zs,), kuw = packio.rice_stats(t, (med,))
    km = kuw.numpy()
    return zs, kuw, packio._rice_host_plan(km[0], km[1], 10**12, bits)


def _edge_src(bits, n, h, w, content, seed=0):
    """(numpy pixels, port tensor) of the content B15 and B16 branch on:
    all zero, full-range noise, or (bits 16) G - R and G - B flipping by
    2^15 from row to row, whose best k is 15."""
    if content == "noise":
        return _src(bits, n, h, w, seed, noise=True)
    rng = np.random.default_rng(seed)
    if bits == 10:
        x = np.full((n, h, w), 0xC0000000, np.uint32)
        return x, torch.from_numpy(x.view(np.int32))
    x = np.zeros((n, h, w, 4), np.uint16)
    x[..., 3] = 0x3C00
    if content == "k15":
        g = rng.integers(0, 65536, (n, h, w))
        flip = (np.arange(h) % 2 * 0x8000)[None, :, None]
        x[..., 0], x[..., 1], x[..., 2] = g ^ flip, g, g ^ flip ^ 0x8000
    return x, torch.from_numpy(x.view(np.int16))


EDGE_CONTENT = [(10, "zero"), (10, "noise"), (16, "zero"), (16, "noise"),
                (16, "k15")]


FETCHES = {10: ("fetch_rgba1010102_rice", "fetch_rgba1010102_med",
                "fetch_rgba1010102_auto"),
           16: ("fetch_rgba_f16_rice", "fetch_rgba_f16_med",
                "fetch_rgba_f16_auto")}


# ---------------------------------------------------------------------------
# B17: the RCT fine-width pack.
# ---------------------------------------------------------------------------

#: 9,216 segments: five tiles of the order's 2,048 in the kernel, the
#: last a half, with padding rows that take wider segments (they carry).
B17_TILED = (2, 96, 1000)


@pytest.mark.parametrize("shape", SHAPES + [B17_TILED])
def test_b17_equals_jax(shape):
    x, t = _src(10, *shape, seed=8)
    zs, bc = packio.rct_widths(t)
    jzs, jbc = jpackio._rct_widths_fn(shape)(jnp.asarray(x))
    assert np.array_equal(zs.numpy().view(np.uint16), np.asarray(jzs))
    assert np.array_equal(bc.numpy(), np.asarray(jbc))
    flat = bc.numpy().reshape(-1)
    counts = np.bincount(packio.FINE_RANK[flat], minlength=9)
    npads = tuple(packio._pow2_pad(max(int(c), 1), floor=32)
                  for c in counts[1:])
    offs = np.cumsum(counts[:8]).astype(np.int32)
    if shape == B17_TILED:
        assert any(c < p and o + c < flat.size
                   for c, p, o in zip(counts[1:], npads, offs))
    got = packio.rct_pack(zs, bc, offs, npads)
    want = jpackio._rct_devpack_fn(flat.size, npads)(jzs, jbc, offs)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    blob = got.numpy().view(np.uint32)
    for unpack in (packio._host_unpack_rct, packio._host_unpack_rct_numpy):
        assert np.array_equal(unpack(blob, bc.numpy(), npads, *shape), x)


@pytest.mark.parametrize("shape,noise", [((2, 64, 200), False),
                                         ((1, 96, 320), False),
                                         ((2, 64, 200), True)])
def test_fetch_rgba1010102_batch_equals_jax(shape, noise):
    x, t = _src(10, *shape, seed=9, noise=noise)
    got, nbytes = packio.fetch_rgba1010102_batch(t)
    want, jbytes = jpackio.fetch_rgba1010102_batch(jnp.asarray(x))
    assert nbytes == jbytes
    if noise:
        assert got is None and want is None
    else:
        assert np.array_equal(got, x) and np.array_equal(want, x)


# ---------------------------------------------------------------------------
# B21: the device pack of a 10-bit plane.
# ---------------------------------------------------------------------------

def _plane(h, w, seed, noise=False):
    rng = np.random.default_rng(seed)
    amp = 1024 if noise else 3
    return _smooth(rng, (1, h, w, 1), amp, 1024)[0, ..., 0].astype(np.uint16)


@pytest.mark.parametrize("shape,noise", [((64, 200), False),
                                         ((96, 512), False),
                                         ((32, 300), True)])
def test_b21_pack_plane_device_equals_jax(shape, noise):
    a = _plane(*shape, seed=10, noise=noise)
    t = torch.from_numpy(a.view(np.int16))
    zs, bc = packio.plane_widths(t)
    jzs, jbc = jpackio._widths_fn(shape)(jnp.asarray(a))
    assert np.array_equal(zs.numpy().view(np.uint16), np.asarray(jzs))
    assert np.array_equal(bc.numpy(), np.asarray(jbc))
    got = packio.pack_plane_device(t)
    want = jpackio.pack_plane_device(jnp.asarray(a))
    assert got.plan == want.plan and np.array_equal(got.perm, want.perm)
    for bw in packio.WIDTHS:
        assert np.array_equal(got.buckets[bw], np.asarray(want.buckets[bw]))
    assert np.array_equal(packio.unpack_plane_host(got), a)


def test_b21_plane_readback_records_its_stages():
    """Given a StageTimes, pack_plane_device and unpack_plane_host name
    each part of the readback once (PLANE_PACK_STAGES), and the plane
    comes back the same."""
    from libultrahdr_dev_tpu_torch.utils.profiler import StageTimes

    a = _plane(64, 300, seed=12, noise=False)
    st = StageTimes()
    got = packio.unpack_plane_host(packio.pack_plane_device(
        torch.from_numpy(a.view(np.int16)), times=st), times=st)
    assert np.array_equal(got, a)
    assert sorted(st.counts) == sorted(packio.PLANE_PACK_STAGES)
    assert set(st.counts.values()) == {1}


def test_b21_declines_over_max_bytes_as_jax():
    a = _plane(64, 256, seed=11, noise=True)
    t = torch.from_numpy(a.view(np.int16))
    assert packio.pack_plane_device(t, max_bytes=10_000) is None
    assert jpackio.pack_plane_device(jnp.asarray(a), max_bytes=10_000) is None
    assert packio.pack_plane_device(t, max_bytes=10**9) is not None


# ---------------------------------------------------------------------------
# link.py: fetch_1010102_packed, fetch_f16_packed, fetch_pixels_packed.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,pack", [
    ((10, (2, 128, 600), False), "rct-rice-auto"),
    ((10, (1, 64, 128), False), "rct-seg"),      # Rice's floor declines
    ((10, (2, 64, 200), True), "raw"),
    ((16, (2, 128, 600), False), "rct-rice16-auto"),
    ((16, (2, 64, 200), True), "raw")])
def test_fetch_packed_equals_jax(case, pack):
    bits, shape, noise = case
    x, t = _src(bits, *shape, seed=12, noise=noise)
    fetch, jfetch = {10: (link.fetch_1010102_packed,
                          sharding.fetch_1010102_packed),
                     16: (link.fetch_f16_packed,
                          sharding.fetch_f16_packed)}[bits]
    stats, jstats = {}, {}
    got = fetch(t, stats)
    want = jfetch(jnp.asarray(x), jstats)
    assert np.array_equal(got, x) and np.array_equal(want, x)
    assert got.dtype == want.dtype
    assert stats["d2h_pack"].split("(")[0] == pack
    assert stats["d2h_pack"] == jstats["d2h_pack"]
    assert stats["d2h_bytes"] == jstats["d2h_bytes"]
    assert ("d2h_stages" in stats) == (pack != "raw")


@pytest.mark.parametrize("fmt,jfmt", [
    ("rgba1010102", "rgba1010102"),
    (PixelFormat.RGBA1010102, JPixelFormat.RGBA1010102),
    (PixelFormat.RGBA_F16, JPixelFormat.RGBA_F16),
    ("rgba_f16", "rgba_f16")])
@pytest.mark.parametrize("single", [False, True])
def test_fetch_pixels_packed_equals_jax(fmt, jfmt, single):
    bits = 16 if "f16" in str(getattr(fmt, "value", fmt)) else 10
    x, t = _src(bits, 2, 128, 600, seed=13)
    if single:
        x, t = x[1], t[1]
    stats, jstats = {}, {}
    got = link.fetch_pixels_packed(t, stats, fmt=fmt)
    want = sharding.fetch_pixels_packed(jnp.asarray(x), jstats, fmt=jfmt)
    assert got.shape == x.shape and np.array_equal(got, x)
    assert np.array_equal(got, want)
    assert stats["d2h_pack"] == jstats["d2h_pack"] != "raw"
    assert stats["d2h_bytes"] == jstats["d2h_bytes"] < x.nbytes


@pytest.mark.parametrize("fmt", [None, "rgba8888", PixelFormat.RGBA8888,
                                 "rgba_f16"])
def test_fetch_pixels_packed_refuses_look_alikes(fmt):
    """SDR RGBA8888 words look like RGBA1010102 (int32 (h, w)); without
    the packable format's name, or with a format whose dtype does not
    match, the copy is raw and keeps the alpha byte as it is."""
    rng = np.random.default_rng(14)
    x = (rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
         .view(np.uint32)[..., 0])
    stats, jstats = {}, {}
    got = link.fetch_pixels_packed(torch.from_numpy(x.view(np.int32)), stats,
                                   fmt=fmt)
    want = sharding.fetch_pixels_packed(jnp.asarray(x), jstats,
                                        fmt=getattr(fmt, "value", fmt))
    assert np.array_equal(got, x) and np.array_equal(want, x)
    assert stats == jstats == {"d2h_bytes": x.nbytes, "d2h_pack": "raw"}


def test_fetch_pixels_packed_host_array_passes_through():
    x = rgba1010102(1, 32, 64)[0]
    stats, jstats = {}, {}
    assert link.fetch_pixels_packed(x, stats, fmt="rgba1010102") is x
    assert sharding.fetch_pixels_packed(x, jstats, fmt="rgba1010102") is x
    assert stats == jstats == {"d2h_bytes": 0, "d2h_pack": "host"}


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors the new wrappers take their plain versions and
    launch nothing."""
    x, t = _src(10, 1, 64, 128, seed=15)
    before = (packio.rct_widths.launches, packio.rct_pack.launches,
              packio.plane_widths.launches, packio.plane_pack.launches)
    calls = (packio.rct_widths_plain.calls, packio.rct_pack_plain.calls,
             packio.plane_widths_plain.calls, packio.plane_pack_plain.calls)
    assert packio.fetch_rgba1010102_batch(t)[0] is not None
    assert packio.pack_plane_device(torch.from_numpy(
        _plane(32, 64, 15).view(np.int16))) is not None
    assert (packio.rct_widths.launches, packio.rct_pack.launches,
            packio.plane_widths.launches, packio.plane_pack.launches) == before
    assert [b - a for a, b in zip(calls, (
        packio.rct_widths_plain.calls, packio.rct_pack_plain.calls,
        packio.plane_widths_plain.calls,
        packio.plane_pack_plain.calls))] == [1, 1, 1, 1]
