"""The port's packed transfers (libultrahdr_dev_tpu_torch/parallel/
packio.py, link.py) against the JAX package's (parallel/packio.py,
sharding.py), on the CPU, where each kernel runs its plain version:
the host segment pack (native and numpy) and its device unpack (B14),
the batch upload in seg and dense modes (B0), Rice pass 1 (B15) and the
Rice pack (B16) at 8 bits, two-phase and fused, and the planar readback
fetch. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.parallel import packio as jpackio, sharding
from libultrahdr_dev_tpu_torch.parallel import link, packio
from libultrahdr_dev_tpu_torch.utils import counters

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)


def p010_content(n, h, w, seed=0, noise=False):
    """uint16 P010 batches: bench.py-like band-limited luma and chroma,
    or uniform noise."""
    rng = np.random.default_rng(seed)
    if noise:
        return (rng.integers(0, 1024, (n, h, w)).astype(np.uint16) << 6,
                rng.integers(0, 1024, (n, h // 2, w)).astype(np.uint16) << 6)
    y = np.kron(rng.integers(64, 940, (n, h // 32 + 1, w // 32 + 1)),
                np.ones((1, 32, 32)))[:, :h, :w]
    y = (y + np.roll(y, 7, 1) + np.roll(y, 7, 2)) / 3
    c = np.kron(rng.integers(448, 576, (n, h // 32 + 1, w // 32 + 1)),
                np.ones((1, 16, 32)))[:, :h // 2, :w]
    return (np.clip(y, 64, 940).astype(np.uint16) << 6,
            np.clip(c, 64, 960).astype(np.uint16) << 6)


def tall_plane(n, h, w, seed=0, noise=False):
    y, uv = p010_content(n, h, w, seed, noise)
    return np.concatenate([(y >> 6).reshape(n * h, w),
                           (uv >> 6).reshape(n * h // 2, w)])


def composite(n, h, w, seed=0, noisy_rows=0, amp=3):
    """An (n, 3*h, w) u8 composite like decoded planes: 8x8-block smooth
    content with noise below `amp`, its first rows noisier."""
    rng = np.random.default_rng(seed)
    c = np.kron(rng.integers(0, 256, (n, 3 * h // 8 + 1, w // 8 + 1)),
                np.ones((1, 8, 8)))[:, :3 * h, :w]
    c = c + rng.integers(0, amp, c.shape)
    c[:, :noisy_rows] = rng.integers(0, 256, (n, noisy_rows, w))
    return np.clip(c, 0, 255).astype(np.uint8)


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


# ---------------------------------------------------------------------------
# Upload: host pack, B14, B0.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["native", "numpy"])
@pytest.mark.parametrize("shape,noise", [((2, 128, 512), False),
                                         ((2, 256, 288), False),
                                         ((1, 128, 256), True)])
def test_pack_plane_host_blob_equals_jax(form, shape, noise):
    big = tall_plane(*shape, noise=noise)
    want = jpackio.pack_plane_host(big)
    assert want.plan == jpackio._pack_plane_native(big, *big.shape).plan
    pack = (packio.pack_plane_host if form == "native"
            else packio.pack_plane_host_numpy)
    got = pack(big)
    assert got.plan == want.plan
    assert np.array_equal(got.to_blob(), want.to_blob())
    assert np.array_equal(packio.unpack_plane_host(got), big)


@pytest.mark.parametrize("shape,noise", [((2, 128, 512), False),
                                         ((2, 128, 288), True),
                                         ((1, 64, 250), False),
                                         ((2, 128, 512), "zero")])
def test_plain_b14_equals_jax_and_the_input(shape, noise):
    """B14's plain version = JAX's unpack = the input: band-limited and
    noise content, one partial segment of a width that is no multiple of
    8, and an all-zero plane (every perm entry 0)."""
    n, h, w = shape
    if noise == "zero":
        y = np.zeros((n, h, w), np.uint16)
        uv = np.zeros((n, h // 2, w), np.uint16)
    else:
        y, uv = p010_content(n, h, w, seed=3, noise=noise)
    big = np.concatenate([(y >> 6).reshape(n * h, w),
                          (uv >> 6).reshape(n * h // 2, w)])
    pk = packio.pack_plane_host(big)
    blob = torch.from_numpy(pk.to_blob().view(np.int32))
    gy, guv = packio.unpack_plane_device(blob, pk.plan, n, h)
    want = np.asarray(jpackio.unpack_plane_device(jpackio.pack_plane_host(
        big)))
    assert np.array_equal(want, big)
    got = np.concatenate([gy.numpy().view(np.uint16).reshape(n * h, w),
                          guv.numpy().view(np.uint16).reshape(-1, w)]) >> 6
    assert np.array_equal(got, want)
    assert np.array_equal(gy.numpy().view(np.uint16), y)
    assert np.array_equal(guv.numpy().view(np.uint16), uv)


@pytest.mark.parametrize("noise,mode", [(False, "seg"), (True, "dense")])
def test_upload_p010_batch_as_jax(noise, mode):
    y, uv = p010_content(2, 128, 512, seed=5, noise=noise)
    jstats, stats = {}, {}
    jy, juv, jbytes = sharding.upload_p010_batch(y, uv, jstats)
    gy, guv, nbytes = link.upload_p010_batch(y, uv, stats, device="cpu")
    assert stats["h2d_pack"] == jstats["h2d_pack"] == mode
    assert nbytes == jbytes == stats["h2d_bytes"] == jstats["h2d_bytes"]
    assert np.array_equal(gy.numpy().view(np.uint16), np.asarray(jy))
    assert np.array_equal(guv.numpy().view(np.uint16), np.asarray(juv))
    assert np.array_equal(gy.numpy().view(np.uint16), y)


def test_plain_b0_is_the_dense_inverse():
    y, uv = p010_content(2, 64, 96, seed=6, noise=True)
    parts = [torch.from_numpy(a) for a in (*link.pack_p010_host(y),
                                           *link.pack_p010_host(uv))]
    gy, guv = packio.unpack_p010_dense(*parts)
    assert np.array_equal(gy.numpy().view(np.uint16), y)
    assert np.array_equal(guv.numpy().view(np.uint16), uv)


# ---------------------------------------------------------------------------
# Readback: B15, B16.
# ---------------------------------------------------------------------------

COMP_SHAPES = [(2, 64, 256), (2, 48, 300), (1, 64, 1024)]


@pytest.mark.parametrize("shape", COMP_SHAPES)
@pytest.mark.parametrize("schemes", [(False,), (True,), (False, True)])
def test_plain_b15_equals_jax(shape, schemes):
    n, h, w = shape
    comp = composite(n, h, w, seed=7, noisy_rows=5)
    zss, maps = packio.rice_stats(torch.from_numpy(comp), schemes)
    if len(schemes) == 2:
        want = jpackio._pass1_both_fn((n, h, w), 8)(comp)
    else:
        want = jpackio._pass1_widths_fn((n, h, w), 8, schemes[0])(comp)
    for z, wz in zip(zss, want[:-1]):
        assert np.array_equal(z.numpy().view(np.uint16), np.asarray(wz))
    assert np.array_equal(maps.numpy(), np.asarray(want[-1]))


def _plan(kuw, pads=None):
    """The host plan of a map, with the pack-would-not-pay rule off."""
    plan = packio._rice_host_plan(kuw[0], kuw[1], 10**12)
    if pads is not None:
        plan = plan[:2] + pads + plan[4:]
    return plan


@pytest.mark.parametrize("shape", COMP_SHAPES)
@pytest.mark.parametrize("med", [False, True])
def test_plain_b16_equals_jax_devpack(shape, med):
    n, h, w = shape
    comp = composite(n, h, w, seed=8, noisy_rows=9)
    (zs,), kuw = packio.rice_stats(torch.from_numpy(comp), (med,))
    _, _, rem_npads, un_npads, offs, _ = _plan(kuw.numpy())
    got = packio.rice_pack(zs, kuw, offs, rem_npads, un_npads)
    want = jpackio._rice_devpack_fn(zs.shape[0], rem_npads, un_npads)(
        zs.numpy().view(np.uint16), kuw.numpy(), offs)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("pads", ["exact", "tight", "wide"])
def test_fused_buffer_equals_jax(med, pads):
    """Padding rows included: "tight" pads (32 rows each) make the fit
    flag 0, "wide" ones leave rows past every bucket's count."""
    n, h, w = 2, 64, 256
    comp = composite(n, h, w, seed=9, noisy_rows=12)
    _, kuw = packio.rice_stats(torch.from_numpy(comp), (med,))
    _, _, rem_npads, un_npads, _, _ = _plan(kuw.numpy())
    if pads == "tight":
        rem_npads, un_npads = (32,) * 10, (32,) * 7
    elif pads == "wide":
        rem_npads = tuple(2 * p for p in rem_npads)
        un_npads = tuple(4 * p for p in un_npads)
    got = packio.rice_fused(torch.from_numpy(comp), med, rem_npads, un_npads)
    want = np.asarray(jpackio._fused_fetch_fn((n, h, w), 8, med, rem_npads,
                                              un_npads)(comp))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    bw = packio._fused_blob_words(rem_npads, un_npads)
    assert int(want[bw]) == (pads != "tight")


def edge_composite(n, h, w, content, seed=0):
    """An (n, 3*h, w) u8 composite of the content B15 and B16 branch on:
    all zero (every segment in the zero rank), full-range noise (the
    unary cap and the largest k) or `composite`'s smooth content."""
    if content == "zero":
        return np.zeros((n, 3 * h, w), np.uint8)
    if content == "noise":
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (n, 3 * h, w)).astype(np.uint8)
    return composite(n, h, w, seed=seed, noisy_rows=5)


@pytest.mark.parametrize("content", ["zero", "noise"])
def test_plain_b15_edge_content_equals_jax(content):
    """All-zero and full-range content, on a shape whose JAX pass 1 the
    tests above already compile."""
    n, h, w = 2, 48, 300
    comp = edge_composite(n, h, w, content, seed=11)
    zss, maps = packio.rice_stats(torch.from_numpy(comp), (False, True))
    want = jpackio._pass1_both_fn((n, h, w), 8)(comp)
    for z, wz in zip(zss, want[:-1]):
        assert np.array_equal(z.numpy().view(np.uint16), np.asarray(wz))
    assert np.array_equal(maps.numpy(), np.asarray(want[-1]))
    if content == "zero":
        assert set(maps.numpy()[[0, 2]].ravel().tolist()) == {15}
    else:  # some segment's k is held up by the unary cap
        assert int(maps.numpy()[[1, 3]].max()) == packio._RICE_UCAP


def test_plain_b15_b16_narrow_rows_equal_jax():
    """w < 256: each row is one partial segment whose columns past w
    repeat column w - 1; pass 1 and the fused buffer as JAX's."""
    n, h, w = 1, 24, 100
    comp = edge_composite(n, h, w, "smooth", seed=12)
    zss, maps = packio.rice_stats(torch.from_numpy(comp), (False, True))
    want = jpackio._pass1_both_fn((n, h, w), 8)(comp)
    for z, wz in zip(zss, want[:-1]):
        assert np.array_equal(z.numpy().view(np.uint16), np.asarray(wz))
    assert np.array_equal(maps.numpy(), np.asarray(want[-1]))
    got = packio.rice_fused(torch.from_numpy(comp), True, (32,) * 10,
                            (32,) * 7)
    want = np.asarray(jpackio._fused_fetch_fn((n, h, w), 8, True, (32,) * 10,
                                              (32,) * 7)(comp))
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("content", ["zero", "noise"])
def test_b16_edge_content_equals_jax(content, med):
    """The two-phase blob and the fused buffer of all-zero and
    full-range content, on the static paddings the tests above compile
    (the seed-8 plan of the first shape, and the tight 32 rows), so no
    new JAX compile: zero content fits (an empty remainder family), noise
    does not."""
    n, h, w = COMP_SHAPES[0]
    base = composite(n, h, w, seed=8, noisy_rows=9)
    _, base_kuw = packio.rice_stats(torch.from_numpy(base), (med,))
    _, _, rem_npads, un_npads, _, _ = _plan(base_kuw.numpy())
    comp = edge_composite(n, h, w, content, seed=13)
    (zs,), kuw = packio.rice_stats(torch.from_numpy(comp), (med,))
    offs = _plan(kuw.numpy())[4]
    got = packio.rice_pack(zs, kuw, offs, rem_npads, un_npads)
    want = jpackio._rice_devpack_fn(zs.shape[0], rem_npads, un_npads)(
        zs.numpy().view(np.uint16), kuw.numpy(), offs)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    tight = (32,) * 10, (32,) * 7
    got = packio.rice_fused(torch.from_numpy(comp), med, *tight)
    want = np.asarray(jpackio._fused_fetch_fn((n, h, w), 8, med,
                                              *tight)(comp))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert int(want[packio._fused_blob_words(*tight)]) == (content == "zero")


# ---------------------------------------------------------------------------
# Readback: the fetch and the host unpack.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["med", "vert"])
def test_fetch_planes_round_trip_with_jax_bytes(scheme):
    """Two-phase then fused: the composite exactly, with JAX's d2h bytes
    and stage modes at each call."""
    comp = composite(2, 64, 1024, seed=10, amp=2)
    fetch = getattr(packio, f"fetch_planes_u8_{scheme}")
    jfetch = getattr(jpackio, f"fetch_planes_u8_{scheme}")
    for call in range(2):
        out, nbytes = fetch(torch.from_numpy(comp))
        jout, jbytes = jfetch(comp)
        assert np.array_equal(out, comp) and np.array_equal(jout, comp)
        assert nbytes == jbytes
        assert packio.LAST_PICK == jpackio.LAST_PICK == scheme
        assert (packio.LAST_FETCH_STAGES.get("mode")
                == jpackio.LAST_FETCH_STAGES.get("mode")
                == (None if call == 0 else "fused"))


def test_auto_pick_explores_both_schemes_as_jax():
    comp = composite(2, 64, 1024, seed=11, amp=2)
    for _ in range(2):
        out, nbytes = packio.fetch_planes_u8(torch.from_numpy(comp))
        jout, jbytes = jpackio.fetch_planes_u8(comp)
        assert np.array_equal(out, comp)
        assert (nbytes, packio.LAST_PICK) == (jbytes, jpackio.LAST_PICK)


def test_replan_on_content_shift():
    """A smooth batch seeds the fused plan; a noisier one outgrows it:
    the fused fetch re-plans (counted) and still returns the composite,
    with JAX's bytes."""
    smooth = composite(2, 64, 1024, seed=12, amp=2)
    rough = composite(2, 64, 1024, seed=12, amp=2, noisy_rows=40)
    for comp in (smooth, rough):
        out, nbytes = packio.fetch_planes_u8_vert(torch.from_numpy(comp))
        _, jbytes = jpackio.fetch_planes_u8_vert(comp)
        assert np.array_equal(out, comp) and nbytes == jbytes
    assert packio.LAST_FETCH_STAGES.get("replan") == 1
    assert counters.snapshot().get("fused_fetch_replan", 0) >= 1


def test_incompressible_returns_none_as_jax():
    comp = np.random.default_rng(13).integers(0, 256, (2, 96, 256),
                                              dtype=np.uint8)
    got = packio.fetch_planes_u8(torch.from_numpy(comp))
    want = jpackio.fetch_planes_u8(comp)
    assert got[0] is None and want[0] is None and got[1] == want[1]


def _packed(med, seed=14):
    n, h, w = 2, 32, 300
    comp = composite(n, h, w, seed=seed, noisy_rows=3)
    (zs,), kuw = packio.rice_stats(torch.from_numpy(comp), (med,))
    plan = _plan(kuw.numpy())
    blob = packio.rice_pack(zs, kuw, plan[4], plan[2], plan[3])
    return comp, blob.numpy().view(np.uint32), kuw.numpy(), plan, (n, h, w)


@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_native_unpack_equals_numpy(med, threads, monkeypatch):
    monkeypatch.setenv("UHDR_UNPACK_THREADS", threads)
    comp, blob, kuw, plan, (n, h, w) = _packed(med)
    native = packio._host_unpack_rice(blob, kuw[0], kuw[1], plan[2],
                                      plan[3], n, h, w, med)
    ref = packio._host_unpack_rice_numpy(blob, kuw[0], kuw[1], plan[0],
                                         plan[1], plan[2], plan[3], n, h, w,
                                         med)
    assert np.array_equal(native, comp) and np.array_equal(ref, comp)


@pytest.mark.parametrize("fault", ["k_above_cap", "unary_above_cap",
                                   "short_bitmap"])
def test_native_unpack_rejects_corrupt_maps(fault):
    comp, blob, kuw, plan, (n, h, w) = _packed(False)
    kmap, uwmap, blob = kuw[0].copy(), kuw[1].copy(), blob.copy()
    seg = int(np.flatnonzero(kmap != 15)[0])
    if fault == "k_above_cap":
        kmap[seg] = 12
    elif fault == "unary_above_cap":
        uwmap[seg] = 30
    else:
        _, un_offs = packio._rice_word_offs(plan[2], plan[3])
        blob[un_offs[0]:] = 0
    with pytest.raises(ValueError):
        packio._host_unpack_rice(blob, kmap, uwmap, plan[2], plan[3], n, h,
                                 w, False)


def test_concurrent_fetches_report_their_own_stages(monkeypatch):
    """Two threads fetch composites of two sizes through
    link.fetch_planes, as the serving loop's two fetch threads do. A's
    unpack waits until B has finished, so A starts first and finishes
    last: each call's fetch_stages and pick are its own (A's unpack
    covers its wait, B's does not), and both shapes keep their cached
    plans."""
    import threading
    import time

    comp_a = composite(2, 64, 1024, seed=15, amp=2)
    comp_b = composite(1, 64, 1024, seed=16, amp=2)
    a_waiting, release = threading.Event(), threading.Event()
    real_unpack = packio._host_unpack_rice

    def unpack(blob, kmap, uwmap, rem_npads, un_npads, n, h, w, med,
               bits=8):
        if (n, h, w) == (2, 64, 1024):
            a_waiting.set()
            assert release.wait(30)
        return real_unpack(blob, kmap, uwmap, rem_npads, un_npads, n, h, w,
                           med, bits)

    packio.native.get_packio()    # built before either unpack is timed
    monkeypatch.setattr(packio, "_host_unpack_rice", unpack)
    stats_a, stats_b, got = {}, {}, {}

    def fetch(name, comp, stats):
        got[name] = link.fetch_planes(torch.from_numpy(comp), stats)

    thread_a = threading.Thread(target=fetch, args=("a", comp_a, stats_a))
    thread_a.start()
    assert a_waiting.wait(30)
    fetch("b", comp_b, stats_b)
    wait_ms = 300
    time.sleep(wait_ms / 1e3)
    release.set()
    thread_a.join(30)
    assert np.array_equal(got["a"], comp_a)
    assert np.array_equal(got["b"], comp_b)
    sa, sb = stats_a["fetch_stages"], stats_b["fetch_stages"]
    assert sa["unpack"] >= wait_ms and sb["unpack"] < wait_ms
    assert sa["total"] >= sa["unpack"]
    assert stats_a["d2h_pack"] == f"planes-rice-auto({sa['scheme']})"
    assert stats_b["d2h_pack"] == f"planes-rice-auto({sb['scheme']})"
    assert set(packio._PLAN_CACHE) == {((2, 64, 1024), 8),
                                       ((1, 64, 1024), 8)}


def test_fused_fetch_use_count_under_thread_stress():
    """More fetching threads than cores, with a short switch interval:
    the plan cache's use counter (a read-modify-write under the driver's
    lock) counts every fused fetch, and each fetch returns its own
    composite."""
    import os
    import sys
    import threading

    comp = composite(2, 64, 1024, seed=10, amp=2)
    out, _ = packio.fetch_planes_u8_vert(torch.from_numpy(comp))
    assert np.array_equal(out, comp)
    n_threads, per_thread = (os.cpu_count() or 4) + 2, 2
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                got, _ = packio.fetch_planes_u8_vert(torch.from_numpy(comp))
                assert np.array_equal(got, comp)
                assert packio.last_fetch()[0].get("mode") == "fused"
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert packio._PLAN_CACHE[((2, 64, 1024), 8)]["uses"] == (
        n_threads * per_thread)


# ---------------------------------------------------------------------------
# B21's widths pass (plane_widths) at its edges: rows that are not 16-byte
# aligned with a partial last segment, less than one segment, a partial
# last group, an all-zero plane and full-range 10-bit noise.
# ---------------------------------------------------------------------------

B21_EDGES = {"w 1001": (64, 1001, "smooth"), "w 200": (32, 200, "smooth"),
             "h 37": (37, 512, "smooth"), "all zero": (64, 512, "zero"),
             "noise": (64, 768, "noise")}


def b21_edge_plane(h, w, kind, seed):
    """An (h, w) uint16 plane of 10-bit codes: 16-row bands with small
    noise, all zero, or full-range noise."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((h, w), np.uint16)
    if kind == "noise":
        return rng.integers(0, 1024, (h, w)).astype(np.uint16)
    base = np.kron(rng.integers(0, 1024, (h // 16 + 1, w // 64 + 1)),
                   np.ones((16, 64), np.int64))[:h, :w]
    # Noise below 1, 2 or 6 by 256-column segment: rows of width codes
    # 0, 2 and 5 beside the 10-bit rows where a band or a group starts.
    amp = np.array([1, 2, 6])[np.arange(w) // 256 % 3]
    noise = (rng.random((h, w)) * amp).astype(np.int64)
    return ((base + noise) % 1024).astype(np.uint16)


@pytest.mark.parametrize("case", list(B21_EDGES))
def test_plain_b21a_edges_equal_jax(case):
    h, w, kind = B21_EDGES[case]
    a = b21_edge_plane(h, w, kind, seed=21)
    zs, bc = packio.plane_widths(torch.from_numpy(a.view(np.int16)))
    jzs, jbc = jpackio._widths_fn((h, w))(jnp.asarray(a))
    assert np.array_equal(zs.numpy().view(np.uint16), np.asarray(jzs))
    assert np.array_equal(bc.numpy(), np.asarray(jbc))
    codes = set(np.unique(bc.numpy()).tolist())
    if kind == "zero":
        assert codes == {0}
    if kind == "noise":
        assert codes == {10}
