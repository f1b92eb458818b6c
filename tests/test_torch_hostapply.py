"""The host-apply decode of the port (libultrahdr_dev_tpu_torch/
parallel/link.py, ops/apply.cpp, the planes composite B18 in
ops/gainmap.py) against the JAX package's (parallel/sharding.py
apply_planes_host / decode_batch_hostapply, jpeg/native/apply.cpp,
ops/gainmap.py planes_composite), on the CPU: B18's plain version and
the native apply bitwise equal to JAX's, with the apply's thread count
pinned to 1 and to 4; the whole decode from blobs and from a handoff
bitwise equal to JAX's; and within 1 ten-bit code / 1 F16 ULP of the
port's own device-apply decode (B6)."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.ops import gainmap as jgm
from libultrahdr_dev_tpu.parallel import packio as jpackio, sharding
from libultrahdr_dev_tpu_torch.ops import gainmap as gm
from libultrahdr_dev_tpu_torch.parallel import batched, link, packio

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 128, 256
BOOST = 1000 / 203
SCALARS = (0.0, 2.3045, 1.0, 4.9396)  # log2 min, log2 max, boost, display


def synth_planes(n, h, w, seed=0):
    """Block-smooth decode intermediates: (y, u, v, gain map) uint8."""
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2

    def plane(hh, ww):
        base = rng.integers(0, 256, (n, hh // 8 + 1, ww // 8 + 1))
        big = np.kron(base, np.ones((1, 8, 8), np.int64))[:, :hh, :ww]
        return np.clip(big + rng.integers(0, 5, (n, hh, ww)), 0,
                       255).astype(np.uint8)

    return plane(h, w), plane(ch, cw), plane(ch, cw), plane(h // 4, w // 4)


def synth_p010(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (n, h // 16 + 1, w // 16 + 1))
    y = np.kron(small, np.ones((1, 16, 16)))[:, :h, :w]
    uv = np.kron(rng.integers(400, 620, (n, h // 16 + 1, w // 16 + 1)),
                 np.ones((1, 8, 16)))[:, :h // 2, :w]
    return (np.clip(y, 64, 940).astype(np.uint16) << 6,
            uv.astype(np.uint16) << 6)


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    for mod in (packio, jpackio):
        monkeypatch.setattr(mod, "_PLAN_CACHE", {})
        monkeypatch.setattr(mod, "_BPS", {})
    monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
    monkeypatch.delenv("UHDR_FUSED_FETCH", raising=False)


@pytest.mark.parametrize("h,w", [(64, 96), (50, 70), (37, 130), (72, 40)])
def test_plain_b18_equals_jax(h, w):
    y, u, v, g = synth_planes(2, h, w, seed=h)
    got = gm.planes_composite(*(torch.from_numpy(a) for a in (y, u, v, g)))
    for i in range(2):
        want = np.asarray(jgm.planes_composite(y[i], u[i], v[i], g[i]))
        assert np.array_equal(got[i].numpy(), want)


def _composite(h, w, seed):
    planes = synth_planes(2, h, w, seed)
    comp = gm.planes_composite(*(torch.from_numpy(a) for a in planes))
    return comp.numpy(), planes


@pytest.mark.parametrize("fmt", ["hdr_linear", "hdr_hlg", "hdr_pq"])
@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("h,w", [(64, 96), (144, 320)])
def test_apply_planes_host_equals_jax(fmt, threads, h, w, monkeypatch):
    monkeypatch.setenv("UHDR_UNPACK_THREADS", threads)
    assert packio._unpack_threads() == jpackio._unpack_threads() == \
        int(threads)
    comp, _ = _composite(h, w, seed=3)
    sc = np.asarray([SCALARS, (0.0, 3.1, 0.8, 6.0)], np.float32)
    got = link.apply_planes_host(comp, sc, h, w, h // 4, w // 4, fmt)
    want = sharding.apply_planes_host(comp, sc, h, w, h // 4, w // 4, fmt)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("short", ["rows", "width", "scalars", "dtype"])
def test_short_composite_raises(short):
    comp, _ = _composite(H, W, seed=4)
    sc = np.asarray([SCALARS] * 2, np.float32)
    if short == "rows":
        comp = comp[:, :H + H // 2]
    elif short == "width":
        comp = np.ascontiguousarray(comp[:, :, :W - 8])
    elif short == "scalars":
        sc = sc[:1]
    else:
        comp = comp.astype(np.uint16)
    with pytest.raises(ValueError):
        link.apply_planes_host(comp, sc, H, W, H // 4, W // 4, "hdr_hlg")


_ENCODED = {}


def encoded():
    """(P010 frames, JAX blobs, JAX handoff, port blobs, port handoff),
    once per process."""
    if not _ENCODED:
        ys, uvs = synth_p010(2, H, W, seed=5)
        jblobs, jhand = sharding.batched_encode_api0(
            ys, uvs, sharding.single_device_mesh(), return_handoff=True)
        blobs, hand = batched.batched_encode_api0(ys, uvs, device="cpu",
                                                  return_handoff=True)
        _ENCODED.update(frames=(ys, uvs), jax=(jblobs, jhand),
                        port=(blobs, hand))
    return _ENCODED


@pytest.mark.parametrize("fmt", ["hdr_hlg", "hdr_linear", "hdr_pq"])
@pytest.mark.parametrize("source", ["blobs", "handoff"])
def test_decode_batch_hostapply_equals_jax(fmt, source):
    e = encoded()
    jblobs, jhand = e["jax"]
    blobs, hand = e["port"]
    assert blobs == jblobs
    stats, jstats = {}, {}
    if source == "blobs":
        got = link.decode_batch_hostapply(blobs, fmt, BOOST, stats,
                                          device="cpu")
        want = sharding.decode_batch_hostapply(
            jblobs, fmt, BOOST, sharding.single_device_mesh(), jstats)
    else:
        got = link.decode_batch_hostapply(None, fmt, BOOST, stats,
                                          handoff=hand)
        want = sharding.decode_batch_hostapply(
            None, fmt, BOOST, sharding.single_device_mesh(), jstats,
            handoff=jhand)
    assert np.array_equal(got, want)
    assert stats["d2h_pack"] == jstats["d2h_pack"]
    assert stats["d2h_pack"].startswith("planes-rice-auto(")
    assert stats["d2h_bytes"] == jstats["d2h_bytes"]


def test_hostapply_declines_what_jax_declines():
    e = encoded()
    assert link.decode_batch_hostapply(e["port"][0], "sdr", BOOST,
                                       device="cpu") is None
    assert not link.hostapply_available("hdr_linear_rgb_10bit")


@pytest.mark.parametrize("fmt", ["hdr_hlg", "hdr_linear", "hdr_pq"])
def test_hostapply_within_one_code_of_device_apply(fmt):
    blobs = encoded()["port"][0]
    host = link.decode_batch_hostapply(blobs, fmt, BOOST, device="cpu")
    dev = batched.batched_decode(blobs, fmt, BOOST, device="cpu").numpy()
    if fmt == "hdr_linear":
        d = np.abs(host[..., :3].astype(np.int32)
                   - dev.view(np.uint16)[..., :3].astype(np.int32))
    else:
        dev = dev.view(np.uint32)
        d = np.stack([np.abs(((host >> s) & 1023).astype(np.int32)
                             - ((dev >> s) & 1023).astype(np.int32))
                      for s in (0, 10, 20)])
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.99


def test_planes_output_is_the_composite_of_the_decoded_planes():
    """The "planes" decode = B18 over the decode's own planes, from blobs
    and from the handoff alike, and JAX's planes decode."""
    e = encoded()
    blobs, hand = e["port"]
    frames = batched.decode_host_stage(blobs, "planes")
    meta = {}
    comp = batched.decode_device_stage(frames, "planes", BOOST,
                                       torch.device("cpu"), meta_out=meta)
    assert torch.equal(comp, batched.batched_decode_from_handoff(
        hand, "planes", BOOST))
    assert (meta["w"], meta["h"], meta["gw"], meta["gh"]) == (W, H, W // 4,
                                                              H // 4)
    jmeta = {}
    jcomp = sharding._batched_decode_device(
        e["jax"][0], "planes", BOOST, sharding.single_device_mesh(), False,
        meta_out=jmeta)
    assert np.array_equal(comp.numpy(), np.asarray(jcomp))
    assert np.array_equal(meta["scalars"], jmeta["scalars"])
