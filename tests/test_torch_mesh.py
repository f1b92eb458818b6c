"""The port's device mesh (libultrahdr_dev_tpu_torch/parallel/mesh.py and
the mesh= arm of every batched entry point), the mirror of
tests/test_parallel.py: a batch of 8 frames of 64x96 on CPU meshes of 1,
2 and 8 entries against the JAX package's batched entry points on the
8-device virtual CPU mesh of tests/conftest.py (sharding.default_mesh()).

Bars: JPEG/R bytes identical to JAX's (API-0, API-1, and a batch whose
frame 5 is dense, which JAX writes restart-less in every frame); decoded
pixels within 1 ten-bit code / 1 F16 ULP / 1 SDR code of JAX's with
>= 99.9% of channel samples exact, the host-apply decode bitwise JAX's
(as tests/test_torch_hostapply.py holds it); and every mesh's output
bitwise the one-device call's. Also: the serving loop on a 2-entry mesh
is the loop on one, an uneven batch raises, and default_mesh() names
every visible GPU with its index."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.parallel import packio as jpackio, sharding
from libultrahdr_dev_tpu.types import (GainMapMetadata as JMetadata,
                                       OutputFormat as JOutputFormat)
from libultrahdr_dev_tpu_torch import device as tdevice, serving
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.parallel import batched, link, packio
from libultrahdr_dev_tpu_torch.parallel.mesh import (DeviceMesh,
                                                     ShardedBatch,
                                                     default_mesh,
                                                     single_device_mesh)

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

N, H, W = 8, 64, 96
BOOST = 1000 / 203
DENSE = 5          # the dense frame of the dense batch
MESHES = [1, 2, 8]
SDR_FRAMES = [0, 5]  # the frames of the batch held to JAX's SDR decode


def synth_p010(n, h, w, seed=0):
    """bench.py's band-limited HDR content, a frame per seed."""
    ys, uvs = [], []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
            np.float32)
        y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
        y = (y + np.roll(y, 7, 0) + np.roll(y, 7, 1)) / 3.0
        c = rng.integers(448, 576, (h // 16 + 1, w // 32 + 1))
        c = np.kron(c, np.ones((8, 32)))[:h // 2, :w]
        ys.append(np.clip(y, 64, 940).astype(np.uint16) << 6)
        uvs.append(np.clip(c, 64, 960).astype(np.uint16) << 6)
    return np.stack(ys), np.stack(uvs)


def synth_sdr(n, h, w, seed=40):
    """A smooth uint8 YUV420 rendition (any content: both sides code the
    same planes)."""
    rng = np.random.default_rng(seed)

    def plane(hh, ww):
        base = np.kron(rng.integers(16, 236, (n, hh // 8 + 1, ww // 8 + 1)),
                       np.ones((1, 8, 8)))[:, :hh, :ww]
        return np.clip(base + rng.integers(-4, 5, (n, hh, ww)), 0,
                       255).astype(np.uint8)

    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


def dense_batch():
    """The content batch with frame DENSE replaced by uniform noise: at
    quality 100 its blocks pass the JAX encoder's 608-bit buffer."""
    y, uv = synth_p010(N, H, W)
    rng = np.random.default_rng(3)
    y[DENSE] = (rng.integers(0, 1024, (H, W)) << 6).astype(np.uint16)
    uv[DENSE] = (rng.integers(0, 1024, (H // 2, W)) << 6).astype(np.uint16)
    return y, uv


def apply_planes(seed=7):
    rng = np.random.default_rng(seed)

    def smooth(h, w):
        base = np.kron(rng.integers(16, 240, (N, h // 8, w // 8)),
                       np.ones((1, 8, 8)))
        return np.clip(base + rng.integers(-6, 7, (N, h, w)), 0,
                       255).astype(np.uint8)

    return (smooth(H, W), smooth(H // 2, W // 2), smooth(H // 2, W // 2),
            rng.integers(0, 256, (N, H // 4, W // 4)).astype(np.uint8))


META = JMetadata(max_content_boost=BOOST, min_content_boost=1.0,
                 hdr_capacity_min=1.0, hdr_capacity_max=BOOST)

_JAX: dict = {}


def jax_side() -> dict:
    """Every JAX output the tests hold the port to, computed once on the
    8-device mesh."""
    if _JAX:
        return _JAX
    mesh = sharding.default_mesh()
    assert mesh.devices.size == N
    y, uv = synth_p010(N, H, W)
    blobs = sharding.batched_encode_api0(y, uv, mesh)
    sdr = synth_sdr(N, H, W)
    dy, duv = dense_batch()
    out = {"y": y, "uv": uv, "sdr": sdr, "blobs": blobs,
           "api1": sharding.batched_encode_api1(
               y, uv, *sdr, mesh, sdr_gamut="bt709", hdr_gamut="bt2100",
               hdr_tf="hlg", quality=95),
           "dense": sharding.batched_encode_api0(dy, duv, mesh, quality=100,
                                                 return_handoff=True),
           "dense_in": (dy, duv),
           # JAX's batched decode has no SDR output: its JpegR decode of
           # one frame of each half of the batch.
           "sdr_out": np.stack([
               np.asarray(jjpegr.JpegR().decode(blobs[i], JOutputFormat.SDR)
                          .image.planes["rgba"]) for i in SDR_FRAMES]),
           "hostapply": sharding.decode_batch_hostapply(
               blobs, "hdr_hlg", BOOST, mesh)}
    for fmt in ("hdr_hlg", "hdr_linear"):
        # JAX's handoff decode is bitwise its blob decode
        # (tests/test_parallel.py::test_handoff_decode_bitwise_equal).
        out[fmt] = np.asarray(sharding.batched_decode(blobs, fmt, BOOST,
                                                      mesh))
        out["apply", fmt] = np.asarray(sharding.batched_apply_gainmap(
            *apply_planes(), META, fmt, 4.0, mesh))
    _JAX.update(out)
    return _JAX


def cpu_mesh(k: int) -> DeviceMesh:
    return default_mesh(["cpu"] * k)


_PORT: dict = {}


def port_api0(k: int):
    """The port's API-0 encode of the batch on a k-entry CPU mesh, with
    its handoff: (blobs, a DeviceEncodedBatch a shard)."""
    if k not in _PORT:
        j = jax_side()
        _PORT[k] = batched.batched_encode_api0(j["y"], j["uv"], device="cpu",
                                               return_handoff=True,
                                               mesh=cpu_mesh(k))
    return _PORT[k]


def diff(got, want, fmt) -> np.ndarray:
    """Per-channel |difference| of HLG 1010102 words, F16 halves or
    RGBA8888 words (alpha left out)."""
    got, want = np.asarray(got), np.asarray(want)
    if fmt == "hdr_linear":
        return np.abs(got.view(np.uint16)[..., :3].astype(np.int64)
                      - want.view(np.uint16)[..., :3])
    g = got.view(np.uint32).astype(np.int64)
    w = want.view(np.uint32).astype(np.int64)
    bits, shifts = (1023, (0, 10, 20)) if fmt != "sdr" else (255, (0, 8, 16))
    return np.stack([np.abs(((g >> s) & bits) - ((w >> s) & bits))
                     for s in shifts])


def within_bar(got, want, fmt):
    d = diff(got, want, fmt)
    assert d.shape[-1] and int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999


def n_rst(blob: bytes) -> int:
    return sum(blob.count(bytes([0xFF, 0xD0 + k])) for k in range(8))


def on_mesh(batch, k: int) -> torch.Tensor:
    """A ShardedBatch laid over a k-entry CPU mesh, as one tensor."""
    assert isinstance(batch, ShardedBatch) and len(batch.shards) == k
    assert all(s.device.type == "cpu" for s in batch.shards)
    assert {s.shape[0] for s in batch.shards} == {N // k}
    return batch.cpu()


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    for mod in (packio, jpackio):
        monkeypatch.setattr(mod, "_PLAN_CACHE", {})
        monkeypatch.setattr(mod, "_BPS", {})
    monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
    monkeypatch.delenv("UHDR_FUSED_FETCH", raising=False)


@pytest.mark.parametrize("k", MESHES)
def test_api0_bytes_as_jax(k):
    j = jax_side()
    blobs, hands = port_api0(k)
    assert blobs == j["blobs"]
    assert len(hands) == k and all(h.base_bits.shape[0] == N // k
                                   for h in hands)
    assert all(n_rst(b) > 0 for b in blobs)


@pytest.mark.parametrize("k", MESHES)
def test_api1_bytes_as_jax(k):
    j = jax_side()
    got = batched.batched_encode_api1(j["y"], j["uv"], *j["sdr"],
                                      sdr_gamut="bt709", hdr_gamut="bt2100",
                                      hdr_tf="hlg", quality=95,
                                      mesh=cpu_mesh(k))
    assert got == j["api1"]


@pytest.mark.parametrize("k", MESHES)
def test_dense_frame_writes_every_shard_restartless(k):
    """One dense frame (frame 5) makes every frame of every shard
    restart-less, as JAX's one program writes the whole batch, and the
    handoff is None."""
    j = jax_side()
    want, want_hand = j["dense"]
    assert want_hand is None and all(n_rst(b) == 0 for b in want)
    blobs, hand = batched.batched_encode_api0(*j["dense_in"], quality=100,
                                              return_handoff=True,
                                              mesh=cpu_mesh(k))
    assert blobs == want and hand is None
    # API-1 codes the SDR rendition as its base: a dense SDR frame 5
    # raises for the whole batch, as JAX's does (sharding.py:688-694).
    sdr = [p.copy() for p in j["sdr"]]
    rng = np.random.default_rng(4)
    for p in sdr:
        p[DENSE] = rng.integers(0, 256, p.shape[1:])
    with pytest.raises(OverflowError):
        batched.batched_encode_api1(*j["dense_in"], *sdr, quality=100,
                                    mesh=cpu_mesh(k))


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("fmt", ["hdr_hlg", "hdr_linear", "sdr"])
def test_decode_as_jax(k, fmt):
    j = jax_side()
    mesh = cpu_mesh(k)
    got = on_mesh(batched.batched_decode(j["blobs"], fmt, BOOST,
                                         mesh=mesh), k)
    one = batched.batched_decode(j["blobs"], fmt, BOOST, device="cpu")
    assert torch.equal(got, one)
    if fmt == "sdr":
        within_bar(got.numpy()[SDR_FRAMES], j["sdr_out"], fmt)
    else:
        within_bar(got.numpy(), j[fmt], fmt)


@pytest.mark.parametrize("k", MESHES)
def test_handoff_decode_as_jax(k):
    j = jax_side()
    mesh = cpu_mesh(k)
    _, hands = port_api0(k)
    for fmt in ("hdr_hlg", "hdr_linear"):
        got = on_mesh(batched.batched_decode_from_handoff(
            hands, fmt, BOOST, mesh=mesh), k)
        blob = on_mesh(batched.batched_decode(j["blobs"], fmt, BOOST,
                                              mesh=mesh), k)
        assert torch.equal(got, blob)
        within_bar(got.numpy(), j[fmt], fmt)


@pytest.mark.parametrize("k", MESHES)
def test_batched_apply_as_jax(k):
    j = jax_side()
    p = apply_planes()
    for fmt in ("hdr_hlg", "hdr_linear"):
        got = on_mesh(batched.batched_apply_gainmap(
            *p, metadata_from_jax(META), fmt, 4.0, mesh=cpu_mesh(k)), k)
        one = batched.batched_apply_gainmap(*p, metadata_from_jax(META), fmt,
                                            4.0, device="cpu")
        assert torch.equal(got, one)
        within_bar(got.numpy(), j["apply", fmt], fmt)


@pytest.mark.parametrize("k", MESHES)
def test_hostapply_decode_as_jax(k, monkeypatch):
    monkeypatch.setenv("UHDR_UNPACK_THREADS", "1")
    j = jax_side()
    want = j["hostapply"]
    mesh = cpu_mesh(k)
    stats = {}
    got = link.decode_batch_hostapply(j["blobs"], "hdr_hlg", BOOST, stats,
                                      mesh=mesh)
    assert np.array_equal(got, want)
    assert stats["d2h_bytes"] > 0
    _, hands = port_api0(k)
    assert np.array_equal(link.decode_batch_hostapply(
        None, "hdr_hlg", BOOST, handoff=hands, mesh=mesh), want)


def test_device_stage_and_fetches_per_shard():
    """batched_encode_device_stage and the packed readbacks on a 2-entry
    mesh: each shard's coefficients and each fetched batch are the
    one-device call's."""
    j = jax_side()
    mesh = cpu_mesh(2)
    coefs, md = batched.batched_encode_device_stage(j["y"], j["uv"],
                                                    mesh=mesh)
    one, md1 = batched.batched_encode_device_stage(j["y"], j["uv"],
                                                   device="cpu")
    assert md == md1
    assert all(torch.equal(on_mesh(c, 2), o) for c, o in zip(coefs, one))
    hlg = batched.batched_decode(j["blobs"], "hdr_hlg", BOOST, mesh=mesh)
    f16 = batched.batched_decode(j["blobs"], "hdr_linear", BOOST, mesh=mesh)
    stats = {}
    got = link.fetch_1010102_packed(hlg, stats)
    assert np.array_equal(got, link.fetch_1010102_packed(hlg.cpu()))
    assert len(stats["d2h_stages"]) == 2
    assert np.array_equal(link.fetch_f16_packed(f16),
                          link.fetch_f16_packed(f16.cpu()))
    assert np.array_equal(link.fetch_pixels_packed(hlg, None, "rgba1010102"),
                          got)


def test_serving_loop_on_two_entries_is_the_loop_on_one():
    a = serving.run(N, H, W, 2, device="cpu", log=lambda m: None)
    b = serving.run(N, H, W, 2, log=lambda m: None, mesh=cpu_mesh(2))
    assert b.blobs == a.blobs
    assert np.array_equal(b.comp, a.comp)
    assert np.array_equal(b.pixels, a.pixels)
    assert isinstance(b.comp_dev, ShardedBatch)
    assert [st["h2d_pack"] for st in b.stats] == [st["h2d_pack"]
                                                  for st in a.stats]


def test_uneven_batch_raises():
    j = jax_side()
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shards(6)
    with pytest.raises(ValueError, match="does not divide"):
        batched.batched_encode_api0(j["y"][:6], j["uv"][:6], mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        batched.batched_decode(j["blobs"][:6], "hdr_hlg", mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        serving.run(6, H, W, 1, log=lambda m: None, mesh=mesh)


def test_default_mesh_names_every_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    mesh = default_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert all(d.index is not None for d in mesh.devices)
    assert single_device_mesh().devices == (torch.device("cuda", 2),)
    assert tdevice.resolve_device("cuda") == torch.device("cuda", 2)
    assert tdevice.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert [(s.start, s.stop) for s in mesh.shards(8)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]


def test_default_mesh_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_mesh()
    assert default_mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
