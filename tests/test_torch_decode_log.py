"""Kernel B22 of the port (libultrahdr_dev_tpu_torch/jpeg/device_decode.py,
the Huffman decode's log emission) through its plain PyTorch version,
against the JAX package's decode_rst_chunks(emit_mode="log") and the
port's dense plain version (B4) on the same streams; and the port's
device decodes under the log emission (JpegR, the handoff, decode_jpeg)
against the JAX package's under its log emission.

All comparisons are exact: coefficient grids and decoded pixels bit for
bit. The JAX side selects its log arm the way UHDR_DECODE_EMIT=log does,
through its module's _DEFAULT_EMIT, with its cached decode programs
cleared before and after; nothing in the JAX package is edited."""

import math
import os
import subprocess
import sys
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.jpeg import device_decode as jdd
from libultrahdr_dev_tpu.parallel import sharding
from libultrahdr_dev_tpu.types import OutputFormat as JOutputFormat
from libultrahdr_dev_tpu_torch import JpegR, OutputFormat
from libultrahdr_dev_tpu_torch.container import mux
from libultrahdr_dev_tpu_torch.jpeg import codec, device_decode as tdd
from libultrahdr_dev_tpu_torch.parallel import batched

import test_torch_jax_native  # noqa: F401  (loads the JAX native codec)
from test_torch_jpegr import synth_p010
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 64, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "enc0_709_hlg.jpegr")

# The JAX package's lru_cached programs that run decode_rst_chunks,
# built under whichever emission default was set when they were first
# called.
_JAX_PROGRAMS = (jjpegr._fused_decode_kernel_dev,
                 jdd._decode_to_planes_kernel,
                 sharding._handoff_decode_kernel,
                 sharding._batched_decode_kernel_dev)


@pytest.fixture
def log_emission(monkeypatch):
    """Both packages' emission default set to "log" for one test."""
    monkeypatch.setattr(tdd, "_DEFAULT_EMIT", "log")
    monkeypatch.setattr(jdd, "_DEFAULT_EMIT", "log")
    for b in _JAX_PROGRAMS:
        b.cache_clear()
    yield
    for b in _JAX_PROGRAMS:
        b.cache_clear()


@lru_cache(maxsize=None)
def _encoded():
    """A batch of two 128x64 API-0 JPEG/Rs (BT.2100 HLG, quality 95) from
    both packages (the same bytes), with both packages' handoffs."""
    ys, uvs = zip(*(synth_p010(H, W, seed=i) for i in range(2)))
    y, uv = np.stack(ys), np.stack(uvs)
    jblobs, jhand = sharding.batched_encode_api0(
        y, uv, sharding.single_device_mesh(), "bt2100", "hlg", 95,
        return_handoff=True)
    tblobs, thand = batched.batched_encode_api0(
        y, uv, "bt2100", "hlg", 95, device="cpu", return_handoff=True)
    assert list(jblobs) == list(tblobs)
    return tblobs, jhand, thand


def _yuv_jpegs():
    """208x144 JPEGs the port's encode_jpeg writes restart-less: gray,
    4:2:2 and 4:4:4 (4:2:0 is the JPEG/R base's)."""
    rng = np.random.default_rng(21)
    y = rng.integers(0, 256, (144 // 16 + 1, 208 // 16 + 1)).astype(np.uint8)
    y = np.kron(y, np.ones((16, 16), np.uint8))[:144, :208]
    y = (y // 2 + rng.integers(0, 64, y.shape)).astype(np.uint8)
    u = np.roll(y, 5, 1)[:, ::2]
    v = np.roll(y, 9, 0)[:, ::2]
    u4, v4 = (np.repeat(c, 2, 1) for c in (u, v))
    planes = {"gray": {"y": y}, "4:2:2": {"y": y, "u": u, "v": v},
              "4:4:4": {"y": y, "u": u4, "v": v4}}
    return {k: codec.encode_jpeg(p, 85, device="cpu")
            for k, p in planes.items()}


def _windows(ds):
    """(lanes, win) u8 lane windows as the JAX device path gathers them."""
    padded = np.concatenate([ds.dest, np.zeros(ds.win_len, np.uint8)])
    return padded[ds.starts_byte[:, None]
                  + np.arange(ds.win_len)[None, :]]


@lru_cache(maxsize=None)
def _jax_log_kernel(r, n_mcus, gray, tkey, carry, ypm, units):
    chains = jdd.chains_from_key(tkey) if tkey else None
    return jax.jit(lambda ch, sb: jdd.decode_rst_chunks(
        ch, r, n_mcus, gray, chains, jdd.min_code_len_from_key(tkey),
        start_bits=sb, dc_carry=carry, ypm=ypm, units_per_step=units,
        emit_mode="log"))


def _jax_log_grids(data):
    """JAX's decode_rst_chunks(emit_mode="log") of one parsed JPEG, as
    per-plane grids (the JAX de-interleave)."""
    return _jax_log_grids_of(jdd.parse_device_stream(data))


def _jax_log_grids_of(ds):
    """_jax_log_grids of a parsed JAX DeviceStream."""
    hs, vs = ds.sampling
    carry = ds.start_bits is not None
    sb = ds.start_bits if carry else np.zeros(ds.n_lanes, np.int32)
    out = np.asarray(_jax_log_kernel(
        ds.restart_interval, ds.mcus_x * ds.mcus_y, ds.gray, ds.tables_key,
        carry, hs * vs, None)(_windows(ds), sb))
    if ds.gray:
        return (out[:ds.mcus_x * ds.mcus_y],)
    return tuple(np.asarray(p) for p in jdd.deinterleave_ycbcr_device(
        out, ds.mcus_x, ds.mcus_y, hs, vs))


def _port_grids(streams, mode):
    ln = tdd.pack_streams(streams)
    return tdd.decode_rst_chunks_plain(
        *(torch.from_numpy(a) for a in (ln.src, ln.frames, ln.lanes,
                                        ln.tables)),
        ln.gray, ln.sampling, ln.mcus_x, ln.mcus_y, emit_mode=mode)


def _assert_log_as_jax_and_dense(data):
    """B22's plain version = JAX's log form = the port's B4 plain
    version, on one stream."""
    ds = tdd.parse_device_stream(data)
    assert ds is not None
    log = _port_grids([ds], "log")
    want = _jax_log_grids(data)
    assert len(log) == len(want)
    for p, w in zip(log, want):
        np.testing.assert_array_equal(p[0].numpy(), w)
    for p, d in zip(log, _port_grids([ds], "dense")):
        assert torch.equal(p, d)
    return ds


# ---------------------------------------------------------------------------
# B22, plain version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("image", [0, 1], ids=["color_base", "gray_map"])
def test_log_own_streams_as_jax_and_dense(image):
    """The port's own API-0 streams (restart intervals): the 4:2:0 base
    and the gray gain map."""
    blob = _encoded()[0][0]
    ds = _assert_log_as_jax_and_dense(
        mux.extract_primary_and_gainmap(blob)[image])
    assert ds.start_bits is None and ds.gray == bool(image)


def test_log_restartless_dc_carry_as_jax_and_dense():
    """A restart-less foreign stream (PIL, as JAX's TestEmitModes):
    host-scanned lanes starting mid-byte, DC carried across them."""
    import io

    from PIL import Image

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (144, 208, 3), np.uint8)
    img = ((img.astype(np.float32) + np.roll(img, 1, 0)
            + np.roll(img, 2, 1)) / 3).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=88)
    ds = _assert_log_as_jax_and_dense(b.getvalue())
    assert ds.start_bits is not None and np.any(ds.start_bits % 8)


@pytest.mark.parametrize("k", [0, 1], ids=["golden_base", "golden_map"])
def test_log_golden_dc_carry_as_jax_and_dense(k):
    """The reference's restart-less encode (libjpeg tables)."""
    data = mux.extract_primary_and_gainmap(open(GOLDEN, "rb").read())[k]
    assert _assert_log_as_jax_and_dense(data).start_bits is not None


def test_log_flat_dc_only_as_jax_and_dense():
    """Flat 8x8 blocks, 4:2:0 at restart interval 2: every block holds
    its DC alone, one log entry a block."""
    rng = np.random.default_rng(31)

    def flat(h, w):
        lvl = rng.integers(0, 256, (h // 8, w // 8)).astype(np.uint8)
        return np.kron(lvl, np.ones((8, 8), np.uint8))

    data = codec.encode_jpeg({"y": flat(64, 128), "u": flat(32, 64),
                              "v": flat(32, 64)}, 90, restart_interval=2,
                             device="cpu")
    ds = _assert_log_as_jax_and_dense(data)
    grids = _port_grids([ds], "log")
    assert all(not bool(g[..., 1:].any()) for g in grids)
    assert all(bool(g[..., 0].any()) for g in grids)


@pytest.mark.parametrize("image", [0, 1], ids=["color_base", "gray_map"])
def test_log_truncated_stream_as_jax_and_dense(image):
    """The port's own stream cut to 3/5 of its bytes (the windows and
    lanes as before): lanes past the cut read zeros, lanes across it
    decode into garbage and may stop short of their last blocks."""
    data = mux.extract_primary_and_gainmap(_encoded()[0][0])[image]
    ds = tdd.parse_device_stream(data)
    cut = ds.dest.size * 3 // 5
    ds.dest = ds.dest[:cut].copy()
    jds = jdd.parse_device_stream(data)
    jds.dest = jds.dest.copy()
    jds.dest[cut:] = 0
    log = _port_grids([ds], "log")
    want = _jax_log_grids_of(jds)
    assert len(log) == len(want)
    for p, w in zip(log, want):
        np.testing.assert_array_equal(p[0].numpy(), w)
    for p, d in zip(log, _port_grids([ds], "dense")):
        assert torch.equal(p, d)


def _assert_planes_as_jax(data, got, want):
    """decode_jpeg's planes against JAX's device decode of the same
    stream: equal, but where the exact IDCT of the (bitwise equal)
    grids lies within 1e-3 of a rounding tie, B5 may round the other
    way than XLA's float32 einsum by 1 (test_torch_dct.py::
    test_dequant_idct_matches_jax holds B5 to the same rule)."""
    from libultrahdr_dev_tpu_torch.jpeg import dct as tdct

    ds = tdd.parse_device_stream(data)
    shapes = tdd.plane_shapes(ds.gray, ds.sampling, ds.mcus_x, ds.mcus_y)
    for g, q, (bh, bw), p, w in zip(_port_grids([ds], "dense"), ds.qtables,
                                    shapes, got.planes, want):
        p = p.numpy().astype(np.int64)
        h, wd = p.shape
        w = np.asarray(w)[:h, :wd].astype(np.int64)
        off = p != w
        if not off.any():
            continue
        nat = (g[0].numpy()[:, tdct.INV_ZIG].astype(np.float64)
               * q.reshape(64))
        pix = tdct._D64.T @ nat.reshape(-1, 8, 8) @ tdct._D64 + 128.0
        exact = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)[:h, :wd]
        assert int(np.abs(p - w).max()) <= 1
        frac = np.abs(exact[off] - np.floor(exact[off]) - 0.5)
        assert bool((frac < 1e-3).all()), frac


@pytest.mark.parametrize("name", ["gray", "4:2:2", "4:4:4"])
def test_log_sampling_as_jax_and_dense(name, log_emission):
    """Gray, 4:2:2 and 4:4:4 streams of decode_jpeg: B22's grids as
    JAX's log form and B4's, bitwise; decode_jpeg's planes under log
    bitwise as under dense, and as JAX's device decode under log
    (decode_jpeg_device) but for B5's rounding ties."""
    data = _yuv_jpegs()[name]
    _assert_log_as_jax_and_dense(data)
    got = codec.decode_jpeg(data, "cpu")
    tdd._DEFAULT_EMIT = "dense"
    dense = codec.decode_jpeg(data, "cpu")
    tdd._DEFAULT_EMIT = "log"
    for p, d in zip(got.planes, dense.planes):
        assert torch.equal(p, d)
    _assert_planes_as_jax(data, got, jdd.decode_jpeg_device(data)[1])


@pytest.mark.parametrize("gray", [False, True], ids=["color", "gray"])
def test_log_garbage_as_jax_and_dense(gray):
    """Arbitrary bytes: lanes stop where JAX's log loop stops them (its
    bit budget, its block count; its cb*65 step cap never binds) and
    emit the same values."""
    mx, my = (8, 1) if gray else (4, 2)
    specs = tdd.ANNEX_K_GRAY if gray else tdd.ANNEX_K_COLOR
    for seed in range(4):
        rng = np.random.default_rng(11 + seed)
        ch = rng.integers(0, 256, (4, 96), np.uint8)
        sb = rng.integers(0, 8, 4).astype(np.int32)
        frames = np.asarray([tdd.frame_row(0, ch.size, 96, 2, 0, 4, False,
                                           2)], np.int32)
        lanes = np.stack([np.arange(4) * 96, sb], 1).astype(np.int32)
        args = [torch.from_numpy(a) for a in (
            ch.reshape(-1), frames, lanes, tdd.decode_tables(specs)[None])]
        log = tdd.decode_rst_chunks_plain(*args, gray, (2, 2), mx, my,
                                          emit_mode="log")
        dense = tdd.decode_rst_chunks_plain(*args, gray, (2, 2), mx, my,
                                            emit_mode="dense")
        out = np.asarray(_jax_log_kernel(2, mx * my, gray, None, False, 4,
                                         1)(ch, sb))
        want = ((out[:mx * my],) if gray else tuple(
            np.asarray(p) for p in jdd.deinterleave_ycbcr_device(out, mx,
                                                                 my)))
        for p, d, w in zip(log, dense, want):
            np.testing.assert_array_equal(p[0].numpy(), w)
            assert torch.equal(p, d)


def test_log_mixed_r_batch_as_jax_and_dense():
    """Two frames of one geometry with restart intervals 1 and 5 in one
    call: each lane sizes its log from its own frame's interval, and
    each frame equals JAX's log decode of it alone."""
    jpegs = [codec.encode_jpeg({"y": np.asarray(
        np.random.default_rng(r).integers(0, 256, (48, 96)), np.uint8)},
        90, restart_interval=r, device="cpu") for r in (1, 5)]
    streams = [tdd.parse_device_stream(j) for j in jpegs]
    assert [s.restart_interval for s in streams] == [1, 5]
    log = _port_grids(streams, "log")
    for p, d in zip(log, _port_grids(streams, "dense")):
        assert torch.equal(p, d)
    for f, data in enumerate(jpegs):
        np.testing.assert_array_equal(log[0][f].numpy(),
                                      _jax_log_grids(data)[0])


def test_log_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper runs the plain version in either mode
    and counts no launch."""
    ds = tdd.parse_device_stream(mux.extract_primary_and_gainmap(
        _encoded()[0][0])[1])
    ln = tdd.pack_streams([ds])
    args = [torch.from_numpy(a) for a in (ln.src, ln.frames, ln.lanes,
                                          ln.tables)]
    before = (tdd.decode_rst_chunks.launches,
              tdd.decode_rst_chunks.log_launches)
    got = tdd.decode_rst_chunks(*args, True, (1, 1), ln.mcus_x, ln.mcus_y,
                                emit_mode="log")
    want = tdd.decode_rst_chunks_plain(*args, True, (1, 1), ln.mcus_x,
                                       ln.mcus_y, emit_mode="log")
    assert torch.equal(got[0], want[0])
    assert (tdd.decode_rst_chunks.launches,
            tdd.decode_rst_chunks.log_launches) == before


_SELECT = """
import numpy as np, torch
from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
calls = []
caps = dd._log_caps
dd._log_caps = lambda *a: calls.append(1) or caps(*a)
rng = np.random.default_rng(0)
ch = rng.integers(0, 256, 4 * 96, dtype=np.uint8)
frames = np.asarray([dd.frame_row(0, ch.size, 96, 2, 0, 4, False, 2)],
                    np.int32)
lanes = np.stack([np.arange(4) * 96, np.zeros(4)], 1).astype(np.int32)
args = [torch.from_numpy(a) for a in (ch, frames, lanes,
        dd.decode_tables(dd.ANNEX_K_GRAY)[None])] + [True, (1, 1), 8, 1]
seen = [dd._DEFAULT_EMIT]
for mode in (None, "log", "dense", "other"):
    del calls[:]
    dd.decode_rst_chunks(*args, emit_mode=mode)
    seen.append(len(calls))
print(seen)
"""


@pytest.mark.parametrize("env,want", [
    ("log", "['log', 1, 1, 0, 0]"),
    (None, "['dense', 0, 1, 0, 0]"),
    ("dense", "['dense', 0, 1, 0, 0]")])
def test_env_selects_the_log_arm(env, want):
    """UHDR_DECODE_EMIT, read at import, sets the default; an explicit
    emit_mode wins; any value but "log" is dense (JAX's :450)."""
    environ = dict(os.environ)
    environ.pop("UHDR_DECODE_EMIT", None)
    if env is not None:
        environ["UHDR_DECODE_EMIT"] = env
    out = subprocess.run([sys.executable, "-c", _SELECT], cwd=REPO,
                         env=environ, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == want


# ---------------------------------------------------------------------------
# The slice: device decodes under the log emission.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["HDR_HLG", "HDR_LINEAR"])
def test_jpegr_decode_under_log_as_jax(fmt, log_emission):
    blob = _encoded()[0][0]
    want = np.asarray(jjpegr.JpegR().decode(
        blob, JOutputFormat[fmt]).image.planes["rgba"])
    got = JpegR("cpu").decode(blob, OutputFormat[fmt]).image.planes["rgba"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_handoff_decode_under_log_as_jax(log_emission):
    _, jhand, thand = _encoded()
    want = np.asarray(sharding.batched_decode_from_handoff(
        jhand, "hdr_hlg", math.inf, sharding.single_device_mesh()))
    got = batched.batched_decode_from_handoff(thand, "hdr_hlg").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_decode_jpeg_under_log_as_jax(log_emission):
    """decode_jpeg of the JPEG/R's 4:2:0 base (restart intervals), but
    for B5's rounding ties (_assert_planes_as_jax)."""
    data = mux.extract_primary_and_gainmap(_encoded()[0][1])[0]
    _assert_planes_as_jax(data, codec.decode_jpeg(data, "cpu"),
                          jdd.decode_jpeg_device(data)[1])
