"""Kernel B3 of the port (libultrahdr_dev_tpu_torch/jpeg/device_entropy.py:
restart-interval Huffman encode) through its plain PyTorch version,
against the JAX package's encode_yuv420_rst_stream /
encode_gray_rst_stream (cap_per_block=None, jitted on the CPU) and
against the host Huffman coder, on the same numpy inputs.

All comparisons are exact: the stream bytes (the JAX words in big-endian
byte order, the port's layout) over the used prefix, the chunk bit
counts, the finalized scans and the JPEG/R bytes."""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import jpegr as jjpegr
from libultrahdr_dev_tpu.jpeg import device_entropy as jde
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage)
from libultrahdr_dev_tpu_torch.jpeg import codec, device_entropy as tde
from libultrahdr_dev_tpu_torch.parallel import batched
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 112, 144                # 63 MCUs: the last interval holds 3
MX, MY = W // 16, H // 16
NM = MX * MY
GBH, GBW = 4, 5                # a 28x36 gain map: 20 blocks, 5 intervals


def _blocks(kind: str, nb: int, seed: int) -> np.ndarray:
    """(nb, 64) int16 zigzag blocks of one kind of content."""
    rng = np.random.default_rng(seed)
    b = np.zeros((nb, 64), np.int16)
    if kind == "frame":  # what B2 writes for bench.py's content
        return b
    if kind == "dense":
        # DC differences up to +-2047 and AC up to +-1023, sparse enough
        # that no block passes the JAX per-block buffer (608 bits).
        b[:, 0] = rng.integers(-1023, 1024, nb)
        m = rng.random((nb, 63)) < 0.1
        b[:, 1:] = np.where(m, rng.integers(-1023, 1024, (nb, 63)), 0)
        b[::7, 0] = 1023
        b[1::7, 0] = -1024
        return b
    if kind == "zero_runs":
        b[:, 0] = rng.integers(-50, 50, nb)
        for i in range(nb):
            run = (15, 16, 17, 32, 48)[i % 5]
            pos = 1 + (i // 5) % 8
            b[i, pos] = 3
            if i % 2 == 0 and pos + run + 1 < 64:
                b[i, pos + run + 1] = -5   # a nonzero after the run
        return b
    if kind == "all_zero":
        return b
    if kind == "pos63":
        b[:, 0] = rng.integers(-100, 100, nb)
        b[:, 63] = rng.choice([-7, 7, 1, -1], nb)
        b[::2, 5] = 2
        return b
    raise ValueError(kind)


@lru_cache(maxsize=None)
def _frame_coefs():
    """The coefficients of a 112x144 frame, as the port's B1+B2 give."""
    from test_torch_jpegr import synth_p010
    y, uv = synth_p010(H, W, seed=5)
    return tuple(c[0].numpy() for c in batched.encode_coefs_stage(
        batched.p010_to_device(y[None], "cpu"),
        batched.p010_to_device(uv[None], "cpu"), "bt2100", "hlg", 95))


def _planes(kind: str):
    if kind == "frame":
        return _frame_coefs()
    return (_blocks(kind, 4 * NM, 1), _blocks(kind, NM, 2),
            _blocks(kind, NM, 3), _blocks(kind, GBH * GBW, 4))


def _jax_bytes(words, total) -> bytes:
    return np.asarray(words)[:int(total)].astype(">u4").tobytes()


KINDS = ["frame", "dense", "zero_runs", "all_zero", "pos63"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_b3_color_matches_jax(kind):
    yz, uz, vz, _ = _planes(kind)
    got, bits = tde.encode_ycbcr_rst_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, 4)
    inter = np.asarray(jde.interleave_blocks_device(yz, uz, vz, MX, MY))
    sw, clen, total, ovf = jax.jit(
        lambda b: jde.encode_yuv420_rst_stream(b, 4, None))(inter)
    assert not bool(ovf)
    assert bits.shape == (1, 16)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(clen))
    assert got.numpy().tobytes() == _jax_bytes(sw, total)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_b3_gray_matches_jax(kind):
    gz = _planes(kind)[3]
    got, bits = tde.encode_gray_rst_stream(torch.from_numpy(gz)[None], 4)
    sw, clen, total, ovf = jax.jit(
        lambda b: jde.encode_gray_rst_stream(b, 4, None))(gz)
    assert not bool(ovf)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(clen))
    assert got.numpy().tobytes() == _jax_bytes(sw, total)


@pytest.mark.parametrize("kind", ["frame", "dense", "zero_runs"])
def test_finalize_matches_jax(kind):
    yz, uz, vz, _ = _planes(kind)
    got, bits = tde.encode_ycbcr_rst_stream_plain(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, 4)
    words = np.frombuffer(got.numpy().tobytes(), ">u4").astype(np.uint32)
    assert (tde.finalize_rst_stream(got.numpy(), bits[0].numpy())
            == jde.finalize_rst_stream(words, bits[0].numpy(), 4))


def test_dense_noise_matches_host_huffman():
    """q=100 noise: every coefficient nonzero and large, far past the
    JAX per-block buffer. B3 has no cap: its finalized scans equal the
    host coder's (restart interval 4) on the first and only pass."""
    rng = np.random.default_rng(9)
    yz, uz, vz, gz = (rng.integers(-2000, 2001, (nb, 64)).astype(np.int16)
                      for nb in (4 * NM, NM, NM, GBH * GBW))
    stream, bits = tde.encode_ycbcr_rst_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, 4)
    assert int(bits.max()) > 6 * 608   # well past the JAX cap
    assert (tde.finalize_rst_stream(stream.numpy(), bits[0].numpy())
            == codec.encode_yuv420_scan(yz, uz, vz, W, H, 4))
    stream, bits = tde.encode_gray_rst_stream(torch.from_numpy(gz)[None], 4)
    assert (tde.finalize_rst_stream(stream.numpy(), bits[0].numpy())
            == codec.encode_gray_scan(gz, 4))


def test_batch_frames_follow_one_another():
    """Frame f's chunks start where frame f-1's end, in one buffer."""
    planes = [_planes(k)[:3] for k in ("dense", "pos63")]
    both = [torch.from_numpy(np.stack([p[i] for p in planes]))
            for i in range(3)]
    stream, bits = tde.encode_ycbcr_rst_stream(*both, MX, MY, 4)
    off = 0
    for f, p in enumerate(planes):
        one, b1 = tde.encode_ycbcr_rst_stream(
            *(torch.from_numpy(a)[None] for a in p), MX, MY, 4)
        assert torch.equal(bits[f], b1[0])
        assert torch.equal(stream[off:off + one.numel()], one)
        off += one.numel()
    assert off == stream.numel()


def test_wrappers_run_plain_on_cpu():
    before = (tde.encode_ycbcr_rst_stream.launches,
              tde.encode_gray_rst_stream.launches)
    gz = torch.from_numpy(_blocks("pos63", 8, 0))[None]
    assert torch.equal(tde.encode_gray_rst_stream(gz, 4)[0],
                       tde.encode_gray_rst_stream_plain(gz, 4)[0])
    assert (tde.encode_ycbcr_rst_stream.launches,
            tde.encode_gray_rst_stream.launches) == before


def _raw(gamut, tf, seed):
    from test_torch_jpegr import synth_p010
    y, uv = synth_p010(H, W, seed=seed)
    return y, uv, jjpegr.JpegR().encode_api0(
        JRawImage(fmt=JPixelFormat.P010, width=W, height=H,
                  gamut=JGamut[gamut], planes={"y": y, "uv": uv}),
        JTransfer[tf], 95)


@pytest.mark.parametrize("gamut,tf", [("BT2100", "HLG"), ("BT709", "PQ"),
                                      ("P3", "HLG")])
def test_jpegr_bytes_match_jax_and_host_route(gamut, tf):
    """The port's JPEG/R (B1, B2 and B3's plain version) is the JAX
    package's, and the one the host-Huffman route writes from the same
    coefficients."""
    y, uv, jax_blob = _raw(gamut, tf, seed=len(gamut) + len(tf))
    g, t = gamut.lower(), tf.lower()
    blob = batched.batched_encode_api0(y[None], uv[None], g, t, 95,
                                       device="cpu")[0]
    assert blob == jax_blob
    coefs = batched.encode_coefs_stage(
        batched.p010_to_device(y[None], "cpu"),
        batched.p010_to_device(uv[None], "cpu"), g, t, 95)
    calls = codec.entropy_encode.calls
    assert batched.assemble_api0_host_huffman(coefs, W, H, g, t, 95) == [
        blob]
    assert codec.entropy_encode.calls == calls + 2
