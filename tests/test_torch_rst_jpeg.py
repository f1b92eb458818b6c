"""Kernel B12-enc of the port: encode_jpeg with restart intervals
(libultrahdr_dev_tpu_torch/jpeg/codec.py:entropy_stage, B3 generalised
to 4:2:2, 4:4:4 and any interval), through its plain PyTorch version,
against the JAX package on the same numpy inputs.

All comparisons are exact: encode_jpeg's bytes against the JAX
encode_jpeg's (which Huffman-codes on the host off an accelerator; its
device route writes the same bytes), the B3 stream and chunk bits at
4:2:2 / 4:4:4 against the JAX encode_ycbcr_rst_stream (ypm 2 and 1,
jitted on the CPU), and B3's 608-bit flag against the JAX overflow
flag."""

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.container import icc as jicc
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu.jpeg import device_entropy as jde
from libultrahdr_dev_tpu_torch.container import icc as ticc
from libultrahdr_dev_tpu_torch.jpeg import codec as tcodec
from libultrahdr_dev_tpu_torch.jpeg import device_entropy as tde

import test_torch_jax_native  # noqa: F401  (loads the JAX native codec)
from test_torch_entropy import MX, MY, NM, _blocks
from test_torch_jpeg_codec import KINDS, _planes
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 44, 61   # 4:2:0 -> 3 x 4 MCUs, 4:4:4 -> 6 x 8


@pytest.mark.parametrize("with_icc", [False, True])
@pytest.mark.parametrize("restart", [1, 3, 7, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_jpeg_restart_bytes_identical_to_jax(kind, restart, with_icc):
    planes = _planes(kind, H, W, seed=restart + with_icc)
    icc = jicc.write_icc_profile("srgb", "p3") if with_icc else None
    assert icc == (ticc.write_icc_profile("srgb", "p3") if with_icc
                   else None)
    want = jcodec.encode_jpeg(planes, quality=88, icc=icc,
                              restart_interval=restart)
    calls = (tcodec.entropy_encode.calls, tcodec.entropy_stage.rst_launches)
    got = tcodec.encode_jpeg(planes, quality=88, icc=icc,
                             restart_interval=restart, device="cpu")
    assert got == want
    assert b"\xff\xdd\x00\x04" in got
    # No host Huffman call; no kernel launch on CPU tensors.
    assert (tcodec.entropy_encode.calls,
            tcodec.entropy_stage.rst_launches) == calls


@pytest.mark.parametrize("kind", ["frame", "dense", "zero_runs", "pos63"])
@pytest.mark.parametrize("ypm,sampling", [(2, (2, 1)), (1, (1, 1))])
def test_plain_b3_422_444_matches_jax(kind, ypm, sampling):
    hs, vs = sampling
    yz = _blocks(kind, ypm * NM, 1)
    uz, vz = _blocks(kind, NM, 2), _blocks(kind, NM, 3)
    got, bits = tde.encode_ycbcr_rst_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, 4,
        sampling)
    inter = np.asarray(jde.interleave_blocks_device(yz, uz, vz, MX, MY, hs,
                                                    vs))
    sw, clen, total, ovf = jax.jit(lambda b: jde.encode_ycbcr_rst_stream(
        b, 4, None, ypm))(inter)
    assert not bool(ovf)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(clen))
    assert got.numpy().tobytes() == np.asarray(sw)[:int(total)].astype(
        ">u4").tobytes()


@pytest.mark.parametrize("kind", ["dense", "noise", "one_long"])
def test_block_cap_flags_what_jax_flags(kind):
    """B3 with block_cap=608 gives None exactly when the JAX encoder's
    overflow flag is set (at its full-width cap), for color and gray."""
    rng = np.random.default_rng(4)
    yz, uz, vz = (_blocks("dense", nb, s) for nb, s in ((4 * NM, 1),
                                                         (NM, 2), (NM, 3)))
    if kind == "noise":
        yz = rng.integers(-2000, 2001, yz.shape).astype(np.int16)
    elif kind == "one_long":    # a single chroma block past the cap
        vz = vz.copy()
        vz[NM // 2, 1:] = rng.integers(300, 900, 63)
    _, _, _, ovf = jax.jit(lambda b: jde.encode_yuv420_rst_stream(
        b, 4, None))(np.asarray(jde.interleave_blocks_device(yz, uz, vz, MX,
                                                             MY)))
    got = tde.encode_ycbcr_rst_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, 4,
        block_cap=tde.BLOCK_BIT_CAP)
    assert (got is None) == bool(ovf) == (kind != "dense")
    gz = np.concatenate([uz, vz])
    _, _, _, govf = jax.jit(lambda b: jde.encode_gray_rst_stream(
        b, 4, None))(gz)
    gray = tde.encode_gray_rst_stream(torch.from_numpy(gz)[None], 4,
                                      block_cap=tde.BLOCK_BIT_CAP)
    assert (gray is None) == bool(govf)
