"""Kernels B2 (fDCT + quant + zigzag) and B5 (dequant + IDCT) of the port
(libultrahdr_dev_tpu_torch/jpeg/dct.py), through their wrappers on CPU
tensors (the plain PyTorch versions), against the JAX package's
jpeg/dct.py on the same numpy inputs.

Tolerance: int16 coefficients and u8 pixels equal, except +-1 where a
float64 recomputation puts the value within 1e-3 of a rounding tie
(x.5): there float32 summation order decides, in either framework."""

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.jpeg import dct as jdct, tables
from libultrahdr_dev_tpu.parallel import sharding
from libultrahdr_dev_tpu_torch.jpeg import dct as tdct

H, W = 96, 128


def _plane(h, w, seed):
    """Block-smooth u8 content with a noisy band (flat blocks give the
    exact .5 ties of DC at quality 95)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1))
    p = np.kron(base, np.ones((8, 8), np.int64))[:h, :w]
    p = p + rng.integers(-2, 3, (h, w)) * (np.arange(h)[:, None] < h // 3)
    return np.clip(p, 0, 255).astype(np.uint8)


def _exact_fdct(plane, q):
    """float64 c/q in zigzag order of an edge-padded plane."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128.0,
               ((0, -h % 8), (0, -w % 8)), mode="edge")
    bh, bw = p.shape[0] // 8, p.shape[1] // 8
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    d = tdct._D64
    c = d @ blocks @ d.T
    return (c.reshape(-1, 64) / q.reshape(64))[:, tdct.ZIG]


def _assert_equal_but_ties(got, want, exact):
    off = got.astype(np.int64) != want.astype(np.int64)
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 1
    frac = np.abs(exact[off] - np.floor(exact[off]) - 0.5)
    assert bool((frac < 1e-3).all()), frac


@pytest.mark.parametrize("table,quality", [("luma", 95), ("chroma", 95),
                                           ("luma", 85), ("luma", 50)])
def test_fdct_quant_matches_jax(table, quality):
    base = (tables.STD_LUMINANCE_QUANT if table == "luma"
            else tables.STD_CHROMINANCE_QUANT)
    q = tables.scale_quant_table(base, quality)
    plane = _plane(H, W, seed=quality)
    want = np.asarray(jdct.fdct_quant(plane, q))
    got = tdct.fdct_quant(torch.from_numpy(plane)[None],
                          torch.from_numpy(q.reshape(64)))[0].numpy()
    _assert_equal_but_ties(got, want, _exact_fdct(plane, q))


def test_fdct_edge_padding_matches_sharding():
    """A gain map whose dims are not multiples of 8 is edge-padded as
    sharding._fdct_zigzag pads it."""
    q = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 85)
    plane = _plane(27, 35, seed=7)
    want = np.asarray(jax.jit(sharding._fdct_zigzag)(plane, q))
    got = tdct.fdct_quant(torch.from_numpy(plane)[None],
                          torch.from_numpy(q.reshape(64)))[0].numpy()
    assert got.shape == (4 * 5, 64)
    _assert_equal_but_ties(got, want, _exact_fdct(plane, q))


@pytest.mark.parametrize("quality", [95, 50])
def test_dequant_idct_matches_jax(quality):
    q = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    coefs = np.array(jdct.fdct_quant(_plane(H, W, seed=3), q))
    want = np.asarray(jdct.dequant_idct(coefs, q, H, W))
    got = tdct.dequant_idct(torch.from_numpy(coefs)[None],
                            torch.from_numpy(q.reshape(1, 64)),
                            H // 8, W // 8)[0].numpy()
    nat = coefs[:, tdct.INV_ZIG].astype(np.float64) * q.reshape(64)
    d = tdct._D64
    pix = d.T @ nat.reshape(-1, 8, 8) @ d + 128.0
    exact = pix.reshape(H // 8, W // 8, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(H, W)
    _assert_equal_but_ties(got, want, exact)


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors the wrappers take the plain version and launch
    nothing; the batch dimension is independent per frame."""
    q = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 95)
    planes = np.stack([_plane(16, 24, s) for s in (1, 2)])
    before = (tdct.fdct_quant.launches, tdct.dequant_idct.launches)
    qt = torch.from_numpy(q.reshape(64))
    c = tdct.fdct_quant(torch.from_numpy(planes), qt)
    assert c.dtype == torch.int16 and c.shape == (2, 6, 64)
    assert torch.equal(c[1], tdct.fdct_quant_plain(
        torch.from_numpy(planes[1:]), qt)[0])
    px = tdct.dequant_idct(c, qt.expand(2, 64), 2, 3)
    assert px.dtype == torch.uint8 and px.shape == (2, 16, 24)
    assert (tdct.fdct_quant.launches, tdct.dequant_idct.launches) == before
