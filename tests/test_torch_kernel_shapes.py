"""Shapes the redesigned B6 and B3 kernels cut their work by, on the CPU:
B6's gain-map apply at odd widths and heights (a map scale of 3) against
the JAX package, B3's tiling of restart intervals into tiles
(jpeg/device_entropy.py:rst_tiling), and B6's pow probe on CPU tensors.

Tolerances: B6 as tests/test_torch_gainmap.py (<= 1 ten-bit code or F16
ULP, >= 99.9% of channel samples bit-exact); the rest exact."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.ops import gainmap as jgm
from libultrahdr_dev_tpu_torch.jpeg import device_entropy as de
from libultrahdr_dev_tpu_torch.ops import color
from libultrahdr_dev_tpu_torch.ops import gainmap as tgm
import test_torch_threads  # noqa: F401  (caps torch's threads)


@pytest.mark.parametrize("fmt,scalars", [
    ("hdr_linear", (0.0, 2.3045, 1.0, 4.9396)),
    ("hdr_pq", (0.0, 5.6224, 1.0, 49.2611)),
])
def test_apply_odd_size_matches_jax(fmt, scalars):
    # A 33x45 frame over an 11x15 map: odd luma and chroma sizes, the
    # last chroma column and row covering one luma pixel.
    h, w, scale = 33, 45, 3
    rng = np.random.default_rng(len(fmt))
    y8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u8, v8 = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                           dtype=np.uint8) for _ in range(2))
    gm = rng.integers(0, 256, (h // scale, w // scale), dtype=np.uint8)
    sc = np.asarray(scalars, np.float32)
    want = np.asarray(jgm._apply_kernel(fmt, scale, False)(
        y8, u8, v8, gm, *sc))
    got = tgm.apply_gainmap(*(torch.from_numpy(a)[None]
                              for a in (y8, u8, v8, gm)),
                            torch.from_numpy(sc)[None], fmt)[0].numpy()
    if fmt == "hdr_linear":
        d = np.abs(got.view(np.uint16).astype(np.int64)
                   - want.astype(np.int64))
    else:
        g, wt = got.view(np.uint32), want.astype(np.uint32)
        d = np.stack([np.abs(((g >> s) & 1023).astype(np.int64)
                             - ((wt >> s) & 1023)) for s in (0, 10, 20)])
    assert got.shape[:2] == (h, w)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999


@pytest.mark.parametrize("n_mcus,r,per_mcu", [
    (12240, 4, 1), (48960, 4, 6), (47000, 17, 6), (47000, 43, 6),
    (651, 300, 6), (651, 300, 1), (117, 1, 3), (5, 200, 4)])
def test_rst_tiling_covers_each_chunk(n_mcus, r, per_mcu):
    """Every block of a frame falls in one tile of at most RL_TILE
    blocks; a tile holds whole intervals or a part of one interval, the
    cut the kernels' tile_span makes."""
    k, p, t = de.rst_tiling(n_mcus, r, per_mcu)
    cb, nb = r * per_mcu, n_mcus * per_mcu
    nc = de.n_chunks(n_mcus, r)
    owner = np.full(nb, -1)
    for tile in range(t):
        if p == 1:
            t0 = tile * k * cb
            t1 = min(t0 + k * cb, nb)
        else:
            c, part = divmod(tile, p)
            t0 = c * cb + part * de.RL_TILE
            t1 = min(c * cb + min((part + 1) * de.RL_TILE, cb), nb)
        assert t1 - t0 <= de.RL_TILE
        if t1 > t0:
            assert (owner[t0:t1] == -1).all()
            owner[t0:t1] = tile
            chunks = np.arange(t0, t1) // cb
            if p > 1:
                assert (chunks == tile // p).all()
            else:
                assert t0 % cb == 0 and (t1 % cb == 0 or t1 == nb)
    assert (owner >= 0).all()
    assert (k == 1) or (p == 1)
    assert t == (-(-nc // k) if p == 1 else nc * p)


def test_pow_probe_runs_plain_on_cpu():
    x = torch.linspace(0.09, 1.0, 1001)
    assert torch.equal(tgm.pow_probe(x, 2.4), color.pow_rn(x, 2.4))
    assert torch.equal(tgm.pow_probe(x, 2.4, exact=False),
                       color.pow_rn(x, 2.4))
    with pytest.raises(ValueError):
        tgm.pow_exact_check(2.4, 0x3DB851EC, 0x3F800001, "cpu")
