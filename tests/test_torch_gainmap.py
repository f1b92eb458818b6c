"""Kernels B1 (API-0 encode front end) and B6 (gain-map apply) of the port
(libultrahdr_dev_tpu_torch/ops/gainmap.py), through their wrappers on
CPU tensors (the plain PyTorch versions), against the JAX package on the
same numpy inputs.

Tolerances: gain codes equal on >= 99.9% of samples and <= 1 apart
elsewhere, BT.601 base planes <= 1 apart (B1); <= 1 ten-bit code
(HLG/PQ) or <= 1 F16 ULP (linear) with >= 99.9% of channel samples
bit-exact (B6), the bar of tests/test_hostapply.py's native apply."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.ops import gainmap as jgm
from libultrahdr_dev_tpu_torch.ops import gainmap as tgm
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 128, 192  # 16-aligned frame, 32x48 gain map


def _p010(h, w, seed=0):
    """Block-smooth narrow-range P010 with noise in the low bits."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 8 + 1, w // 8 + 1))
    y = np.kron(small, np.ones((8, 8), np.int64))[:h, :w]
    y = np.clip(y + rng.integers(0, 30, (h, w)), 64, 940)
    uv = rng.integers(300, 700, (h // 2, w))
    noise = rng.integers(0, 64, (h, w)).astype(np.uint16)
    return ((y.astype(np.uint16) << 6) | noise,
            uv.astype(np.uint16) << 6)


@pytest.mark.parametrize("gamut", ["bt709", "p3", "bt2100"])
@pytest.mark.parametrize("tf", ["hlg", "pq"])
def test_encode_front_matches_jax(gamut, tf):
    y, uv = _p010(H, W, seed=len(gamut) + len(tf))
    y8, u8, v8 = jgm.tonemap_p010(y, uv)
    kernel, _ = jgm._generate_kernel(gamut, gamut, tf, False, False)
    want_map = np.asarray(kernel(y8, u8, v8, y, uv))
    want_base = [np.asarray(p) for p in
                 jgm.convert_yuv_encoding(y8, u8, v8, gamut, "p3")]
    got = tgm.encode_front(torch.from_numpy(y.view(np.int16))[None],
                           torch.from_numpy(uv.view(np.int16))[None],
                           gamut, tf)
    d = np.abs(got[0][0].numpy().astype(np.int64) - want_map)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999
    for g, w in zip(got[1:], want_base):
        assert int(np.abs(g[0].numpy().astype(np.int64) - w).max()) <= 1


def _full_range_p010(h, w, seed):
    """Full-range codes: luma constant over 8x8 blocks at 10-bit 0, 1023
    or a random code (boxes at 0 and 1023 floor and saturate the gain
    codes), chroma uniform over all 10-bit codes."""
    rng = np.random.default_rng(seed)
    lvl = rng.choice(np.array([0, 1023, -1]), (h // 8, w // 8))
    lvl = np.where(lvl < 0, rng.integers(0, 1024, lvl.shape), lvl)
    y = np.kron(lvl, np.ones((8, 8), np.int64)).astype(np.uint16) << 6
    uv = rng.integers(0, 1024, (h // 2, w)).astype(np.uint16) << 6
    return y, uv


@pytest.mark.parametrize("gamut,tf", [("bt2100", "hlg"), ("bt709", "pq")])
@pytest.mark.parametrize("case", ["width_272", "full_range"])
def test_encode_front_edges_match_jax(case, gamut, tf):
    """B1 at a 16-aligned width of 68 gain-map columns (48x272) and on
    full-range codes (128x192, saturated and floored gain codes), with
    test_encode_front_matches_jax's tolerance."""
    if case == "width_272":
        y, uv = _p010(48, 272, seed=7)
    else:
        y, uv = _full_range_p010(H, W, seed=8)
    y8, u8, v8 = jgm.tonemap_p010(y, uv)
    kernel, _ = jgm._generate_kernel(gamut, gamut, tf, False, False)
    want_map = np.asarray(kernel(y8, u8, v8, y, uv))
    want_base = [np.asarray(p) for p in
                 jgm.convert_yuv_encoding(y8, u8, v8, gamut, "p3")]
    got = tgm.encode_front(torch.from_numpy(y.view(np.int16))[None],
                           torch.from_numpy(uv.view(np.int16))[None],
                           gamut, tf)
    d = np.abs(got[0][0].numpy().astype(np.int64) - want_map)
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999
    for g, w in zip(got[1:], want_base):
        assert int(np.abs(g[0].numpy().astype(np.int64) - w).max()) <= 1
    if case == "full_range":
        assert {0, 254 if tf == "hlg" else 255} <= set(np.unique(want_map))


def _planes(h, w, seed):
    """Smooth decode intermediates, as tests/test_hostapply.py makes
    them (JPEG-decoded content is block-smooth)."""
    rng = np.random.default_rng(seed)

    def plane(hh, ww):
        base = rng.integers(0, 256, (hh // 8 + 1, ww // 8 + 1))
        big = np.kron(base, np.ones((8, 8), np.int64))[:hh, :ww]
        return np.clip(big + rng.integers(0, 5, (hh, ww)), 0,
                       255).astype(np.uint8)

    return (plane(h, w), plane((h + 1) // 2, (w + 1) // 2),
            plane((h + 1) // 2, (w + 1) // 2), plane(h // 4, w // 4))


@pytest.mark.parametrize("fmt,scalars", [
    ("hdr_linear", (0.0, 2.3045, 1.0, 4.9396)),
    ("hdr_hlg", (0.0, 2.3045, 0.4342, 2.0)),
    ("hdr_pq", (0.0, 5.6224, 1.0, 49.2611)),
])
def test_apply_matches_jax(fmt, scalars):
    # 108x140 frame: a 27x35 map, so both map edges are odd and the
    # IDW edge cells (inc_r = inc_b = 0) are exercised.
    y8, u8, v8, gm = _planes(108, 140, seed=len(fmt))
    sc = np.asarray(scalars, np.float32)
    want = np.asarray(jgm._apply_kernel(fmt, 4, False)(
        y8, u8, v8, gm, *sc))
    got = tgm.apply_gainmap(*(torch.from_numpy(a)[None]
                              for a in (y8, u8, v8, gm)),
                            torch.from_numpy(sc)[None], fmt)[0].numpy()
    if fmt == "hdr_linear":
        d = np.abs(got.view(np.uint16).astype(np.int64)
                   - want.astype(np.int64))
    else:
        g, w = got.view(np.uint32), want.astype(np.uint32)
        d = np.stack([np.abs(((g >> s) & 1023).astype(np.int64)
                             - ((w >> s) & 1023)) for s in (0, 10, 20)])
    assert int(d.max()) <= 1
    assert float((d == 0).mean()) >= 0.999


def test_wrappers_run_plain_on_cpu():
    y, uv = _p010(32, 48, seed=5)
    before = (tgm.encode_front.launches, tgm.apply_gainmap.launches)
    yt = torch.from_numpy(np.stack([y, y]).view(np.int16))
    uvt = torch.from_numpy(np.stack([uv, uv]).view(np.int16))
    gm, yb, ub, vb = tgm.encode_front(yt, uvt, "bt2100", "hlg")
    assert gm.shape == (2, 8, 12) and yb.shape == (2, 32, 48)
    assert ub.shape == vb.shape == (2, 16, 24)
    sc = torch.tensor([[0.0, 2.3, 1.0, 4.9]] * 2)
    out = tgm.apply_gainmap(yb, ub, vb, gm, sc, "hdr_hlg")
    assert out.dtype == torch.int32 and out.shape == (2, 32, 48)
    assert torch.equal(out[0], out[1])
    assert (tgm.encode_front.launches, tgm.apply_gainmap.launches) == before
    with pytest.raises(ValueError):
        tgm.encode_front(yt[:, :24], uvt[:, :12], "bt2100", "hlg")
