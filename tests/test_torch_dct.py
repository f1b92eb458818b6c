"""Kernels B2 (fDCT + quant + zigzag) and B5 (dequant + IDCT) of the port
(libultrahdr_dev_tpu_torch/jpeg/dct.py), through their wrappers on CPU
tensors (the plain PyTorch versions), against the JAX package's
jpeg/dct.py on the same numpy inputs.

Tolerance: B2's coefficients are bitwise equal to JAX's (the
``*_bitwise_*`` and near-tie tests hold that on over 10^6 blocks); the
older tests and B5's u8 pixels allow +-1 where a float64 recomputation
puts the value within 1e-3 of a rounding tie (x.5)."""

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.jpeg import dct as jdct, tables
from libultrahdr_dev_tpu.parallel import sharding
from libultrahdr_dev_tpu_torch.jpeg import dct as tdct
import test_torch_threads  # noqa: F401  (caps torch's threads)

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


#: An 8x8 luma block (u8) whose zigzag coefficient 39 is exactly -45.5:
#: against q = 7 (luma, quality 95) the quotient -6.5 rounds to -6, and
#: the product with the float32 1/7 to -7.
TIE_BLOCK = np.array(
    [[204, 184, 152, 203, 155, 20, 163, 189],
     [182, 140, 60, 195, 64, 193, 61, 93],
     [197, 43, 30, 100, 187, 32, 50, 31],
     [206, 155, 173, 59, 85, 159, 198, 146],
     [156, 174, 142, 138, 41, 24, 72, 64],
     [201, 162, 197, 175, 74, 187, 190, 130],
     [103, 55, 34, 190, 70, 45, 154, 84],
     [173, 60, 174, 134, 150, 187, 150, 163]], np.uint8)


def _program_fdct(plane, q):
    """sharding._fdct_zigzag as the JAX encode program runs it: the
    quant table a constant of the jitted program."""
    return np.asarray(jax.jit(lambda p: sharding._fdct_zigzag(p, q))(plane))


def test_fdct_exact_tie_follows_each_jax_form():
    """The quotient form (the codec's fdct_quant, q an argument) and the
    reciprocal form (the encode program, q a constant) part on an exact
    tie; the port's B2 gives each JAX form's value."""
    q = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 95)
    assert q.reshape(64)[tables.ZIGZAG[39]] == 7
    assert _exact_fdct(TIE_BLOCK, q)[0, 39] == pytest.approx(-6.5, abs=1e-9)
    x, qt = torch.from_numpy(TIE_BLOCK)[None], torch.from_numpy(q.reshape(64))
    quot = tdct.fdct_quant(x, qt)[0].numpy()
    prod = tdct.fdct_quant(x, qt, recip=True)[0].numpy()
    assert (quot[0, 39], prod[0, 39]) == (-6, -7)
    np.testing.assert_array_equal(quot, np.asarray(jdct.fdct_quant(
        TIE_BLOCK, q)))
    np.testing.assert_array_equal(prod, _program_fdct(TIE_BLOCK, q))


@pytest.mark.parametrize("table,quality", [("luma", 95), ("chroma", 95),
                                           ("luma", 85)])
def test_fdct_recip_bitwise_as_the_encode_program(table, quality):
    """recip=True equals the JAX encode program's coefficients bit for
    bit, on block-smooth content full of DC ties and on the tie block."""
    base = (tables.STD_LUMINANCE_QUANT if table == "luma"
            else tables.STD_CHROMINANCE_QUANT)
    q = tables.scale_quant_table(base, quality)
    plane = _plane(H, W, seed=quality + 1)
    plane[8:16, 16:24] = TIE_BLOCK
    want = _program_fdct(plane, q)
    got = tdct.fdct_quant(torch.from_numpy(plane)[None],
                          torch.from_numpy(q.reshape(64)), recip=True)
    np.testing.assert_array_equal(got[0].numpy(), want)


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


def _blocks_plane(kind, seed):
    """A 4096x512 plane (32,768 blocks) of one kind of content:
    uniform noise, smooth blocks (a level, a gradient and a little
    noise), or blocks of four flat quadrants with noise (sharp edges:
    the kron dots' middle term then rounds in its pairwise tree)."""
    rng = np.random.default_rng(seed)
    h, w = 4096, 512
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w] % 8
        lvl = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
        gy, gx = (np.kron(rng.normal(0, 4, (h // 8, w // 8)), np.ones((8, 8)))
                  for _ in range(2))
        p = lvl + gy * yy + gx * xx + rng.normal(0, 2, (h, w))
    else:
        p = np.kron(rng.integers(0, 256, (h // 4, w // 4)), np.ones((4, 4)))
        p = p + rng.normal(0, 6, (h, w))
    return np.clip(np.round(p), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("rep", range(6))
@pytest.mark.parametrize("kind", ["noise", "smooth", "quadrants"])
@pytest.mark.parametrize("table", ["ones", "q95"])
def test_fdct_quant_bitwise_as_jax(table, kind, rep):
    """B2 computes the JAX kron form bit for bit, near-ties included:
    6 x 3 x 2 x 32,768 = 1,179,648 blocks in all, none off by one."""
    q = (np.ones(64, np.int32) if table == "ones" else
         tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, 95))
    plane = _blocks_plane(kind, seed=rep)
    want = np.asarray(jdct.fdct_quant(plane, q))
    got = tdct.fdct_quant(torch.from_numpy(plane)[None],
                          torch.from_numpy(q.reshape(64)))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_kron_terms_are_jax_split():
    """The port's own copy of the three bf16 terms of kron(D, D)[:, ZIG]
    equals the JAX package's."""
    for mine, theirs in zip(tdct.KRON_ZIG, jdct._KRON_ZIG_SPLIT):
        np.testing.assert_array_equal(mine, np.asarray(theirs, np.float32))


def test_fdct_dense_v_plane_near_tie_as_jax():
    """The dense HLG noise frame at quality 100: its V block 20 has the
    coefficient 155.4999963 at zigzag 62 (a near-tie) that JAX rounds
    to 156. The port's B2 gives JAX's coefficients on the whole plane."""
    from libultrahdr_dev_tpu_torch.parallel import batched

    rng = np.random.default_rng(3)
    y = (rng.integers(0, 1024, (64, 128)) << 6).astype(np.uint16)
    uv = (rng.integers(0, 1024, (32, 128)) << 6).astype(np.uint16)
    front = batched.encode_front(
        batched.p010_to_device(y[None], "cpu"),
        batched.p010_to_device(uv[None], "cpu"), "bt2100", "hlg")
    v = front[3][0].numpy()
    qc = batched.quant_tables(100)[1]
    want = np.asarray(jdct.fdct_quant(v, qc))
    got = tdct.fdct_quant(torch.from_numpy(v)[None],
                          torch.from_numpy(qc.reshape(64)))[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.reshape(-1)[1342] == want.reshape(-1)[1342] == 156


def test_jax_dots_sum_as_a_pairwise_tree():
    """What B2 follows: XLA's CPU dot of JAX's fdct_zigzag (bf16 samples
    times each bf16 term, float32 result) equals exact row sums of 8
    products added as a pairwise float32 tree over the 8 rows, on every
    dot of 65,536 sharp-edged blocks; rounding each dot's exact sum once
    does not (it disagrees on some middle-term dots)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    q = np.repeat(np.repeat(rng.integers(0, 256, (1 << 16, 2, 1, 2, 1)), 4,
                            2), 4, 4).reshape(-1, 64)
    xb = np.clip(q + rng.normal(0, 6, q.shape), 0, 255).round() - 128
    x16 = jnp.asarray(xb.astype(np.float32)).astype(jnp.bfloat16)
    tree_all, exact_all = True, True
    for m in tdct.KRON_ZIG:
        want = np.asarray(jnp.dot(x16, jnp.asarray(m).astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32))
        got = tdct._tree8(torch.bmm(
            torch.from_numpy(xb.astype(np.float32).reshape(-1, 8, 8)
                             .transpose(1, 0, 2).copy()),
            torch.from_numpy(m.reshape(8, 8, 64)))).numpy()
        tree_all &= bool(np.array_equal(got.view(np.uint32),
                                        want.view(np.uint32)))
        exact = (xb @ m.astype(np.float64)).astype(np.float32)
        exact_all &= bool(np.array_equal(exact.view(np.uint32),
                                         want.view(np.uint32)))
    assert tree_all and not exact_all


def _ulp_bf16(w):
    """The last bit of each (nonzero) bf16 value."""
    return 2.0 ** (np.floor(np.log2(np.abs(w))) - 7)


@pytest.mark.parametrize("term", range(3))
def test_kron_row_sums_fit_float32(term):
    """B2's premise for its tensor-core row sums: for every block row and
    output column of a term of KRON_ZIG, the largest |row sum| any
    samples in [-128, 127] can give is under 2^24 times the smallest
    weight's last bit (19.5, 23.6 and 23.4 bits), so every row sum is a
    float32; and the float64 row sums of the adversarial rows
    (kron_adversarial_rows, which chip_smoke.py holds the card's mma
    to) round-trip through float32 exactly."""
    w = tdct.KRON_ZIG[term].astype(np.float64).reshape(8, 8, 64) \
        .transpose(0, 2, 1)                       # (row, column, sample)
    worst = 0.0
    for r in range(8):
        for o in range(64):
            nz = w[r, o][w[r, o] != 0]
            if nz.size == 0:
                continue
            worst = max(worst, float(np.log2(
                128 * np.abs(w[r, o]).sum() / _ulp_bf16(nz).min())))
    assert worst < 24, worst
    rows = tdct.kron_adversarial_rows()[term]     # (row, column, 2, 8)
    assert rows.min() >= -128 and rows.max() <= 127
    sums = (rows * w[:, :, None, :]).sum(-1)
    np.testing.assert_array_equal(sums.astype(np.float32).astype(np.float64),
                                  sums)


def test_kron_mma_fragments_rebuild_terms():
    """The B-fragment table B2 uploads holds only bf16 bits (the terms'
    low halves are zero) and rebuilds KRON_ZIG bit for bit, read the way
    an m16n8k8 mma reads its B operand: lane 4 g + t holds rows 2 t and
    2 t + 1 of column g."""
    assert not (tdct.KRON_ZIG.view(np.uint32) & 0xFFFF).any()
    frags = tdct.kron_mma_fragments()
    assert frags.shape == (3, 8, 2, 32, 4) and frags.dtype == np.uint32
    bits = np.zeros((3, 64, 64), np.uint32)
    for term in range(3):
        for j in range(8):
            for half in range(2):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i in range(4):
                        word = int(frags[term, j, half, lane, i])
                        r = 4 * half + i
                        bits[term, 8 * r + 2 * t, 8 * j + g] = \
                            (word & 0xFFFF) << 16
                        bits[term, 8 * r + 2 * t + 1, 8 * j + g] = \
                            (word >> 16) << 16
    np.testing.assert_array_equal(bits.view(np.float32), tdct.KRON_ZIG)


def test_idct_table_symmetry():
    """What B5's product reuse rests on: in the float32 DCT table,
    D[u][x] is +-D[u][x'] bit for bit wherever cos((2x + 1) u pi / 16)
    and cos((2x' + 1) u pi / 16) have equal magnitudes, with the cosine's
    sign; so row u has at most four magnitudes, 22 in all."""
    d = tdct.D32
    mags = set()
    for u in range(8):
        for x in range(8):
            k = (2 * x + 1) * u % 32
            fold = min(k % 16, 16 - k % 16)
            assert (d[u, x] < 0) == (8 < k < 24)
            mags.add((u, fold, abs(float(d[u, x]))))
    assert len(mags) == 22
    assert len({(u, f) for u, f, _ in mags}) == 22
