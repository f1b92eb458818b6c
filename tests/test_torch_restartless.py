"""Kernel B19 of the port (libultrahdr_dev_tpu_torch/jpeg/device_entropy.py:
restart-less Huffman encode) through its plain PyTorch version, against
the JAX package's encode_yuv420_stream / encode_gray_stream (jitted on
the CPU) with its host tail _finalize, and against the host Huffman
coder's restart-less scans, on the same numpy inputs.

All comparisons are exact: the stream bytes (the JAX words in big-endian
byte order, the port's layout; the port 1-fills the last word past the
scan's bits, JAX leaves it 0), the bit counts, the finalized scans and
the JPEG/R bytes of the dense-content route."""

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.jpeg import device_entropy as jde
from libultrahdr_dev_tpu_torch.jpeg import codec, device_entropy as tde

from test_torch_entropy import GBH, GBW, KINDS, MX, MY, NM, _planes
import test_torch_threads  # noqa: F401  (caps torch's threads)

NOISE = "noise"   # q=100 noise: every block far past 608 bits
EDGES = "edges"   # the unit sequence's edge cases, within NOISE's +-2000
EDGE_RUNS = (15, 16, 17, 31, 32, 47, 48)


def edge_blocks(nb: int, seed: int) -> np.ndarray:
    """(nb, 64) int16 zigzag blocks that walk the unit sequence's edges:
    zero runs of each EDGE_RUNS length before a nonzero (from the DC or
    from another nonzero), a nonzero at 63 (no EOB), all-zero blocks,
    full blocks, and DCs that swing by ~4000 between neighbours."""
    rng = np.random.default_rng(seed)
    b = np.zeros((nb, 64), np.int16)

    def nz(n):
        return (rng.integers(1, 2001, n) * rng.choice([-1, 1], n)).astype(
            np.int16)

    for i in range(nb):
        kind = i % 8
        if kind == 0:
            continue                       # all zero, DC included
        b[i, 0] = (2000 if i % 2 else -2000) - int(rng.integers(0, 8))
        if kind == 1:
            b[i, 1:] = nz(63)              # full: 63 AC units, no EOB
        elif kind == 2:
            b[i, 63] = nz(1)[0]            # a run of 62, then 63
        elif kind == 3:
            b[i, [1, 63]] = nz(2)          # 61 zeros between, no EOB
        else:
            run = EDGE_RUNS[(i // 8 + kind) % len(EDGE_RUNS)]
            first = 1 + run if kind == 4 else int(rng.integers(1, 63 - run))
            b[i, first] = nz(1)[0]
            if kind != 4 and first + run + 1 <= 63:
                b[i, first + run + 1] = nz(1)[0]
    return b


def _content(kind: str):
    if kind == NOISE:
        rng = np.random.default_rng(9)
        return tuple(rng.integers(-2000, 2001, (nb, 64)).astype(np.int16)
                     for nb in (4 * NM, NM, NM, GBH * GBW))
    if kind == EDGES:
        return tuple(edge_blocks(nb, s) for s, nb in enumerate(
            (4 * NM, NM, NM, GBH * GBW)))
    return _planes(kind)


def _jax_filled(words, total) -> bytes:
    """JAX's used words as JPEG-order bytes, with the bits past `total`
    in the last word set to 1 (the port's fill)."""
    total = int(total)
    nw = (total + 31) // 32
    bits = np.unpackbits(np.asarray(words)[:nw].astype(">u4").view(np.uint8))
    bits[total:] = 1
    return np.packbits(bits).tobytes()


@pytest.mark.parametrize("kind", KINDS + [NOISE, EDGES])
def test_plain_b19_color_matches_jax_and_host(kind):
    yz, uz, vz, _ = _content(kind)
    stream, bits = tde.encode_ycbcr_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY)
    inter = np.asarray(jde.interleave_blocks_device(yz, uz, vz, MX, MY))
    words, total = jax.jit(jde.encode_yuv420_stream)(inter)
    assert bits.shape == (1,) and bits.dtype == torch.int64
    assert int(bits[0]) == int(total)
    assert stream.numpy().tobytes() == _jax_filled(words, total)
    scan = tde.finalize_stream(stream.numpy(), int(bits[0]))
    assert scan == jde._finalize(words, total)
    assert scan == codec.encode_yuv420_scan(yz, uz, vz, 16 * MX, 16 * MY, 0)


@pytest.mark.parametrize("kind", KINDS + [NOISE, EDGES])
def test_plain_b19_gray_matches_jax_and_host(kind):
    gz = _content(kind)[3]
    stream, bits = tde.encode_gray_stream(torch.from_numpy(gz)[None])
    words, total = jax.jit(jde.encode_gray_stream)(gz)
    assert int(bits[0]) == int(total)
    assert stream.numpy().tobytes() == _jax_filled(words, total)
    scan = tde.finalize_stream(stream.numpy(), int(bits[0]))
    assert scan == jde._finalize(words, total) == codec.encode_gray_scan(gz,
                                                                         0)


@pytest.mark.parametrize("sampling", [(2, 1), (1, 1)])
@pytest.mark.parametrize("kind", ["frame", "dense", "zero_runs", NOISE])
def test_plain_b19_422_444_match_host(kind, sampling):
    """4:2:2 and 4:4:4 scans (encode_jpeg's), which the JAX package
    Huffman-codes on the host: B19's are the host coder's."""
    hs, vs = sampling
    rng = np.random.default_rng(len(kind) + hs)
    src = _content(kind)
    yz = np.concatenate([src[0]] * 2)[:hs * vs * NM]
    uz, vz = rng.permutation(src[1]), src[2]
    stream, bits = tde.encode_ycbcr_stream(
        *(torch.from_numpy(a)[None] for a in (yz, uz, vz)), MX, MY, sampling)
    assert (tde.finalize_stream(stream.numpy(), int(bits[0]))
            == codec.encode_ycbcr_scan(yz, uz, vz, MX, MY, sampling, 0))


def test_batch_frames_follow_one_another():
    """Frame f's scan starts on the word after frame f-1's last, in one
    buffer, and each is the scan of that frame alone."""
    planes = [_content(k) for k in ("dense", NOISE)]
    both = [torch.from_numpy(np.stack([p[i] for p in planes]))
            for i in range(4)]
    stream, bits = tde.encode_ycbcr_stream(*both[:3], MX, MY)
    gstream, gbits = tde.encode_gray_stream(both[3])
    for s, b, one in ((stream, bits, lambda p: tde.encode_ycbcr_stream(
            *(torch.from_numpy(a)[None] for a in p[:3]), MX, MY)),
            (gstream, gbits, lambda p: tde.encode_gray_stream(
                torch.from_numpy(p[3])[None]))):
        span = tde.stream_spans(b.numpy())
        assert span[-1] == s.numel()
        for f, p in enumerate(planes):
            s1, b1 = one(p)
            assert int(b[f]) == int(b1[0])
            assert torch.equal(s[span[f]:span[f + 1]], s1)


def test_finalize_pads_and_stuffs_as_jax():
    """A scan that ends inside a byte and holds 0xFF bytes."""
    words = np.array([0xFF12FFFF, 0xA5000000], np.uint32)
    for total in (32, 37, 40, 41, 64):
        stream = np.frombuffer(words.astype(">u4").tobytes(), np.uint8)
        assert tde.finalize_stream(stream, total) == jde._finalize(words,
                                                                   total)


def test_wrappers_run_plain_on_cpu():
    before = (tde.encode_ycbcr_stream.launches,
              tde.encode_gray_stream.launches)
    yz, uz, vz, gz = (torch.from_numpy(a)[None] for a in _content("pos63"))
    assert all(map(torch.equal, tde.encode_gray_stream(gz),
                   tde.encode_gray_stream_plain(gz)))
    assert all(map(torch.equal, tde.encode_ycbcr_stream(yz, uz, vz, MX, MY),
                   tde.encode_ycbcr_stream_plain(yz, uz, vz, MX, MY)))
    assert (tde.encode_ycbcr_stream.launches,
            tde.encode_gray_stream.launches) == before
