"""Seeded HDR test content: the band-limited P010 generator of the
repository's ``bench.py`` (``synth_p010``), copied here so that the
benchmark owns its inputs.

Each frame is a grid of random 32x32 luma levels, averaged with two
shifted copies of itself (soft edges), and 16x32 chroma levels, all
narrow-range 10-bit codes shifted into the top of 16-bit P010 words. The
edges give the fDCT and the Huffman coder realistic work; the flat
interiors give the gain map both bright and dark regions.
"""

from __future__ import annotations

import numpy as np


def frame_seeds(seed: int, n: int) -> list[int]:
    """n independent 64-bit seeds drawn from a run's seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(
        n, np.uint64)]


def synth_p010(h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """One frame: uint16 P010 luma (h, w) and interleaved CbCr (h/2, w)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    y = np.repeat(np.repeat(small, 32, 0), 32, 1)[:h, :w]
    y = (y + np.roll(y, 7, 0) + np.roll(y, 7, 1)) / 3.0
    y10 = np.clip(y, 64, 940).astype(np.uint16) << 6
    uvs = rng.integers(448, 576, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    c = np.repeat(np.repeat(uvs, 16, 0), 32, 1)[:h // 2, :w // 2]
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = np.clip(c, 64, 960).astype(np.uint16) << 6
    uv[:, 1::2] = np.clip(c[:, ::-1], 64, 960).astype(np.uint16) << 6
    return y10, uv


def pool(h: int, w: int, n: int, seed: int):
    """n frames from `seed`: uint16 (n, h, w) luma and (n, h/2, w) CbCr."""
    frames = [synth_p010(h, w, s) for s in frame_seeds(seed, n)]
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))
