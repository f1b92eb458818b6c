"""The progressive JPEG fixture of the port's off-path formats and its
sidecar.

    JAX_PLATFORMS=cpu python tests/fixtures_torch/prog_fixture.py

writes prog_4000x3000_420.jpg (PIL, progressive, 4:2:0, quality 85, of
the seeded band-limited content of `content()`) and
prog_4000x3000_420.json beside it: the sha256 of the JAX package's
decode_jpeg_coefs grids of the file (`grids_sha256`). chip_smoke.py
holds the port's grids on the GPU machine, which has neither PIL nor
JAX, to that digest; tests/test_torch_progressive.py recomputes it from
the JAX package on every run. Importing this module imports neither PIL
nor JAX.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPG = os.path.join(HERE, "prog_4000x3000_420.jpg")
SIDECAR = os.path.join(HERE, "prog_4000x3000_420.json")
WIDTH, HEIGHT, QUALITY, SEED = 4000, 3000, 85, 19
DIGEST = ("sha256 of each component's decode_jpeg_coefs coefficient grid "
          "(int16 little-endian, C order: block rows, block columns, 64 "
          "zigzag coefficients), components in frame order, concatenated")


def _band(h: int, w: int, seed: int, cell: int = 32) -> np.ndarray:
    """Band-limited plane: random levels on a cell x cell grid, box
    blurred a quarter cell."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // cell + 2, w // cell + 2)).astype(
        np.float32)
    y = np.kron(small, np.ones((cell, cell), np.float32))[:h, :w]
    k = cell // 4
    y = (y + np.roll(y, k, 0) + np.roll(y, k, 1)
         + np.roll(y, (k, k), (0, 1))) / 4
    return np.clip(y, 0, 255).astype(np.uint8)


def content() -> np.ndarray:
    """The (HEIGHT, WIDTH, 3) uint8 RGB image: three band-limited
    planes with +-2 of noise."""
    rgb = np.dstack([_band(HEIGHT, WIDTH, SEED + i) for i in range(3)])
    noise = np.random.default_rng(SEED).integers(-2, 3, rgb.shape)
    return np.clip(rgb.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def grids_sha256(grids) -> str:
    h = hashlib.sha256()
    for g in grids:
        h.update(np.ascontiguousarray(g, "<i2").tobytes())
    return h.hexdigest()


def jax_digest(data: bytes) -> tuple[str, list]:
    """(digest, grid shapes) of the JAX package's decode_jpeg_coefs."""
    from libultrahdr_dev_tpu.jpeg import codec

    grids = [c[0] for c in codec.decode_jpeg_coefs(data).comps]
    return grids_sha256(grids), [list(g.shape) for g in grids]


def write():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(content()).save(buf, "JPEG", quality=QUALITY,
                                    progressive=True, subsampling=2)
    data = buf.getvalue()
    digest, shapes = jax_digest(data)
    with open(JPG, "wb") as f:
        f.write(data)
    with open(SIDECAR, "w") as f:
        json.dump({"jpeg": os.path.basename(JPG), "bytes": len(data),
                   "width": WIDTH, "height": HEIGHT, "quality": QUALITY,
                   "sampling": "4:2:0", "grids": shapes, "sha256": digest,
                   "digest": DIGEST,
                   "made_by": "tests/fixtures_torch/prog_fixture.py"},
                  f, indent=1)
        f.write("\n")
    return data, digest


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    data, digest = write()
    print(f"{JPG}: {len(data)} bytes, grids sha256 {digest}")
