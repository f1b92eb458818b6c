"""The port's batched_apply_gainmap (libultrahdr_dev_tpu_torch/parallel/
batched.py: B6 over a leading batch dimension, here its plain version on
the CPU) against the JAX package's sharding.batched_apply_gainmap on the
8-device CPU mesh of tests/conftest.py: a batch of 8 at 64x48, HLG
RGBA1010102 and linear F16, within 1 code / 1 F16 ULP with >= 99.9% of
channel samples exact."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.parallel import sharding
from libultrahdr_dev_tpu.types import GainMapMetadata as JMetadata
from libultrahdr_dev_tpu_torch.interop import metadata_from_jax
from libultrahdr_dev_tpu_torch.parallel import batched

import test_torch_threads  # noqa: F401  (caps torch's threads)

N, H, W = 8, 48, 64


def planes(seed=7):
    """Smooth u8 planes with noise and a 4x-subsampled gain map."""
    rng = np.random.default_rng(seed)

    def smooth(h, w):
        base = np.kron(rng.integers(16, 240, (N, h // 8, w // 8)),
                       np.ones((1, 8, 8)))
        return np.clip(base + rng.integers(-6, 7, (N, h, w)), 0,
                       255).astype(np.uint8)

    return (smooth(H, W), smooth(H // 2, W // 2), smooth(H // 2, W // 2),
            rng.integers(0, 256, (N, H // 4, W // 4)).astype(np.uint8))


META = JMetadata(max_content_boost=1000 / 203, min_content_boost=1.0,
                 hdr_capacity_min=1.0, hdr_capacity_max=1000 / 203)


def channel_diff(got, want, fmt):
    if fmt == "hdr_linear":
        return np.abs(got[..., :3].astype(np.int64) - want[..., :3])
    g, w = got.astype(np.int64), want.astype(np.int64)
    return np.stack([np.abs(((g >> s) & 1023) - ((w >> s) & 1023))
                     for s in (0, 10, 20)])


@pytest.mark.parametrize("fmt,dtype", [("hdr_hlg", np.uint32),
                                       ("hdr_linear", np.uint16)])
def test_batched_apply_gainmap_as_jax(fmt, dtype):
    p = planes()
    want = np.asarray(sharding.batched_apply_gainmap(
        *p, META, fmt, 4.0, sharding.default_mesh()))
    got = batched.batched_apply_gainmap(*p, metadata_from_jax(META), fmt,
                                        4.0, device="cpu")
    assert got.device.type == "cpu"
    got = got.numpy().view(dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    d = channel_diff(got, want, fmt)
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999


def test_batched_apply_gainmap_takes_tensors():
    """Tensor planes give what their numpy arrays give."""
    p = planes(seed=8)
    md = metadata_from_jax(META)
    a = batched.batched_apply_gainmap(*p, md, "hdr_hlg", 2.0, device="cpu")
    b = batched.batched_apply_gainmap(*map(torch.from_numpy, p), md,
                                      "hdr_hlg", 2.0, device="cpu")
    assert torch.equal(a, b)
