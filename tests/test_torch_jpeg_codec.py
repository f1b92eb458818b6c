"""The port's plain-JPEG codec (libultrahdr_dev_tpu_torch/jpeg/codec.py:
encode_jpeg and decode_jpeg) on CPU tensors, against the JAX package.

Bars: encode_jpeg's bytes are identical to the JAX encode_jpeg's for
gray, 4:2:0, 4:2:2 and 4:4:4 planes, with and without ICC, at sizes
that need edge padding, with no host Huffman call (B19's plain version
codes the scan); decode_jpeg's planes are equal to the JAX
decode_jpeg's (its host route on the CPU) on restart-less streams and
on streams with restart markers, on the device route (B4 then B5, the
plain versions here) and on the host-Huffman route."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.container import icc as jicc
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu_torch import UhdrError
from libultrahdr_dev_tpu_torch.container import icc as ticc
from libultrahdr_dev_tpu_torch.jpeg import codec as tcodec
from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

import test_torch_jax_native  # noqa: F401  (loads the JAX native codec)
import test_torch_threads  # noqa: F401  (caps torch's threads)


def _planes(kind: str, h: int, w: int, seed: int) -> dict:
    """Block-smooth u8 planes of a gray / 4:2:0 / 4:2:2 / 4:4:4 image
    (floor-half chroma, as a raw image carries it)."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        small = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
        big = np.kron(small, np.ones((8, 8), np.int64))[:ph, :pw]
        return np.clip(big + rng.integers(-6, 7, (ph, pw)), 0,
                       255).astype(np.uint8)

    if kind == "gray":
        return {"y": plane(h, w)}
    ch, cw = {"420": (h // 2, w // 2), "422": (h, w // 2),
              "444": (h, w)}[kind]
    return {"y": plane(h, w), "u": plane(ch, cw), "v": plane(ch, cw)}


KINDS = ["gray", "420", "422", "444"]


@pytest.mark.parametrize("with_icc", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_jpeg_bytes_identical_to_jax(kind, with_icc):
    h, w = 37, 58
    planes = _planes(kind, h, w, seed=len(kind) + with_icc)
    jicc_b = jicc.write_icc_profile("srgb", "p3") if with_icc else None
    ticc_b = ticc.write_icc_profile("srgb", "p3") if with_icc else None
    assert jicc_b == ticc_b
    want = jcodec.encode_jpeg(planes, quality=83, icc=jicc_b)
    calls = tcodec.entropy_encode.calls
    got = tcodec.encode_jpeg(planes, quality=83, icc=ticc_b, device="cpu")
    assert got == want
    assert tcodec.entropy_encode.calls - calls == 0
    # Tensor planes encode on their own device to the same bytes.
    tensors = {k: torch.from_numpy(p) for k, p in planes.items()}
    assert tcodec.encode_jpeg(tensors, quality=83, icc=ticc_b) == want


def _assert_planes_equal(got, want):
    assert (got.width, got.height, got.ncomp) == (want.width, want.height,
                                                   want.ncomp)
    assert got.sampling == want.sampling
    assert (got.icc, got.exif, got.xmp) == (want.icc, want.exif, want.xmp)
    assert len(got.planes) == len(want.planes)
    for g, w in zip(got.planes, want.planes):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_jpeg_planes_equal_jax(kind, restart):
    """Streams of the JAX encoder, restart-less or with a restart marker
    every 3 MCUs, decode on the port's device route."""
    planes = _planes(kind, 44, 61, seed=10 + len(kind))
    data = jcodec.encode_jpeg(planes, quality=90, restart_interval=restart,
                              icc=jicc.write_icc_profile("srgb", "bt709"))
    ds = dd.parse_device_stream(data)
    assert ds is not None and (ds.start_bits is None) == bool(restart)
    _assert_planes_equal(tcodec.decode_jpeg(data, "cpu"),
                         jcodec.decode_jpeg(data))


def test_decode_jpeg_host_route_planes_equal_jax():
    """A gray frame whose SOF gives its one component 2x2 sampling: the
    device decoder does not take it, the host Huffman route does (one
    block per MCU, as T.81 codes a single-component scan)."""
    data = bytearray(jcodec.encode_jpeg(_planes("gray", 40, 48, seed=3),
                                        quality=75))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x11
    data[sof + 11] = 0x22
    data = bytes(data)
    assert dd.parse_device_stream(data) is None
    calls = tcodec.entropy_decode.calls
    _assert_planes_equal(tcodec.decode_jpeg(data, "cpu"),
                         jcodec.decode_jpeg(data))
    assert tcodec.entropy_decode.calls - calls == 1


def test_encode_jpeg_unported_options_raise():
    """The options once queued now encode to the JAX package's bytes:
    arithmetic coding (SOF9, the QM coder on the host), with and without
    restart intervals, and a restart interval (B12-enc's plain version);
    an inconsistent sampling still raises INVALID_PARAM."""
    planes = _planes("420", 16, 16, seed=1)
    for r in (0, 4):
        assert tcodec.encode_jpeg(planes, quality=90, device="cpu",
                                  restart_interval=r, arithmetic=True) == \
            jcodec.encode_jpeg(planes, quality=90, restart_interval=r,
                               arithmetic=True)
    assert tcodec.encode_jpeg(planes, quality=90, device="cpu",
                              restart_interval=4) == jcodec.encode_jpeg(
        planes, quality=90, restart_interval=4)
    with pytest.raises(UhdrError, match="INVALID_PARAM"):
        tcodec.encode_jpeg(planes, quality=90, sampling=(1, 1),
                           device="cpu")
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else UhdrError):
        tcodec.decode_jpeg(b"\xff\xd8\xff\xd9")
