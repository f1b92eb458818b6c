"""The port's command-line tool (libultrahdr_dev_tpu_torch/cli.py) against
the JAX package's (libultrahdr_dev_tpu/cli.py), on the CPU: the same
flags on the same tiny P010 file give identical files, the JPEG/R of an
encode and the raw pixels of its decodes to HLG RGBA1010102, linear RGBA
F16 and sRGB RGBA8888 (the decode reads the pixels back through the
packed readback, fetch_pixels_packed, and gives what a raw copy gives)."""

import os

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu import cli as jcli
from libultrahdr_dev_tpu_torch import cli as tcli, serving
from libultrahdr_dev_tpu_torch.api import UhdrDecoder
from libultrahdr_dev_tpu_torch.parallel import link
from libultrahdr_dev_tpu_torch.types import ColorTransfer, PixelFormat

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 96, 128
# (-o transfer, -O format) of the decodes compared.
DECODES = {"hlg_1010102": (1, 5), "linear_f16": (0, 4), "srgb_8888": (3, 3)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both tools' encode of one P010 file at quality 95, then each
    decode: {(tool, name): path}."""
    d = tmp_path_factory.mktemp("cli")
    y, uv = serving.synth_p010(1, H, W, seed=3)
    src = str(d / "in.p010")
    np.concatenate([y[0].ravel(), uv[0].ravel()]).tofile(src)
    out = {}
    for tool, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--cpu"])):
        enc = str(d / f"{tool}.jpg")
        assert main(["-m", "0", "-p", src, "-w", str(W), "-h", str(H),
                     "-C", "2", "-t", "1", "-q", "95", "-z", enc]
                    + extra) == 0
        out[(tool, "jpegr")] = enc
        for name, (o, fmt) in DECODES.items():
            raw = str(d / f"{tool}_{name}.raw")
            assert main(["-m", "1", "-j", enc, "-o", str(o), "-O", str(fmt),
                         "-z", raw] + extra) == 0
            out[(tool, name)] = raw
    return out


@pytest.mark.parametrize("name", ["jpegr"] + list(DECODES))
def test_cli_files_equal_jax(files, name):
    with open(files[("port", name)], "rb") as f:
        got = f.read()
    with open(files[("jax", name)], "rb") as f:
        want = f.read()
    assert len(got) > 0 and got == want


@pytest.mark.parametrize("fmt,ct", [
    (PixelFormat.RGBA1010102, ColorTransfer.HLG),
    (PixelFormat.RGBA_F16, ColorTransfer.LINEAR)])
def test_decode_pixels_stay_on_the_device_for_the_packed_read(tmp_path,
                                                              fmt, ct):
    """UhdrDecoder(pixels_on_device=True) leaves a tensor; its packed
    readback (of a 256x512 frame, where both packs pay) equals the raw
    copy and the default decoder's numpy."""
    y, uv = serving.synth_p010(1, 256, 512, seed=4)
    src, enc = str(tmp_path / "in.p010"), str(tmp_path / "out.jpg")
    np.concatenate([y[0].ravel(), uv[0].ravel()]).tofile(src)
    assert tcli.main(["-m", "0", "-p", src, "-w", "512", "-h", "256", "-C",
                      "2", "-q", "95", "-z", enc, "--cpu"]) == 0
    with open(enc, "rb") as f:
        data = f.read()
    dec = UhdrDecoder("cpu", pixels_on_device=True)
    dec.set_image(data)
    dec.set_out_img_format(fmt)
    dec.set_out_color_transfer(ct)
    t = dec.decode().planes["rgba"]
    assert isinstance(t, torch.Tensor)
    stats = {}
    got = link.fetch_pixels_packed(t, stats, fmt=fmt)
    assert stats["d2h_pack"] != "raw"
    ref = UhdrDecoder("cpu")
    ref.set_image(data)
    ref.set_out_img_format(fmt)
    ref.set_out_color_transfer(ct)
    want = ref.decode().planes["rgba"]
    assert isinstance(want, np.ndarray) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(got, t.numpy().view(want.dtype))


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.p010"
    np.zeros(64 * 64 * 3 // 2, np.uint16).tofile(src)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-m", "0", "-p", str(src), "-w", "64", "-h", "64",
                   "-z", os.devnull])
