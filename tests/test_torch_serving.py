"""The port's serving loop (libultrahdr_dev_tpu_torch/serving.py) and
its encode from device input, on the CPU: batched_encode_api0 from a
packed upload gives the bytes of the host-input encode; two rounds of
the loop give the JAX package's host-apply pixels of the same frames;
with --no-hostapply the packed pixel readback gives the device's pixels
bitwise and the JAX package's --no-hostapply pixels (HLG bitwise, F16
within B6's 1 ULP); the command line runs; a copy of the port's package
alone (no JAX
importable, no JAX file beside it) builds its own packio.cpp and
apply.cpp and serves; the new entry points default to CUDA."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.parallel import packio as jpackio, sharding
from libultrahdr_dev_tpu_torch import serving
from libultrahdr_dev_tpu_torch.parallel import batched, link, packio

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "libultrahdr_dev_tpu_torch")


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    for mod in (packio, jpackio):
        monkeypatch.setattr(mod, "_PLAN_CACHE", {})
        monkeypatch.setattr(mod, "_BPS", {})
    monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
    monkeypatch.delenv("UHDR_FUSED_FETCH", raising=False)


@pytest.mark.parametrize("noise,mode", [(False, "seg"), (True, "dense")])
def test_device_input_encode_equals_host_input(noise, mode):
    n, h, w = 2, 256, 512
    quality = 100 if noise else 95
    if noise:
        rng = np.random.default_rng(1)
        ys = rng.integers(64, 940, (n, h, w)).astype(np.uint16) << 6
        uvs = rng.integers(64, 960, (n, h // 2, w)).astype(np.uint16) << 6
    else:
        ys, uvs = serving.synth_p010(n, h, w, seed=2)
    stats = {}
    dev_in = link.upload_p010_batch(ys, uvs, stats, device="cpu")[:2]
    got, hand = batched.batched_encode_api0(
        None, None, quality=quality, device_input=dev_in,
        return_handoff=True, stats=stats)
    host_stats = {}
    want = batched.batched_encode_api0(ys, uvs, quality=quality,
                                       device="cpu", stats=host_stats)
    assert got == want
    assert stats["h2d_pack"] == mode
    assert host_stats["h2d_pack"] == "u16"
    assert host_stats["h2d_bytes"] == ys.nbytes + uvs.nbytes
    # Noise at quality 100 is dense content: restart-less, no handoff,
    # and no stream copy counted.
    assert (hand is None) == noise
    assert stats.get("d2h_bytes", 0) == host_stats.get("d2h_bytes", 0)
    assert (stats.get("d2h_bytes", 0) > 0) != noise


@pytest.mark.parametrize("f16", [False, True])
def test_two_rounds_give_jax_hostapply_pixels(f16):
    """serving.py --cpu --height 64 --width 96 (--f16), two rounds."""
    lines = []
    res = serving.run(height=64, width=96, rounds=2, f16=f16, device="cpu",
                      log=lines.append)
    ys, uvs = serving.synth_p010(4, 64, 96)
    mesh = sharding.single_device_mesh()
    jblobs, jhand = sharding.batched_encode_api0(ys, uvs, mesh,
                                                 return_handoff=True)
    fmt = "hdr_linear" if f16 else "hdr_hlg"
    want = sharding.decode_batch_hostapply(None, fmt, serving.BOOST, mesh,
                                           handoff=jhand)
    assert res.blobs == jblobs
    assert res.pixels.dtype == want.dtype and np.array_equal(res.pixels,
                                                             want)
    assert np.array_equal(res.comp, res.comp_dev.numpy())
    assert len(res.stats) == 2 and len(res.intervals_ms) == 1
    assert all(s["h2d_pack"] in ("seg", "dense") for s in res.stats)
    assert [ln.split(":")[0] for ln in lines] == [
        "round 0", "round 1", "steady-state cadence"]


@pytest.mark.parametrize("f16", [False, True])
def test_no_hostapply_rounds_give_jax_device_pixels(f16):
    """serving.py --cpu --no-hostapply --height 128 --width 256 (--f16),
    two rounds: the device applies the gain map and the pixels come back
    through the packed readback, bitwise the device's. Against JAX's
    --no-hostapply loop (examples/serving_loop.py:55-90: the handoff
    decode to pixels, then sharding.fetch_*_packed): HLG bitwise, F16
    within 1 ULP (the B6 bound of tests/test_torch_jpegr.py)."""
    res = serving.run(height=128, width=256, rounds=2, f16=f16,
                      device="cpu", log=lambda s: None, hostapply=False)
    dtype = np.uint16 if f16 else np.uint32
    assert res.pixels.dtype == dtype
    assert np.array_equal(res.pixels, res.comp_dev.numpy().view(dtype))
    assert res.scalars is None and res.comp is res.pixels
    packed = "rct-rice16-auto" if f16 else "rct-rice-auto"
    assert all(s["d2h_pack"].startswith(packed) for s in res.stats)
    assert all(s["d2h_bytes"] < res.pixels.nbytes for s in res.stats)
    ys, uvs = serving.synth_p010(4, 128, 256)
    mesh = sharding.single_device_mesh()
    jblobs, jhand = sharding.batched_encode_api0(ys, uvs, mesh,
                                                 return_handoff=True)
    fmt = "hdr_linear" if f16 else "hdr_hlg"
    out = sharding.batched_decode_from_handoff(jhand, fmt, serving.BOOST,
                                               mesh)
    want = (sharding.fetch_f16_packed if f16
            else sharding.fetch_1010102_packed)(out)
    assert res.blobs == jblobs and want.dtype == dtype
    d = np.abs(res.pixels.astype(np.int64) - want.astype(np.int64))
    assert int(d.max()) == 0 or (f16 and int(d.max()) <= 1)


def test_cli_runs_on_the_cpu(capsys):
    assert serving.main(["--cpu", "--height", "64", "--width", "96",
                         "--rounds", "3", "--batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("round 0: (2, 64, 96) pixels ready, ")
    assert out[0].endswith(" B/JPEG-R")
    assert out[-1].startswith("steady-state cadence:")


def test_lone_copy_of_the_package_serves_without_jax(tmp_path):
    shutil.copytree(PORT, tmp_path / "libultrahdr_dev_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["libultrahdr_dev_tpu"] = None
        from libultrahdr_dev_tpu_torch import serving
        from libultrahdr_dev_tpu_torch.jpeg import native
        assert native.PACKIO_SRC.startswith(sys.argv[1])
        assert native.APPLY_SRC.startswith(sys.argv[1])
        res = serving.run(batch=2, height=64, width=96, rounds=2,
                          device="cpu", log=lambda s: None)
        assert res.pixels.shape == (2, 64, 96)
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    build = tmp_path / "libultrahdr_dev_tpu_torch" / "_build"
    assert list(build.glob("packio-*.so")) and list(build.glob("apply-*.so"))


def test_cli_no_hostapply_runs_on_the_cpu(capsys):
    assert serving.main(["--cpu", "--height", "64", "--width", "96",
                         "--rounds", "2", "--batch", "2",
                         "--no-hostapply"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("round 0: (2, 64, 96) pixels ready, ")
    assert out[-1].startswith("steady-state cadence:")


def test_new_entry_points_default_to_cuda():
    y = np.zeros((1, 64, 64), np.uint16)
    uv = np.zeros((1, 32, 64), np.uint16)
    calls = [lambda: link.upload_p010_batch(y, uv),
             lambda: link.decode_batch_hostapply([b""], "hdr_hlg", 4.0),
             lambda: serving.run(height=64, width=96, rounds=1),
             lambda: serving.main(["--height", "64", "--width", "96"])]
    if torch.cuda.is_available():
        assert link.upload_p010_batch(y, uv)[0].is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
