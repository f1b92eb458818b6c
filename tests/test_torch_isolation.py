"""The port imports neither JAX nor the JAX package: a process where
``import jax`` fails can import it and run an API-0 round trip, no
source of the port (nor chip_smoke.py) has such an import, and a copy
of the port's package alone runs, so it reads no file of the JAX
package either. Its entry points run on CUDA unless told otherwise."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "libultrahdr_dev_tpu_torch")
_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|libultrahdr_dev_tpu)(\.|\s|$)", re.M)


def test_round_trip_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["libultrahdr_dev_tpu"] = None
        import numpy as np
        import libultrahdr_dev_tpu_torch as P
        y = np.full((64, 64), 500 << 6, np.uint16)
        y[16:48, 16:48] = 900 << 6
        uv = np.full((32, 64), 512 << 6, np.uint16)
        raw = P.RawImage(fmt=P.PixelFormat.P010, width=64, height=64,
                         gamut=P.ColorGamut.BT2100,
                         planes={"y": y, "uv": uv})
        blob = P.JpegR("cpu").encode_api0(raw, P.ColorTransfer.HLG)
        img = P.JpegR("cpu").decode(blob, P.OutputFormat.HDR_HLG).image
        assert img.planes["rgba"].shape == (64, 64)
        # The general route (EXIF: B10a-c, encode_jpeg) and decode_jpeg.
        from libultrahdr_dev_tpu_torch import device
        from libultrahdr_dev_tpu_torch.jpeg import codec
        gen = P.JpegR("cpu").encode_api0(raw, P.ColorTransfer.HLG,
                                         exif=b"Exif\\x00\\x00")
        base = P.container.mux.extract_primary_and_gainmap(gen)[0]
        assert codec.decode_jpeg(base, "cpu").planes[1].shape == (32, 32)
        assert device.resolve_device("cpu").type == "cpu"
        # The converter session (decode, B13 effects, API-x encode).
        out = P.UltraHdr("cpu").add_image(blob).convert(P.UltraHdrConfig(
            "jpeg_r", effects=[P.RotateEffect(90)]))
        assert P.JpegR("cpu").get_info(out).gainmap_height == 16
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = [f for f in files if _IMPORT.search(open(f).read())]
    assert offenders == []


def test_round_trip_from_a_lone_copy_of_the_package(tmp_path):
    """The port's package copied alone (no JAX package beside it, no
    build from elsewhere) builds its own host codecs from its own
    entropy.cpp and arith.cpp and runs an API-0 round trip and an
    arithmetic-coded JPEG round trip on the CPU."""
    shutil.copytree(PORT, tmp_path / "libultrahdr_dev_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["libultrahdr_dev_tpu"] = None
        import numpy as np
        import libultrahdr_dev_tpu_torch as P
        from libultrahdr_dev_tpu_torch.jpeg import codec, native
        assert native.SRC.startswith(sys.argv[1]), native.SRC
        y = np.full((32, 48), 600 << 6, np.uint16)
        y[8:24, 16:40] = 880 << 6
        uv = np.full((16, 48), 500 << 6, np.uint16)
        raw = P.RawImage(fmt=P.PixelFormat.P010, width=48, height=32,
                         gamut=P.ColorGamut.BT709,
                         planes={"y": y, "uv": uv})
        blob = P.JpegR("cpu").encode_api0(raw, P.ColorTransfer.PQ)
        img = P.JpegR("cpu").decode(blob, P.OutputFormat.HDR_PQ).image
        assert img.planes["rgba"].shape == (32, 48)
        assert codec.entropy_decode.calls == 0
        from libultrahdr_dev_tpu_torch.parallel import batched
        f = batched.decode_host_huffman(blob)   # builds entropy.cpp
        assert f.grids is not None
        # The arithmetic codec (builds arith.cpp) and its SOF9 decode.
        g = (np.arange(32 * 48) % 251).astype(np.uint8).reshape(32, 48)
        a = codec.encode_jpeg({"y": g}, 90, arithmetic=True, device="cpu")
        assert codec.decode_jpeg(a, "cpu").planes[0].shape == (32, 48)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for stem in ("entropy", "arith"):
        assert list((tmp_path / "libultrahdr_dev_tpu_torch" / "_build").glob(
            f"{stem}-*.so"))


def test_entry_points_default_to_cuda():
    """Without a device argument every entry point selects CUDA: on a
    machine without one it raises instead of running on the CPU."""
    import numpy as np
    import pytest
    import torch

    from libultrahdr_dev_tpu_torch import (JpegR, UhdrDecoder, UhdrEncoder,
                                           UltraHdr)
    from libultrahdr_dev_tpu_torch.parallel import batched

    y = np.zeros((1, 16, 16), np.uint16)
    uv = np.zeros((1, 8, 16), np.uint16)
    sdr = (np.zeros((1, 16, 16), np.uint8), np.zeros((1, 8, 8), np.uint8),
           np.zeros((1, 8, 8), np.uint8))
    calls = [JpegR, UhdrEncoder, UhdrDecoder, UltraHdr,
             lambda: batched.batched_encode_api0(y, uv),
             lambda: batched.batched_encode_api1(y, uv, *sdr),
             lambda: batched.batched_encode_device_stage(y, uv),
             lambda: batched.batched_decode([b""]),
             lambda: batched.batched_decode([b""], "sdr", use_luts=True)]
    if torch.cuda.is_available():
        assert JpegR().device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
