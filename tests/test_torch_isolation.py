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
        from libultrahdr_dev_tpu_torch.container import mux
        f = batched.decode_host_huffman(
            mux.read_primary_and_gainmap(blob))   # builds entropy.cpp
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


def _launch_sites():
    """Across the port's modules (kernels/build.py aside): the uses of
    the kernels' ctypes handle or of a stream outside the launch helper,
    and the entry-point names given to build.launch and build.host_call."""
    import ast

    direct, launched, queried = [], set(), set()
    for d, _, names in os.walk(PORT):
        for n in names:
            path = os.path.join(d, n)
            if not n.endswith(".py") or path.endswith(
                    os.path.join("kernels", "build.py")):
                continue
            rel = os.path.relpath(path, ROOT)
            for node in ast.walk(ast.parse(open(path).read())):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "build"
                        and node.attr in ("get_lib", "_lib", "stream_of",
                                          "check")):
                    direct.append(f"{rel}:{node.lineno} build.{node.attr}")
                if (isinstance(node, ast.ImportFrom)
                        and (node.module or "").endswith("build")
                        and any(a.name in ("get_lib", "_lib", "stream_of",
                                           "check") for a in node.names)):
                    direct.append(f"{rel}:{node.lineno} imports from build")
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "build"
                        and node.func.attr in ("launch", "host_call")):
                    arg = node.args[1 if node.func.attr == "launch" else 0]
                    assert isinstance(arg, ast.Constant), \
                        f"{rel}:{node.lineno}: name the entry point literally"
                    (launched if node.func.attr == "launch"
                     else queried).add(arg.value)
    return direct, launched, queried


def test_every_launch_goes_through_the_device_guard():
    """No module of the port calls a C entry point of the kernels except
    through kernels/build.py:launch (which makes the tensor's device
    current and passes that device's stream) or, for the two host-only
    size queries, build.host_call; and every entry point that takes a
    stream is launched that way somewhere. A launch added later without
    the guard fails here even where no second GPU could show it."""
    import ctypes

    from libultrahdr_dev_tpu_torch.kernels import build

    direct, launched, queried = _launch_sites()
    assert direct == []
    host_only = {n for n, a in build.SIGNATURES.items()
                 if not a or a[-1] is not ctypes.c_void_p}
    assert host_only == {"uhdr_huff_lookup_bytes", "uhdr_rice_order_scratch"}
    assert queried == host_only
    assert launched == set(build.SIGNATURES) - host_only


def test_launch_makes_the_tensor_device_current(monkeypatch):
    """build.launch enters the tensor's device (unless it is current),
    calls the entry point with that device's current stream last, leaves
    the device, and raises on a non-zero return code."""
    import contextlib
    import types

    import pytest
    import torch

    from libultrahdr_dev_tpu_torch.kernels import build

    events = []

    @contextlib.contextmanager
    def device(d):
        events.append(("enter", torch.device(d)))
        yield
        events.append(("exit", torch.device(d)))

    def current_stream(d=None):
        events.append(("stream", d))
        return types.SimpleNamespace(cuda_stream=77)

    class Lib:
        rc = 0

        def uhdr_x(self, *args):
            events.append(("call", args))
            return self.rc

    lib = Lib()
    current = [0]
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(build, "get_lib", lambda: lib)
    monkeypatch.setattr(build, "_lib", lib)
    cuda3 = torch.device("cuda", 3)
    t = types.SimpleNamespace(device=cuda3)
    build.launch(t, "uhdr_x", 1, 2.5)
    assert events == [("enter", cuda3), ("stream", cuda3),
                      ("call", (1, 2.5, 77)), ("exit", cuda3)]
    # Its device already current: nothing to switch.
    events.clear()
    current[0] = 3
    build.launch(t, "uhdr_x", 4)
    assert events == [("stream", cuda3), ("call", (4, 77))]
    lib.rc = 700
    with pytest.raises(RuntimeError, match="uhdr_x: CUDA error 700"):
        build.launch(t, "uhdr_x")
