"""The port imports neither JAX nor the JAX package: a process where
``import jax`` fails can import it and run an API-0 round trip, and no
source of the port (nor chip_smoke.py) has such an import."""

import os
import re
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
        blob = P.JpegR().encode_api0(raw, P.ColorTransfer.HLG)
        img = P.JpegR().decode(blob, P.OutputFormat.HDR_HLG).image
        assert img.planes["rgba"].shape == (64, 64)
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
