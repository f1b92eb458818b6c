"""The port's EOI search (libultrahdr_dev_tpu_torch/jpeg/headers.py
find_eoi_marker, one native pass of jpeg/entropy.cpp uhdr_find_eoi)
against Python's bytes.find(b"\\xff\\xd9", start) as the plain model, on
random buffers at several FF densities and on hand-made edges; and the
split and the marker walk that use it against their bytes.find form, on
the port's own JPEG/R files."""

import dataclasses

import numpy as np
import pytest

from libultrahdr_dev_tpu_torch import (ColorGamut, ColorTransfer, JpegR,
                                       PixelFormat, RawImage)
from libultrahdr_dev_tpu_torch.container import jfif, mux
from libultrahdr_dev_tpu_torch.jpeg import device_decode as tdd, headers
from libultrahdr_dev_tpu_torch.parallel import batched

import test_torch_threads  # noqa: F401  (caps torch's threads)


def _plain(data, start):
    return bytes(data).find(b"\xff\xd9", start)


def _random(density, seed):
    """A buffer of 1-5 kB whose bytes are FF with the given probability;
    a seed of its own sets its length, so the tail's length varies."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1000, 5000))
    b = rng.integers(0, 255, n, dtype=np.uint8)   # never FF
    b[rng.random(n) < density] = 0xFF
    return b.tobytes()


def _at(offset):
    b = bytearray(48)
    b[offset:offset + 2] = b"\xff\xd9"
    return bytes(b)


CASES = {
    **{f"density_{name}_{seed}": _random(d, 1000 * i + seed)
       for i, (name, d) in enumerate((("0", 0.0), ("1in256", 1 / 256),
                                      ("1in14", 1 / 14), ("1in2", 0.5)))
       for seed in range(3)},
    **{f"at_{k}": _at(k) for k in range(41)},
    "empty": b"",
    "lone_ff": b"\xff",
    "ff_d9_only": b"\xff\xd9",
    "fill_runs": b"\x12\xff\xff\xd9" * 9 + b"\xff" * 40 + b"\xff\xd9",
    "lone_ff_last": bytes(range(0x40, 0x80)) + b"\xff",
    "ff_d9_last_two": bytes(range(0x40, 0x80)) + b"\xff\xd9",
    "ff_then_d9_split": b"\xff" * 16 + b"\x00\xd9" * 16 + b"\xff",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_find_eoi_marker_as_bytes_find(name):
    data = CASES[name]
    n = len(data)
    hits = [i for i in range(n - 1) if data[i:i + 2] == b"\xff\xd9"]
    starts = {0, 1, n - 1, n, n + 5, n // 2}
    for h in hits[:8]:
        starts |= {max(h - 1, 0), h, h + 1}
    for buf in (data, bytearray(data)):
        for start in sorted(starts):
            assert headers.find_eoi_marker(buf, start) == _plain(
                data, start), \
                (type(buf).__name__, start)


def _content(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 200 + 300 * (np.sin(xx / 7.0) * np.cos(yy / 5.0) + 1)
    y = np.clip(y + rng.normal(0, 60, (h, w)), 64, 940).astype(np.uint16)
    uv = rng.integers(300, 724, (h // 2, w), dtype=np.uint16)
    return y << 6, uv << 6


def _files():
    h, w = 96, 128
    y, uv = _content(h, w, 11)
    raw = RawImage(fmt=PixelFormat.P010, width=w, height=h,
                   gamut=ColorGamut.BT2100, planes={"y": y, "uv": uv})
    api = JpegR("cpu").encode_api0(raw, ColorTransfer.HLG)
    ys, uvs = zip(*(_content(h, w, 20 + i) for i in range(2)))
    blobs = batched.batched_encode_api0(np.stack(ys), np.stack(uvs),
                                        "bt2100", "hlg", 95, device="cpu")
    own = bytes(blobs[0])
    return {"api0": api, "batched": own,
            "trailing": own + b"\x00\xff\xd9\xff\xd8junk\xff\xd9",
            "truncated": own[:-2]}


def _same(a, b):
    """Equal values, numpy arrays and dataclasses compared inside."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same, a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.fixture(scope="module")
def files():
    return _files()


def test_split_and_marker_walk_as_bytes_find(files, monkeypatch):
    native = {}
    for name, blob in files.items():
        for buf in (blob, bytearray(blob)):
            ranges = jfif.find_image_ranges(buf)
            pair = mux.extract_primary_and_gainmap(buf)
            heads = [tdd.parse_device_headers(headers.read_headers(p))
                 for p in pair]
            native[name, type(buf)] = ranges, pair, heads
    calls = []

    def plain(data, start=0):
        calls.append(start)
        return _plain(data, start)

    monkeypatch.setattr(headers, "find_eoi_marker", plain)
    for (name, kind), (ranges, pair, heads) in native.items():
        blob = kind(files[name])
        assert jfif.find_image_ranges(blob) == ranges, name
        assert mux.extract_primary_and_gainmap(blob) == pair, name
        n = len(calls)
        want = [tdd.parse_device_headers(headers.read_headers(p))
                for p in pair]
        assert len(calls) == n + 2   # both walks searched
        assert heads[0] is not None and heads[0].entropy, name
        assert _same(heads, want), name
    assert native["trailing", bytes][1] == native["batched", bytes][1]
