"""The judge passes the program and fails its control and its faults.

On the CPU at small sizes, with the program's plain versions: the
reference agrees with what the program writes, and with what it decodes
from the reference's own files; the control (the reference computed in
bfloat16 in the program's place) fails a limit; and whole runs of each
cell with the timed path broken underneath (an answer altered where it
is produced, half of a batch left out) come out not correct."""

import os

import numpy as np
import pytest
import torch

from portbench import content, harness, judge
from portbench.reference import writer

CONFIGS = {"hlg": ("bt2100", "hlg"), "pq": ("p3", "pq")}
W, H = 256, 128


def _cfg(tf):
    gamut, transfer = CONFIGS[tf]
    return dict(width=W, height=H, gamut=gamut, transfer=transfer,
                quality=95, gainmap_quality=85)


def _blobs(port, cfg, seed):
    """Two seeded frames and the program's JPEG/R of each."""
    y, uv = content.pool(H, W, 2, seed)
    return y, uv, port.batched.batched_encode_api0(
        y, uv, cfg["gamut"], cfg["transfer"], cfg["quality"], device="cpu")


def _files(cfg, seed):
    """The reference's JPEG/R of two seeded frames."""
    y, uv = content.pool(H, W, 2, seed)
    return [writer.encode_jpegr(cfg, y[i], uv[i], "cpu") for i in range(2)]


@pytest.fixture(scope="module")
def port():
    return harness.import_port()


@pytest.mark.parametrize("tf", ["hlg", "pq"])
def test_encode_control_fails_and_the_program_passes(port, tf):
    cfg = _cfg(tf)
    y, uv, blobs = _blobs(port, cfg, 2**31 + 21)
    lim = judge.FILE_LIMITS
    sound = judge.worst([judge.encode_numbers(cfg, b, y[i], uv[i], "cpu")
                         for i, b in enumerate(blobs)], lim)
    control = judge.worst([judge.control_encode_numbers(cfg, y[i], uv[i],
                                                        "cpu")
                           for i in range(len(blobs))], lim)
    assert judge.verdict(lim, sound)[0], sound
    assert not judge.verdict(lim, control)[0], control


@pytest.mark.parametrize("tf", ["hlg", "pq"])
def test_decode_control_fails_and_the_program_passes(port, tf):
    cfg = _cfg(tf)
    blobs = _files(cfg, 2**31 + 22)
    got = port.batched.batched_decode(blobs, f"hdr_{tf}", device="cpu")
    sound, control = [], []
    for i, b in enumerate(blobs):
        faults, want = judge.expected_pixels(cfg, b, "cpu")
        assert not faults
        sound.append(judge.pixel_numbers(got[i], want))
        _, low = judge.expected_pixels(cfg, b, "cpu", torch.bfloat16)
        control.append(judge.pixel_numbers(low, want))
    lim = judge.WORDS_LIMITS
    assert judge.verdict(lim, judge.worst(sound, lim))[0]
    assert not judge.verdict(lim, judge.worst(control, lim))[0]


def _not_correct(name, seed, port) -> bool:
    """A run with the fault planted is not correct: it says so, or (where
    the fault leaves a batch of one empty) it stops before its result."""
    try:
        line = harness.run_cell(name, seed, 0.3, False, "cpu",
                                cell=_tiny(name), port=port)
    except Exception:  # a run that stops prints no result: not correct
        return True
    return line["attempted"] > 0 and not line["correct"]


# Every cell, in BENCHMARK.json or with its files in place for a later
# PR (PERF.md, Open questions): its configuration and traffic mix.
CELLS = {"12mp-hlg.encode": ("uhdr-12mp-bt2100-hlg", "encode-batched"),
         "3mp-pq.encode": ("uhdr-3mp-p3-pq", "encode-api"),
         "12mp-hlg.decode": ("uhdr-12mp-bt2100-hlg", "decode-api-host"),
         "12mp-hlg.decode-device": ("uhdr-12mp-bt2100-hlg",
                                    "decode-batched-device-4"),
         "3mp-pq.decode": ("uhdr-3mp-p3-pq", "decode-batched-device")}


def _cell(name):
    conf, mix = CELLS[name]
    here = harness.HERE
    return harness.Cell(
        {"name": name, "config": conf, "traffic": mix, "chips": 1},
        harness.load_json(os.path.join(here, "configs", conf + ".json")),
        harness.load_json(os.path.join(here, "traffic", mix + ".json")),
        [], [])


def test_every_cell_of_the_benchmark_is_tested_here():
    for w in harness.load_json(os.path.join(harness.ROOT,
                                            "BENCHMARK.json"))["workloads"]:
        assert CELLS[w["name"]] == (w["config"], w["traffic"])


def _tiny(name):
    cell = _cell(name)
    cell.config.update(width=128, height=64)
    cell.mix.update(pool_frames=cell.mix["batch"] * 2, judge_frames=2)
    return cell


def _alter_stream(blob: bytes) -> bytes:
    """A byte in the middle of the base image's entropy-coded data
    changed (neither a marker nor a stuffed byte)."""
    b = bytearray(blob)
    sos = bytes(b).index(b"\xff\xda")
    end = bytes(b).index(b"\xff\xd9", sos)
    i = (sos + end) // 2
    while b[i] == 0xFF or b[i - 1] == 0xFF or b[i] ^ 0x5A == 0xFF:
        i += 1
    b[i] ^= 0x5A
    return bytes(b)


ENCODES = [n for n, (_, mix) in CELLS.items() if mix.startswith("encode")]
DECODES = [n for n, (_, mix) in CELLS.items() if mix.startswith("decode")]


@pytest.mark.parametrize("name", ENCODES)
def test_an_encoded_answer_altered_is_not_correct(port, monkeypatch, name):
    orig = port.batched.assemble_api0

    def altered(*a, **k):
        blobs, bb, gb = orig(*a, **k)
        return [_alter_stream(x) for x in blobs], bb, gb

    monkeypatch.setattr(port.batched, "assemble_api0", altered)
    line = harness.run_cell(name, 31, 0.3, False, "cpu", cell=_tiny(name),
                            port=port)
    assert line["attempted"] and not line["correct"]


@pytest.mark.parametrize("name", ENCODES)
def test_half_an_encode_batch_left_out_is_not_correct(port, monkeypatch,
                                                      name):
    orig = port.batched.batched_encode_api0

    def half(y, uv, *a, **k):
        return orig(y[: max(len(y) // 2, 1)], uv[: max(len(y) // 2, 1)],
                    *a, **k)[: len(y) // 2]

    monkeypatch.setattr(port.batched, "batched_encode_api0", half)
    assert _not_correct(name, 32, port)


@pytest.mark.parametrize("name", DECODES)
def test_decoded_pixels_altered_are_not_correct(port, monkeypatch, name):
    orig = port.batched.decode_device_stage

    def altered(frames, *a, **k):
        out = orig(frames, *a, **k).clone()
        out[:, : out.shape[1] // 4] ^= 0x155
        return out

    monkeypatch.setattr(port.batched, "decode_device_stage", altered)
    line = harness.run_cell(name, 33, 0.3, False, "cpu", cell=_tiny(name),
                            port=port)
    assert line["attempted"] and not line["correct"]
    assert line["checks"]["px_off"]["value"] > 0.05


@pytest.mark.parametrize("name", DECODES)
def test_half_a_decode_batch_left_out_is_not_correct(port, monkeypatch,
                                                     name):
    orig = port.batched.decode_device_stage

    def half(frames, *a, **k):
        return orig(frames, *a, **k)[: len(frames) // 2]

    monkeypatch.setattr(port.batched, "decode_device_stage", half)
    assert _not_correct(name, 34, port)


def test_a_sound_run_of_each_cell_is_correct(port):
    for name in ENCODES + DECODES:
        line = harness.run_cell(name, 35, 0.3, False, "cpu",
                                cell=_tiny(name), port=port)
        assert line["correct"], (name, line["checks"])
        assert np.isfinite(line["checks"]["faults"]["value"])
