"""BENCHMARK.json against the contract it is written to, and the harness
finding every cell, configuration, mix and metric by name alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import drive, harness, tracing

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in b[k]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"], b)
        assert issubclass(harness.entry_class(cell.mix["entry"]),
                          drive.Entry)
        assert {m["name"] for m in cell.end_to_end} >= {
            "setup_s", "frames_per_s", "latency_p95_ms"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        conf = [c for c in b["configs"] if c["name"] == w["config"]][0]
        assert cell.config["source"] == conf["source"]
        assert cell.config["reduced"] == conf["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_every_mix_names_an_entry_and_every_probe_a_function():
    port = harness.import_port()
    for f in sorted(os.listdir(os.path.join(HERE, "traffic"))):
        mix = harness.load_json(os.path.join(HERE, "traffic", f))
        entry = harness.entry_class(mix["entry"])
        assert entry.output == mix["output"] and entry.limits
        probes = list(entry.probes)
        for m in os.listdir(os.path.join(HERE, "metrics")):
            probes += harness.metric_probes(m[:-3])
        spans = tracing.Spans()
        names, restore = harness.wrap_probes(probes, spans)
        restore()
        assert names
    assert port.batched.decode_host_stage.__name__ == "decode_host_stage"


ENTRY = """
from portbench.tracing import Probe

from .batched_encode_api0 import Entry as Base


class Entry(Base):
    probes = Base.probes + (Probe("encode_device_stage", "parallel.batched",
                                  "encode_coefs_stage"),)
"""


def test_a_cell_added_as_files_and_an_entry_is_found(tmp_path):
    """A later cell: a new entry point, mix, configuration and metric
    with a probe of its own, as files and BENCHMARK.json entries, and no
    edit of the harness; the cell runs, and its probes time the
    program."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = bench()
    mix = dict(harness.load_json(os.path.join(
        HERE, "traffic", "encode-batched.json")), batch=2, clients=2,
        entry="encode_timed_twice")
    (tmp_path / "portbench/entries/encode_timed_twice.py").write_text(ENTRY)
    (tmp_path / "portbench/traffic/encode-small.json").write_text(
        json.dumps(mix))
    conf = dict(harness.load_json(os.path.join(
        HERE, "configs", "uhdr-3mp-p3-pq.json")), width=64, height=32,
        name="tiny", reduced=["width", "height"])
    (tmp_path / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    (tmp_path / "portbench/metrics/device_stage_ms.py").write_text(
        "from portbench.tracing import Probe\n"
        "PROBES = (Probe('encode_device_stage', 'parallel.batched',\n"
        "                'encode_coefs_stage'),)\n"
        "def read(run):\n"
        "    return float(len(run.spans.items))\n")
    b["configs"].append({"name": "tiny", "source": conf["source"],
                         "file": "portbench/configs/tiny.json",
                         "reduced": ["width", "height"], "why": "a test"})
    b["workloads"].append({"name": "tiny.encode", "config": "tiny",
                           "traffic": "encode-small", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "device_stage_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "batched device stage",
                           "moves": "frames_per_s",
                           "workloads": ["tiny.encode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    root = str(tmp_path)
    cell = harness.find_cell("tiny.encode", root=root)
    assert cell.mix["batch"] == 2 and cell.config["width"] == 64
    assert [m["name"] for m in cell.per_layer] == ["device_stage_ms"]
    line = harness.run_cell("tiny.encode", 7, 0.5, False, "cpu", cell=cell,
                            root=root)
    assert line["correct"] and line["attempted"] >= 1
    port = harness.import_port()
    entry = harness.make_entry(cell, port, "cpu", root)
    pool = entry.pool(7)
    spans = tracing.Spans()
    probes = list(entry.probes) + list(
        harness.metric_probes("device_stage_ms", root))
    names, restore = harness.wrap_probes(probes, spans)
    try:
        entry.call(pool[0].payload)
    finally:
        restore()
    assert set(names) == {"encode_host_tail", "encode_device_stage"}
    assert {n for n, *_ in spans.items} == set(names)
    assert spans.counters["encode_host_tail"] > 0
    assert entry.work(2, spans.counters)["bytes"] > 0


def test_a_run_without_a_card_prints_no_result(tmp_path):
    """run.py on a machine without CUDA exits non-zero, no result line;
    so does a directory that holds only the benchmark's files."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "3mp-pq.decode", "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 3 and not r.stdout.strip()
    assert "no CUDA device" in r.stderr
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "3mp-pq.decode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()


@pytest.mark.card
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "3mp-pq.decode", "--seed", str(2**31 + 11),
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and line["correct"]
    assert line["device"]["platform"] == "gpu"
