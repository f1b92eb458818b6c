"""The port's profiling utilities (libultrahdr_dev_tpu_torch/utils/
profiler.py) on the CPU: the host timers copied from the JAX package
(Profiler, StageTimes) and the torch.profiler hooks (device_trace writes
a Chrome trace holding the program's spans as user annotations)."""

import json
import os
import tempfile
import time

import pytest
import torch

from libultrahdr_dev_tpu.utils import profiler as jprofiler
from libultrahdr_dev_tpu_torch.utils import profiler

import test_torch_threads  # noqa: F401  (caps torch's threads)


def test_profiler_start_stop_elapsed():
    p = profiler.Profiler()
    assert p.elapsed_ms() == 0.0
    p.start()
    time.sleep(0.01)
    p.stop()
    first = p.elapsed_ms()
    assert first >= 10.0
    p.stop()  # stopping a stopped timer adds nothing
    assert p.elapsed_ms() == first
    p.start()
    assert p.elapsed_ms() >= first  # a running timer counts its lap
    p.reset()
    assert p.elapsed_ms() == 0.0


def test_stage_times_report_as_jax(monkeypatch):
    """The same stages on a fixed clock give the JAX package's report,
    heaviest stage first."""
    reports = []
    for mod in (profiler, jprofiler):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        st = mod.StageTimes()
        for name in ("parse", "apply", "parse"):
            with st.stage(name):
                pass
        reports.append(st.report())
        monkeypatch.undo()
    assert reports[0] == reports[1]
    assert reports[0].splitlines() == [
        "parse: 750.00 ms total, 375.00 ms/iter x2",
        "apply: 500.00 ms total, 500.00 ms/iter x1"]


def test_stage_times_count_a_raising_stage():
    st = profiler.StageTimes()
    with pytest.raises(ValueError):
        with st.stage("boom"):
            raise ValueError("inside the stage")
    assert st.counts["boom"] == 1 and st.totals["boom"] >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiler.device_trace(str(tmp_path)) as logdir:
        with profiler.span("uhdr_region"):
            torch.ones(64).add_(1)
    assert logdir == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "uhdr_region"
               and e.get("cat") == "user_annotation" for e in events)
    assert [s[0] for s in profiler.recorded()] == ["uhdr_region"]


def test_device_trace_default_dir_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("UHDR_TRACE_DIR", str(tmp_path / "traces"))
    with profiler.device_trace() as logdir:
        pass
    assert logdir == str(tmp_path / "traces")
    assert any(f.endswith(".json") for f in os.listdir(logdir))


def test_device_trace_default_dir_in_tmpdir(tmp_path, monkeypatch):
    """With no logdir and no UHDR_TRACE_DIR the trace goes under the
    temporary directory (TMPDIR), not a fixed path."""
    monkeypatch.delenv("UHDR_TRACE_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with profiler.device_trace() as logdir:
        pass
    assert logdir == str(tmp_path / "uhdr_trace")
    assert any(f.endswith(".json") for f in os.listdir(logdir))
