"""Tracing / profiling utilities of the port.

A copy of libultrahdr_dev_tpu/utils/profiler.py's host timers (the
reference has only ad-hoc gettimeofday Profiler wrappers,
examples/ultrahdr_app.cpp:100-138, tests/jpegr_test.cpp:2156-2200): a
stage timer with the same start/stop/elapsed surface and a scoped
context manager. The device hooks use torch.profiler: device_trace
records CPU and, where a CUDA device exists, CUDA activity and writes a
Chrome trace; annotate names a region on that timeline. Unlike the JAX
package's device_trace, a profiler that fails to start raises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict


class Profiler:
    """Wall-clock stage timer (Profiler parity: start/stop/elapsed)."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def elapsed_ms(self) -> float:
        running = (time.perf_counter() - self._t0) if self._t0 else 0.0
        return (self._elapsed + running) * 1000.0

    def reset(self):
        self._t0 = None
        self._elapsed = 0.0


class StageTimes:
    """Accumulates named stage timings across iterations."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            ms = self.totals[name] * 1000.0
            lines.append(f"{name}: {ms:.2f} ms total, "
                         f"{ms / max(n, 1):.2f} ms/iter x{n}")
        return "\n".join(lines)


def stage_of(times: StageTimes | None, name: str):
    """times.stage(name), or no span where times is None: how a function
    that takes an optional StageTimes names its stages."""
    return contextlib.nullcontext() if times is None else times.stage(name)


_trace_lock = threading.Lock()
_trace_count = 0


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler trace around a region: CPU activity and, where a
    CUDA device exists, CUDA activity; on exit a Chrome trace
    (trace_<pid>_<n>.json, viewable in Perfetto or chrome://tracing) is
    written under logdir (UHDR_TRACE_DIR, default uhdr_trace in the
    temporary directory, so TMPDIR moves it).
    Yields logdir. A profiler that fails to start raises."""
    import torch

    global _trace_count
    logdir = logdir or os.environ.get(
        "UHDR_TRACE_DIR", os.path.join(tempfile.gettempdir(), "uhdr_trace"))
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    with _trace_lock:
        _trace_count += 1
        n = _trace_count
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """A named region on the device_trace timeline
    (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)
