"""Tracing / profiling utilities of the port.

A copy of libultrahdr_dev_tpu/utils/profiler.py's host timers (the
reference has only ad-hoc gettimeofday Profiler wrappers,
examples/ultrahdr_app.cpp:100-138, tests/jpegr_test.cpp:2156-2200): a
stage timer with the same start/stop/elapsed surface and a scoped
context manager. The device hooks use torch.profiler: device_trace
records CPU and, where a CUDA device exists, CUDA activity and writes a
Chrome trace. Unlike the JAX package's device_trace, a profiler that
fails to start raises.

Spans: ``span(name)`` names a region of the program. It costs one read
of a module flag unless a recording is on (``recording()``, or a
``device_trace``, which records for its own extent): then each span's
(name, thread id, start, end) on the ``time.perf_counter`` clock goes to
the process recorder, which ``recorded()`` reads after the recording
has ended, and inside a device_trace the span is also a
``torch.profiler.record_function`` region, so the exported Chrome trace
shows it (category ``user_annotation``) beside the kernels. Given a
StageTimes, a span adds its time there as well, recording or not.
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

    def stage(self, name: str):
        return span(name, self)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            ms = self.totals[name] * 1000.0
            lines.append(f"{name}: {ms:.2f} ms total, "
                         f"{ms / max(n, 1):.2f} ms/iter x{n}")
        return "\n".join(lines)


class _NoSpan:
    """The span of a region that nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_lock = threading.Lock()
_recordings = 0     # recordings open now (recording() and device_trace)
_traces = 0         # device_trace regions open now
_trace_count = 0    # device_trace regions written, for the file names
_recorder: list = []


class _Span:
    """The span of a region that a recording, a device_trace or a
    StageTimes takes."""

    __slots__ = ("name", "times", "rec", "rf", "t0")

    def __init__(self, name: str, times):
        self.name, self.times = name, times
        self.rec = _recorder if _recordings else None
        self.rf = None

    def __enter__(self):
        if _traces:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.times is not None:
            self.times.totals[self.name] += t1 - self.t0
            self.times.counts[self.name] += 1
        if self.rec is not None:
            self.rec.append((self.name, threading.get_ident(), self.t0, t1))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, times: StageTimes | None = None):
    """A context manager naming a region `name`: recorded while a
    recording is on, a torch.profiler region inside a device_trace, and
    added to `times` (as times.stage) where given. With none of these it
    is one shared no-op."""
    if not _recordings and times is None:
        return _NO_SPAN
    return _Span(name, times)


@contextlib.contextmanager
def recording():
    """Record every span of the process, from every thread, while the
    region runs. The recorder is cleared when a recording starts (not
    when one opens inside another) and kept after it ends."""
    global _recordings, _recorder
    with _lock:
        if not _recordings:
            _recorder = []
        _recordings += 1
    try:
        yield
    finally:
        with _lock:
            _recordings -= 1


def recorded() -> list[tuple[str, int, float, float]]:
    """The spans of the last recording (the current one while it runs):
    (name, thread id, start, end), perf_counter seconds, in the order
    they ended."""
    return list(_recorder)



@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler trace around a region: CPU activity and, where a
    CUDA device exists, CUDA activity; on exit a Chrome trace
    (trace_<pid>_<n>.json, viewable in Perfetto or chrome://tracing) is
    written under logdir (UHDR_TRACE_DIR, default uhdr_trace in the
    temporary directory, so TMPDIR moves it).
    The region records spans (recording()), and each span is a named
    region of the trace. Yields logdir. A profiler that fails to start
    raises."""
    import torch

    global _trace_count, _traces
    logdir = logdir or os.environ.get(
        "UHDR_TRACE_DIR", os.path.join(tempfile.gettempdir(), "uhdr_trace"))
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        with _lock:
            _traces += 1
        try:
            yield logdir
        finally:
            with _lock:
                _traces -= 1
    with _lock:
        _trace_count += 1
        n = _trace_count
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))

