"""The traced run: host spans, the device trace and what they share.

Host spans are taken by the harness around the calls into a layer
(``Spans.wrap`` puts a timer around a module attribute of the program
for the traced run only) and on the host's ``perf_counter`` clock. The
device's activity comes from the program's ``utils/profiler.py``
``device_trace`` (a ``torch.profiler`` Chrome trace). A marker that the
harness puts on the trace's timeline at a known ``perf_counter`` time
ties the two clocks together.
"""

from __future__ import annotations

import bisect
import functools
import json
import threading
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class Probe:
    """A layer of the program that a traced run times: every call of
    `attr` of the program's module `module` (a dotted path inside the
    package) is a span named `span`; `count(args, kwargs, result)`, where
    given, adds a number to the counter of the same name."""

    span: str
    module: str
    attr: str
    count: object = None


class Spans:
    """Named host intervals, in memory, from any thread, with counters
    summed beside them."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: list[tuple[str, int, float, float]] = []
        self.counters: dict[str, float] = {}

    def add(self, name: str, t0: float, t1: float):
        with self._lock:
            self.items.append((name, threading.get_ident(), t0, t1))

    def count(self, name: str, value: float):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def wrap(self, module, attr: str, name: str, counter=None):
        """Time every call of module.attr as span `name`; `counter(args,
        kwargs, result)` gives a number to add to counter `name`. Returns a
        function that puts the attribute back."""
        orig = getattr(module, attr)

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                result = orig(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())
            if counter is not None:
                self.count(name, counter(args, kwargs, result))
            return result

        setattr(module, attr, timed)
        return lambda: setattr(module, attr, orig)


@dataclass
class DeviceTrace:
    """Device activity of a traced stretch on the host's clock: (name,
    category, start, end) in seconds, clipped to the window."""

    window: tuple[float, float]
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        return [o for o in self.ops if o[1] == "kernel"]


def read_chrome_trace(path: str, marker: str, marker_t0: float,
                      window: tuple[float, float]) -> DeviceTrace:
    """The device activity of a Chrome trace, moved onto the host's
    perf_counter clock by `marker`, the user annotation entered at
    `marker_t0`, and clipped to `window` (perf_counter seconds)."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    starts = [e["ts"] for e in events
              if e.get("name") == marker and e.get("cat") == "user_annotation"]
    if not starts:
        raise RuntimeError(f"marker {marker} not in the trace")
    offset = marker_t0 - min(starts) * 1e-6
    lo, hi = window
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = e["ts"] * 1e-6 + offset
        t1 = t0 + e.get("dur", 0) * 1e-6
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            ops.append((short_name(e.get("name", "")), e["cat"], t0, t1))
    ops.sort(key=lambda o: o[2])
    return DeviceTrace(window, ops)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    return base.split("(")[0].split("<")[0].strip() or name[:60]


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) of (.., .., start, end) items sorted by start."""
    out: list[list[float]] = []
    for *_, t0, t1 in intervals:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [tuple(x) for x in out]


def busy_seconds(intervals) -> float:
    return sum(t1 - t0 for t0, t1 in union(intervals))


def idle_gaps(trace: DeviceTrace) -> list[tuple[float, float]]:
    """The stretches of the window with nothing running on the device."""
    gaps, t = [], trace.window[0]
    for t0, t1 in union(trace.ops):
        if t0 > t:
            gaps.append((t, t0))
        t = max(t, t1)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    return gaps


class OpenSpans:
    """The names of the spans open at a time t, looked up by bisection."""

    def __init__(self, spans: Spans):
        self.items = sorted(spans.items, key=lambda s: s[2])
        self.starts = [s[2] for s in self.items]
        self.longest = max((s[3] - s[2] for s in self.items), default=0.0)

    def __call__(self, t: float) -> list[str]:
        hi = bisect.bisect_right(self.starts, t)
        lo = bisect.bisect_left(self.starts, t - self.longest)
        return [s[0] for s in self.items[lo:hi] if s[3] > t]


def host_label(open_: list[str], layers: tuple[str, ...]) -> str:
    """What the host was doing, from the spans open on any client thread:
    the most common layer span, else "request" when a request was open,
    else "between requests"."""
    named = [n for n in open_ if n in layers]
    if named:
        return max(set(named), key=named.count)
    return "request" if open_ else "between requests"


def breakdown(trace: DeviceTrace, spans: Spans,
              layers: tuple[str, ...]) -> dict:
    """The device operations that took most time, and the idle time of
    the device by what the host was doing then, at most 10 of each."""
    by_op: dict[str, float] = {}
    for name, _, t0, t1 in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0)
    by_host: dict[str, float] = {}
    open_at = OpenSpans(spans)
    for g0, g1 in idle_gaps(trace):
        label = host_label(open_at((g0 + g1) / 2), layers)
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
