"""Spans the program records itself (libultrahdr_dev_tpu_torch/utils/
profiler.py ``span``), for the per-layer metrics of a traced run.

The traced stretch runs inside the program's ``device_trace``, which
records every span of the process on the ``perf_counter`` clock that the
window and the device trace are on; ``recorded()`` reads them after the
stretch. A program without a recorder gives no spans, and the metrics
that read them are left out of its line.
"""

from __future__ import annotations

import importlib

PROFILER = "libultrahdr_dev_tpu_torch.utils.profiler"


def recorded(window: tuple[float, float]) -> list:
    """The program's spans (name, thread id, start, end), clipped to
    `window` (perf_counter seconds), those outside it left out."""
    fn = getattr(importlib.import_module(PROFILER), "recorded", None)
    lo, hi = window
    out = []
    for name, tid, t0, t1 in (fn() if fn is not None else ()):
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            out.append((name, tid, t0, t1))
    return out


def ms_per_frame(run, name: str) -> float | None:
    """Milliseconds a frame in span `name`: its intervals in the traced
    stretch summed over every thread, over the stretch's frames."""
    total = sum(t1 - t0 for n, _, t0, t1 in recorded(run.trace.window)
                if n == name)
    if not total or not run.frames:
        return None
    return total / run.frames * 1e3
