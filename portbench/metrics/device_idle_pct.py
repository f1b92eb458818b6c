"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or memset ran on the card, from the program's device trace
(utils/profiler.py device_trace), in percent."""

from portbench import tracing


def read(run):
    if run.trace.window_s <= 0:
        return None
    busy = tracing.busy_seconds(run.trace.ops)
    return 100.0 * (1.0 - busy / run.trace.window_s)
