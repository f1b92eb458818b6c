"""device_idle_unspanned_pct: the share of the traced stretch in which
no kernel, copy or memset ran on the card and no span of the program
(utils/profiler.py span) was open on any thread, in percent: the idle
time that the program's spans do not explain (the harness's own code,
Python between calls). Device operations and spans are on the one
perf_counter clock of the stretch."""

from portbench import program_spans, tracing


def read(run):
    spans = program_spans.recorded(run.trace.window)
    if run.trace.window_s <= 0 or not spans:
        return None
    covered = tracing.busy_seconds(
        sorted([*run.trace.ops, *spans], key=lambda s: s[2]))
    return 100.0 * (1.0 - covered / run.trace.window_s)
