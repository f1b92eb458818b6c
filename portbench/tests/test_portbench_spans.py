"""The readers of the program's spans (portbench/program_spans.py and the
metrics that use it) on a traced run built by hand: synthetic program
spans and device operations on one clock, checked against hand counts."""

import pytest

from portbench import harness, program_spans, tracing

from libultrahdr_dev_tpu_torch.utils import profiler

SPAN_METRICS = {"parse_split_ms": "decode.split",
                "parse_headers_ms": "decode.headers",
                "parse_destuff_ms": "decode.destuff",
                "device_stage_host_ms": "decode.device_stage"}
NEW = (*SPAN_METRICS, "device_idle_unspanned_pct")


def run_of(spans, ops, window=(10.0, 20.0), frames=4, monkeypatch=None):
    monkeypatch.setattr(profiler, "recorded", lambda: list(spans))
    return harness.TracedRun({}, frames, tracing.Spans(),
                             tracing.DeviceTrace(window, ops), None)


def read(name, run):
    return harness.metric_reader(name)(run)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_ms_metrics_clip_to_the_window_divide_by_frames_and_add_threads(
        metric, monkeypatch):
    span = SPAN_METRICS[metric]
    spans = [(span, 1, 9.0, 10.5),      # 0.5 s inside the window
             (span, 1, 12.0, 13.0),     # 1.0 s
             (span, 2, 12.5, 13.5),     # 1.0 s on a second thread
             (span, 2, 19.75, 21.0),    # 0.25 s
             (span, 1, 21.0, 22.0),     # outside
             ("decode.host", 1, 9.0, 22.0)]
    run = run_of(spans, [], frames=4, monkeypatch=monkeypatch)
    assert read(metric, run) == pytest.approx(2.75 / 4 * 1e3)
    for other in set(SPAN_METRICS) - {metric}:
        assert read(other, run) is None


def test_idle_unspanned_against_a_hand_count(monkeypatch):
    """Window 10-20 s. Device ops 11-12 and 15-16 (8 s idle). Spans on
    two threads cover 9-10.5, 11.5-13, 12.5-14 and 15.5-17; idle time
    under no span: 10.5-11, 14-15 and 17-20, 4.5 s of the 10."""
    ops = [("decode_kernel", "kernel", 11.0, 12.0),
           ("Memcpy HtoD", "gpu_memcpy", 15.0, 16.0)]
    spans = [("decode.host", 1, 9.0, 10.5),
             ("decode.split", 1, 11.5, 13.0),
             ("upload", 2, 12.5, 14.0),
             ("decode.launch", 1, 15.5, 17.0)]
    run = run_of(spans, ops, monkeypatch=monkeypatch)
    assert read("device_idle_unspanned_pct", run) == pytest.approx(45.0)
    assert read("device_idle_pct", run) == pytest.approx(80.0)
    spanned_idle = sum(min(g1, s1) - max(g0, s0)
                       for g0, g1 in tracing.idle_gaps(run.trace)
                       for s0, s1 in tracing.union(
                           sorted(program_spans.recorded(run.trace.window),
                                  key=lambda s: s[2]))
                       if min(g1, s1) > max(g0, s0))
    assert 45.0 + 100 * spanned_idle / 10.0 == pytest.approx(80.0)


def test_a_program_without_a_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiler, "recorded")
    run = harness.TracedRun({}, 4, tracing.Spans(), tracing.DeviceTrace(
        (0.0, 1.0), [("k", "kernel", 0.1, 0.2)]), None)
    assert all(read(m, run) is None for m in NEW)


def test_every_new_metric_resolves_to_a_reader():
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert callable(harness.metric_reader(name))
        m = entries[name]
        assert m["source"] == "program_span" and m["moves"] == "frames_per_s"
        assert m["workloads"] == ["12mp-hlg.decode-device", "3mp-pq.decode"]
