"""encode_host_tail_ms: host milliseconds a frame in the batched encode's
host tail, parallel/batched.py assemble_api0 (the streams' copy to the
host, finalize_rst_stream's stuffing and markers, the headers and the
JPEG/R mux): the sum of the harness's spans around it in the traced
stretch over the frames of every request of the stretch. Spans of
concurrent clients add up, so this is host time spent, not wall time."""

from portbench.tracing import Probe

PROBES = (Probe("encode_host_tail", "parallel.batched", "assemble_api0"),)


def read(run):
    total = sum(t1 - t0 for name, _, t0, t1 in run.spans.items
                if name == "encode_host_tail")
    if not total or not run.frames:
        return None
    return total / run.frames * 1e3
