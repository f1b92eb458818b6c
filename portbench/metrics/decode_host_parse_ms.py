"""decode_host_parse_ms: host milliseconds a frame in the batched
decode's host stage, parallel/batched.py decode_host_stage (the JPEG/R
split, the marker parse and the destuffing of both images): the sum of
the harness's spans around it in the traced stretch over the frames of
every request of the stretch. Spans of concurrent clients add up."""

from portbench.tracing import Probe

PROBES = (Probe("decode_host_parse", "parallel.batched",
                "decode_host_stage"),)


def read(run):
    total = sum(t1 - t0 for name, _, t0, t1 in run.spans.items
                if name == "decode_host_parse")
    if not total or not run.frames:
        return None
    return total / run.frames * 1e3
