"""device_stage_host_ms: host milliseconds a frame in the batched
decode's device stage: the program's span "decode.device_stage"
(parallel/batched.py _decode_shard: the upload's layout, the one
host-to-device copy and the kernels' enqueue, up to its return), summed
over every thread in the traced stretch over its frames."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_frame(run, "decode.device_stage")
