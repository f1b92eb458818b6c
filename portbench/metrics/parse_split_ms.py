"""parse_split_ms: host milliseconds a frame in the JPEG/R split of the
batched decode's host stage, the program's span "decode.split"
(container/mux.py extract_primary_and_gainmap in parallel/batched.py
parse_device_route), summed over every thread in the traced stretch
over its frames."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_frame(run, "decode.split")
