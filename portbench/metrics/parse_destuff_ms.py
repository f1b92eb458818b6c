"""parse_destuff_ms: host milliseconds a frame in the destuffing of both
images' entropy segments in the batched decode's host stage: the
program's span "decode.destuff" (jpeg/device_decode.py
destuff_device_stream: split_rst_stream, or scan_foreign_stream for a
restart-less stream), summed over every thread in the traced stretch
over its frames."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_frame(run, "decode.destuff")
