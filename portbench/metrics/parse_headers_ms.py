"""parse_headers_ms: host milliseconds a frame in the marker and table
walk of both images of the batched decode's host stage, with the entropy
segment's slice, the gain map's XMP parse and the geometry and metadata
checks: the program's span "decode.headers" (jpeg/device_decode.py
parse_device_headers in parallel/batched.py parse_device_route), summed
over every thread in the traced stretch over its frames."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_frame(run, "decode.headers")
