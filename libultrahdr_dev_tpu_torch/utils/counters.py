"""Process-wide event counters for observability.

The packed transfers follow content rules that change what crosses the
link without changing the result: the dense upload when the segment
pack does not pay, the raw readback when the Rice pack declines, the
re-plan when the fused readback's speculated plan no longer fits. Each
rule counts its firings here, so a run can say how often it took the
slower path. A copy of libultrahdr_dev_tpu/utils/counters.py.

Beside them: "decode_route_host", the frames of batched decodes sent to
host Huffman because some blob of their batch did not suit the device
decoder (parallel/batched.py decode_host_stage); "h2d_bytes", the bytes
of every one-copy upload (device.py upload); "kernels_built", the CUDA
kernel builds that ran nvcc (kernels/build.py build);
"decode_table_sets", the streams whose four Huffman decode tables were
made natively (jpeg/device_decode.py build_tables: two a frame of a
batched HDR decode, one per image otherwise).
"""

from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict[str, int] = defaultdict(int)


def bump(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
