"""The torch device an entry point runs on, and the one-copy upload.

Shared by parallel/batched.py, jpegr.py, api.py and jpeg/codec.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import counters
from .utils.profiler import span


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device (the default)
    must exist: without one the call raises, and nothing runs on the
    CPU unless the caller asks for it. A CUDA device always carries its
    index: "cuda" is the current device, cuda:<index>, so that what is
    cached per device (keyed by this) is found again whichever card is
    current later."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; "
                               "pass device='cpu' to run its plain versions "
                               "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(arrays, device) -> list[torch.Tensor]:
    """Copy numpy arrays to `device` in ONE host-to-device transfer:
    their bytes back to back (16-byte aligned) in one buffer, returned
    as typed views of the device copy. Runs in the span "upload" and
    counts the buffer's bytes in counter "h2d_bytes"."""
    with span("upload"):
        offs, size = [], 0
        for a in arrays:
            offs.append(size)
            size += -(-a.nbytes // 16) * 16
        buf = np.zeros(max(size, 16), np.uint8)
        for a, o in zip(arrays, offs):
            buf[o:o + a.nbytes] = (np.ascontiguousarray(a).view(np.uint8)
                                   .reshape(-1))
        dbuf = torch.from_numpy(buf).to(device)
    counters.bump("h2d_bytes", buf.nbytes)
    return [dbuf[o:o + a.nbytes].view(getattr(torch, a.dtype.name))
            .reshape(a.shape) for a, o in zip(arrays, offs)]
