"""Entry ``batched_encode_api0``: parallel/batched.py batched_encode_api0
on a batch of host P010 frames, API-0 in the configuration's gamut,
transfer and quality; the reply is each frame's JPEG/R bytes in host
memory. Its traced run times the batched host tail (assemble_api0)."""

import numpy as np

from portbench import drive, judge, roofline
from portbench.tracing import Probe


def stream_bytes(args, kwargs, result):
    """Bytes of the entropy-coded streams and their bit counts that an
    assemble_api0 call took from the device."""
    s = args[0]
    return (s.base.numel() + s.gm.numel()
            + 4 * (s.base_bits.numel() + s.gm_bits.numel()))


class Entry(drive.Entry):
    limits = judge.FILE_LIMITS
    probes = (Probe("encode_host_tail", "parallel.batched", "assemble_api0",
                    stream_bytes),)

    def pool(self, seed):
        y, uv = self.frames(seed)
        self.inputs = (y, uv)
        return [drive.Request((np.ascontiguousarray(y[list(b)]),
                               np.ascontiguousarray(uv[list(b)])), b)
                for b in drive.batches(len(y), self.batch)]

    def call(self, payload):
        c = self.cfg
        return self.port.batched.batched_encode_api0(
            payload[0], payload[1], gamut=c["gamut"], hdr_tf=c["transfer"],
            quality=c["quality"], device=self.device)

    def judge(self, frame, output):
        return judge.file_numbers(self, frame, output)

    def control(self, frame):
        return judge.file_control(self, frame)

    def work(self, frames, counters):
        c = self.cfg
        return roofline.encode_stage(
            c["width"], c["height"], c["transfer"], frames,
            int(counters.get("encode_host_tail", 0)))
