"""Entry ``batched_decode_1010102``: parallel/batched.py batched_decode
of a batch of JPEG/R files (written from the seed by the plain
reference) to RGBA1010102 in the configuration's transfer, the pixels
left on the device; the reply is in at a synchronize of the stream.
Judged, timed and counted as ``api_decode_1010102``."""

from portbench import drive

from . import api_decode_1010102


class Entry(api_decode_1010102.Entry):
    output = "device"

    def pool(self, seed):
        self.inputs = self.files(seed)
        return [drive.Request([self.inputs[i] for i in b], b)
                for b in drive.batches(len(self.inputs), self.batch)]

    def call(self, payload):
        out = self.port.batched.batched_decode(
            payload, f"hdr_{self.cfg['transfer']}", device=self.device)
        if out.is_cuda:
            self.port.torch.cuda.current_stream(out.device).synchronize()
        return list(out)
