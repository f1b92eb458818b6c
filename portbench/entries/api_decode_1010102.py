"""Entry ``api_decode_1010102``: api.py UhdrDecoder on one JPEG/R file
(written from the seed by the plain reference) to RGBA1010102 in the
configuration's transfer; the reply is the pixels in host memory, read
back by the program. Its traced run times the batched host parse
(parallel/batched.py decode_host_stage) under the API."""

from portbench import drive, judge, roofline
from portbench.tracing import Probe


def stream_bytes(args, kwargs, result):
    """Bytes of the destuffed entropy streams that a decode_host_stage
    call handed to the device route."""
    return sum(st.dest.nbytes for f in result for st in (f.streams or ()))


class Entry(drive.Entry):
    limits = judge.WORDS_LIMITS
    probes = (Probe("decode_host_parse", "parallel.batched",
                    "decode_host_stage", stream_bytes),)

    def __init__(self, port, cfg, mix, device):
        super().__init__(port, cfg, mix, device)
        if self.setting("output_format") != "rgba1010102":
            raise ValueError("this entry decodes to RGBA1010102")

    def pool(self, seed):
        self.inputs = self.files(seed)
        return [drive.Request(b, (i,)) for i, b in enumerate(self.inputs)]

    def call(self, payload):
        t = self.port.types
        dec = self.port.api.UhdrDecoder(self.device)
        dec.set_image(payload)
        dec.set_out_img_format(t.PixelFormat.RGBA1010102)
        dec.set_out_color_transfer(t.ColorTransfer(self.cfg["transfer"]))
        return [dec.decode().planes["rgba"]]

    def judge(self, frame, output):
        return judge.words_numbers(self, frame, output)

    def control(self, frame):
        return judge.words_control(self, frame)

    def work(self, frames, counters):
        """The streams read once, four bytes a pixel written once, the
        IDCT's and the apply's operations."""
        c = self.cfg
        return roofline.decode_stage(
            c["width"], c["height"], frames,
            int(counters.get("decode_host_parse", 0)), 4,
            roofline.OPS[f"apply {c['transfer']}"])
