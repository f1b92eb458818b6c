"""Entry ``api_encode_api0``: api.py UhdrEncoder on one host P010 frame
with the configuration's gamut and transfer, the base quality set; the
reply is the JPEG/R bytes in host memory. Judged, timed and counted as
``batched_encode_api0``, whose host tail (parallel/batched.py
assemble_api0) runs under the API."""

from portbench import drive

from . import batched_encode_api0


class Entry(batched_encode_api0.Entry):
    def pool(self, seed):
        t = self.port.types
        y, uv = self.frames(seed)
        self.inputs = (y, uv)
        c = self.cfg
        return [drive.Request(t.RawImage(
            fmt=t.PixelFormat.P010, width=c["width"], height=c["height"],
            gamut=t.ColorGamut(c["gamut"]),
            transfer=t.ColorTransfer(c["transfer"]),
            planes={"y": y[i], "uv": uv[i]}), (i,)) for i in range(len(y))]

    def call(self, payload):
        api = self.port.api
        enc = api.UhdrEncoder(self.device)
        enc.set_raw_image(payload, api.HDR_IMG)
        enc.set_quality(self.cfg["quality"], api.BASE_IMG)
        return [enc.encode().data]
