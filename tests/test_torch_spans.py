"""The port's spans and counters (libultrahdr_dev_tpu_torch/utils/
profiler.py span / recording / recorded, utils/counters.py) on the CPU:
a span costs nothing while nothing records; a batched decode records
its host stage and its parts nested on the calling thread, and the host
side of its device stage; the upload counts its bytes; a batch sent to
host Huffman counts its frames; a span given a StageTimes fills it."""

import threading

import numpy as np
import pytest

from libultrahdr_dev_tpu_torch import device as tdevice
from libultrahdr_dev_tpu_torch.container import mux
from libultrahdr_dev_tpu_torch.jpeg import codec
from libultrahdr_dev_tpu_torch.jpegr import JpegR
from libultrahdr_dev_tpu_torch.parallel import batched
from libultrahdr_dev_tpu_torch.types import GainMapMetadata
from libultrahdr_dev_tpu_torch.utils import counters, profiler

import test_torch_threads  # noqa: F401  (caps torch's threads)

H, W = 48, 64


def _jpegr(seed: int, arithmetic: bool = False) -> bytes:
    """A small JPEG/R written by the port on the CPU: a 4:2:0 base (its
    entropy coding Huffman, or arithmetic, which the device decoder
    refuses) and a gray gain map a quarter its size."""
    rng = np.random.default_rng(seed)

    def plane(h, w):
        small = rng.integers(30, 220, (h // 8 + 1, w // 8 + 1))
        return np.kron(small, np.ones((8, 8)))[:h, :w].astype(np.uint8)

    base = codec.encode_jpeg({"y": plane(H, W), "u": plane(H // 2, W // 2),
                              "v": plane(H // 2, W // 2)}, 92,
                             arithmetic=arithmetic, device="cpu")
    gmap = codec.encode_jpeg({"y": plane(H // 4, W // 4)}, 85, device="cpu")
    meta = GainMapMetadata(max_content_boost=4.0, min_content_boost=1.0,
                           hdr_capacity_max=4.0)
    return JpegR("cpu").encode_api4(base, gmap, meta)


def _inside(child, parent) -> bool:
    return (child[1] == parent[1] and parent[2] <= child[2]
            and child[3] <= parent[3])


def test_span_off_records_nothing_and_is_the_shared_noop():
    with profiler.recording():
        pass
    a, b = profiler.span("decode.host"), profiler.span("upload")
    assert a is b
    with a:
        pass
    assert profiler.recorded() == []


def test_recording_keeps_spans_of_every_thread_after_it_ends():
    with profiler.recording():
        with profiler.span("outer"):
            t = threading.Thread(target=lambda: profiler.span("worker")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join()
    rec = profiler.recorded()
    assert sorted(s[0] for s in rec) == ["outer", "worker"]
    ids = {s[0]: s[1] for s in rec}
    assert ids["outer"] == threading.get_ident() != ids["worker"]
    with profiler.recording():
        pass
    assert profiler.recorded() == []


def test_batched_decode_spans_nest_on_the_calling_thread():
    blobs = [_jpegr(1), _jpegr(2)]
    before = counters.snapshot().get("decode_route_host", 0)
    with profiler.recording():
        out = batched.batched_decode(blobs, "hdr_hlg", device="cpu")
    assert out.shape == (2, H, W)
    assert counters.snapshot().get("decode_route_host", 0) == before
    rec = profiler.recorded()
    names = [s[0] for s in rec]
    (host,) = [s for s in rec if s[0] == "decode.host"]
    assert host[1] == threading.get_ident()
    for name, per_frame in (("decode.split", 1), ("decode.headers", 2),
                            ("decode.destuff", 2)):
        kids = [s for s in rec if s[0] == name]
        assert len(kids) == per_frame * len(blobs), name
        assert all(_inside(k, host) for k in kids), name
    (stage,) = [s for s in rec if s[0] == "decode.device_stage"]
    assert stage[2] >= host[3]
    for name in ("decode.pack", "upload", "decode.launch"):
        (kid,) = [s for s in rec if s[0] == name]
        assert _inside(kid, stage), name
    assert names.count("upload") == 1


def test_upload_counts_its_buffer_bytes():
    arrays = [np.arange(5, dtype=np.int32), np.zeros((3, 7), np.uint8),
              np.ones(2, np.float32)]
    before = counters.snapshot().get("h2d_bytes", 0)
    with profiler.recording():
        views = tdevice.upload(arrays, "cpu")
    size = sum(-(-a.nbytes // 16) * 16 for a in arrays)
    assert counters.snapshot().get("h2d_bytes", 0) - before == size == 80
    assert all(np.array_equal(v.numpy(), a) for v, a in zip(views, arrays))
    assert [s[0] for s in profiler.recorded()] == ["upload"]


def test_batch_with_a_refused_blob_counts_its_frames_on_host_huffman():
    blobs = [_jpegr(3), _jpegr(4, arithmetic=True), _jpegr(5)]
    images = [mux.read_primary_and_gainmap(b) for b in blobs[:2]]
    assert batched.parse_device_route(images[0]) is not None
    assert batched.parse_device_route(images[1]) is None
    before = counters.snapshot().get("decode_route_host", 0)
    frames = batched.decode_host_stage(blobs, "hdr_hlg")
    assert all(f.streams is None and f.grids is not None for f in frames)
    assert counters.snapshot().get("decode_route_host", 0) - before == 3


def test_span_with_stage_times_fills_them_as_stage(monkeypatch):
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.5])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(ticks))
    st = profiler.StageTimes()
    for name in ("parse", "apply"):
        with profiler.span(name, st):
            pass
    with st.stage("parse"):
        pass
    monkeypatch.undo()
    assert dict(st.counts) == {"parse": 2, "apply": 1}
    assert st.totals["parse"] == pytest.approx(0.75)
    assert st.totals["apply"] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        with profiler.span("boom", st):
            raise ValueError("inside the span")
    assert st.counts["boom"] == 1
