"""The requests a traffic mix sends, and the closed loop that sends them.

A mix names an entry point of the program (a file
``portbench/entries/<entry>.py`` whose class ``Entry`` subclasses
``Entry`` below) and its parameters: the batch a request carries, the
clients, the number of distinct input frames, where the output ends.
Each entry makes its input pool from the run's seed, then serves
requests from it; a request's reply is in when its output is where the
mix says (JPEG/R bytes or pixels in host memory, or pixels on the
device after a synchronize of the stream).

The loop is closed: each client is a thread that sends its next request
when its reply is in. Every client walks the pool from its own offset,
so a seed gives the same requests in the same order to each client.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from dataclasses import dataclass, field

from . import content
from .reference import writer


@dataclass
class Request:
    """One request of a pool: its payload for the program and the pool
    frames it carries, in order."""

    payload: object
    frames: tuple


class Entry:
    """An entry point of the program under a configuration and a mix.

    A subclass, one to a file under portbench/entries/, says where its
    replies end (``output``), the limit of each number its judge reads
    (``limits``), the layers its traced run times (``probes``, spans of
    tracing.Probe), and implements ``pool``, ``call``, ``judge``,
    ``control`` and ``work``."""

    output = "host"
    limits: dict = {}
    probes: tuple = ()

    def __init__(self, port, cfg: dict, mix: dict, device):
        if mix["output"] != self.output:
            raise ValueError(f"{mix['entry']} replies with its output on "
                             f"the {self.output}, the mix says "
                             f"{mix['output']}")
        self.port, self.cfg, self.mix, self.device = port, cfg, mix, device
        self.batch = int(mix["batch"])
        self.inputs = None

    def setting(self, key: str):
        """A setting of the mix, else of the configuration."""
        return self.mix.get(key, self.cfg.get(key))

    def frames(self, seed: int):
        """The seeded P010 pool: uint16 (n, h, w) luma, (n, h/2, w) CbCr."""
        c = self.cfg
        return content.pool(c["height"], c["width"],
                            int(self.mix["pool_frames"]), seed)

    def files(self, seed: int) -> list[bytes]:
        """The JPEG/R files of the seeded P010 pool, written by the plain
        reference (reference/writer.py) on the run's device."""
        y, uv = self.frames(seed)
        return [writer.encode_jpegr(self.cfg, y[i], uv[i], self.device)
                for i in range(len(y))]

    def pool(self, seed: int) -> list[Request]:
        """The requests of a run, from its seed; sets ``inputs``."""
        raise NotImplementedError

    def call(self, payload) -> list:
        """One request through the program: one output a frame."""
        raise NotImplementedError

    def judge(self, frame: int, output) -> dict:
        """The numbers of ``limits`` for one output of pool frame
        `frame`, against the plain reference."""
        raise NotImplementedError

    def control(self, frame: int) -> dict:
        """The same numbers with the control (the reference in a lower
        precision) in the program's place."""
        raise NotImplementedError

    def work(self, frames: int, counters: dict) -> dict | None:
        """The stage work of `frames` frames for roofline.least_seconds,
        from the probes' counters of the traced stretch; None where
        there is nothing to count."""
        return None


def batches(n: int, batch: int) -> list[tuple]:
    """Pool frames 0..n-1 in requests of `batch`."""
    return [tuple(range(i, min(i + batch, n))) for i in range(0, n, batch)]


class Reservoir:
    """A uniform sample of k of the replies offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: list = []
        self.seen = 0
        self._lock = threading.Lock()

    def offer(self, item):
        with self._lock:
            self.seen += 1
            if len(self.items) < self.k:
                self.items.append(item)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.k:
                    self.items[j] = item


@dataclass
class LoopResult:
    latencies: list = field(default_factory=list)   # replies in the window
    replied: list = field(default_factory=list)     # their reply times
    frames: int = 0             # frames of the replies in the window
    attempted: int = 0          # requests sent in the window
    failed: int = 0
    late: int = 0               # replies that came after the window
    frames_run: int = 0         # frames of every request sent
    errors: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)


def closed_loop(entry: Entry, pool: list[Request], clients: int,
                seconds: float, keep: Reservoir | None, spans=None,
                on_start=None) -> LoopResult:
    """`clients` threads, each sending its next request when its reply
    is in, for `seconds`; then every request in flight is waited for
    (and counted as late). `on_start()` runs once all clients are ready,
    just before the window opens."""
    res = LoopResult()
    lock = threading.Lock()
    ready = threading.Barrier(clients + 1)
    window = [0.0, 0.0]

    def client(c: int):
        k = 0
        ready.wait()
        ready.wait()
        end = window[1]
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                return
            req = pool[(c + clients * k) % len(pool)]
            k += 1
            with lock:
                res.attempted += 1
                res.frames_run += len(req.frames)
            try:
                out = entry.call(req.payload)
                ok = len(out) == len(req.frames)
                err = None if ok else (
                    f"{len(out)} outputs for {len(req.frames)} frames")
            except Exception:  # a failed request counts; the run goes on
                out, ok, err = None, False, traceback.format_exc()
            t1 = time.perf_counter()
            if spans is not None:
                spans.add("request", t0, t1)
            with lock:
                if not ok:
                    res.failed += 1
                    if len(res.errors) < 3:
                        res.errors.append(err)
                elif t1 <= end:
                    res.latencies.append(t1 - t0)
                    res.replied.append(t1)
                    res.frames += len(req.frames)
                else:
                    res.late += 1
            if ok and keep is not None:
                keep.offer((req, out))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    if on_start is not None:
        on_start()
    window[0] = time.perf_counter()
    window[1] = window[0] + seconds
    ready.wait()
    for t in threads:
        t.join(timeout=seconds + 120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish within two minutes of "
                           "the window's close")
    res.window = tuple(window)
    return res
