"""One run of one cell: set-up, the measured window, the check.

``run_cell`` finds the cell in BENCHMARK.json, its configuration in
``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json``, the mix's entry point in
``portbench/entries/<entry>.py`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``, all by name, so a later cell, entry
or metric is files and entries, never an edit here. It then

1. makes the mix's input pool from the seed and warms up every request
   of it, alone and then with every client at once (set-up ends here);
2. runs the closed loop for the window, untraced (``trace=False``: the
   end-to-end metrics), or traced (``trace=True``: host spans around the
   layers that the entry's and the metrics' probes name, and the
   program's device trace, over a stretch of at most TRACE_SECONDS; the
   per-layer metrics);
3. reads the peak of device memory, frees the program's state, and
   judges a seeded sample of the replies against the plain reference
   (judge.py);
4. returns the result line.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from . import drive, judge, roofline, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
TRACE_SECONDS = 8.0
FORBIDDEN = ("jax", "jaxlib", "flax", "libultrahdr_dev_tpu")
PORT = "libultrahdr_dev_tpu_torch"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    spec: dict          # the workload's entry of BENCHMARK.json
    config: dict
    mix: dict
    end_to_end: list    # metric entries of BENCHMARK.json for this cell
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files, found by name."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    specs = [w for w in bench["workloads"] if w["name"] == name]
    if not specs:
        raise KeyError(f"no workload {name} in BENCHMARK.json")
    spec = specs[0]
    conf = [c for c in bench["configs"] if c["name"] == spec["config"]][0]
    return Cell(spec, load_json(os.path.join(root, conf["file"])),
                load_json(os.path.join(root, "portbench", "traffic",
                                       spec["traffic"] + ".json")),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _load(kind: str, name: str, root: str):
    """The module portbench/<kind>/<name>.py, loaded from its file."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` of portbench/metrics/<name>.py."""
    return _load("metrics", name, root).read


def metric_probes(name: str, root: str = ROOT) -> tuple:
    """The probes (tracing.Probe) that metric `name` reads, if any."""
    return tuple(getattr(_load("metrics", name, root), "PROBES", ()))


def entry_class(name: str, root: str = ROOT):
    """The class Entry of portbench/entries/<name>.py."""
    return _load("entries", name, root).Entry


def make_entry(cell: Cell, port, device, root: str = ROOT) -> drive.Entry:
    return entry_class(cell.mix["entry"], root)(
        port, cell.config, cell.mix, torch.device(device))


def import_port():
    """The program under test: the PyTorch and CUDA package."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from libultrahdr_dev_tpu_torch import api, types
    from libultrahdr_dev_tpu_torch.parallel import batched
    from libultrahdr_dev_tpu_torch.utils import profiler
    return SimpleNamespace(api=api, types=types, batched=batched,
                           profiler=profiler, torch=torch)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _warm(entry: drive.Entry, pool: list, clients: int):
    """Every request of the pool once, then one at every client at once."""
    for req in pool:
        entry.call(req.payload)
    threads = [threading.Thread(target=entry.call,
                                args=(pool[c % len(pool)].payload,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def wrap_probes(probes, spans: tracing.Spans):
    """Puts each probe's span around its function of the program, one
    probe a span name; returns the names and a function that puts the
    functions back."""
    chosen: dict = {}
    for p in probes:
        q = chosen.get(p.span)
        if q is not None and (q.module, q.attr) != (p.module, p.attr):
            raise ValueError(f"span {p.span} names two functions")
        if q is None or (q.count is None and p.count is not None):
            chosen[p.span] = p
    restores = [spans.wrap(importlib.import_module(f"{PORT}.{p.module}"),
                           p.attr, p.span, p.count)
                for p in chosen.values()]

    def restore():
        for r in reversed(restores):
            r()

    return tuple(chosen), restore


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads."""

    config: dict
    frames: int             # frames of every request of the stretch
    spans: tracing.Spans
    trace: tracing.DeviceTrace
    work: dict | None       # the entry's stage work of those frames


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             cell: Cell | None = None, port=None,
             root: str = ROOT) -> dict:
    """One run; returns the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or find_cell(name, root=root)
    cfg, mix = cell.config, cell.mix
    port = port or import_port()
    dev = torch.device(device)
    entry = make_entry(cell, port, dev, root)
    pool = entry.pool(seed)
    if dev.type == "cuda":
        # The inputs are the benchmark's; the peak read later is the
        # program's from here on.
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    clients = int(mix["clients"])
    _warm(entry, pool, clients)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s: {len(pool)} requests of {entry.batch} "
        f"frame(s) in the pool, {clients} clients, {mix['entry']}")

    keep = drive.Reservoir(math.ceil(mix["judge_frames"] / entry.batch),
                           seed)
    extra: dict = {}
    if trace:
        window_s = min(seconds, TRACE_SECONDS)
        spans = tracing.Spans()
        probes = list(entry.probes)
        for m in cell.per_layer:
            probes += metric_probes(m["name"], root)
        layers, restore = wrap_probes(probes, spans)
        logdir = os.path.join(CACHE, "trace")
        for old in glob.glob(os.path.join(logdir, "trace_*.json")):
            os.remove(old)
        marker = {}
        rf = torch.profiler.record_function("portbench.window")

        def on_start():
            marker["t0"] = time.perf_counter()
            rf.__enter__()

        try:
            with port.profiler.device_trace(logdir):
                res = drive.closed_loop(entry, pool, clients, window_s,
                                        keep, spans, on_start)
                rf.__exit__(None, None, None)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_stop = time.perf_counter()
        finally:
            restore()
        path = sorted(glob.glob(os.path.join(logdir, "trace_*.json")))[-1]
        dtrace = tracing.read_chrome_trace(
            path, "portbench.window", marker["t0"], (res.window[0], t_stop))
        os.remove(path)
        work = entry.work(res.frames_run, spans.counters)
        run = TracedRun(cfg, res.frames_run, spans, dtrace, work)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = tracing.busy_seconds(dtrace.ops)
        extra = {"busy_s": busy, "window_s": dtrace.window_s}
        stage = "no stage work counted"
        if work is not None:
            least, by = roofline.least_seconds(work)
            stage = (f"stage work {work['bytes'] / 1e6:.1f} MB, least "
                     f"{least:.6f} s (by {by})")
        log(f"traced stretch {dtrace.window_s:.4f} s, {res.attempted} "
            f"requests, {res.frames_run} frames; device busy {busy:.6f} s; "
            f"{stage}; card {power_limit()}")
        breakdown = tracing.breakdown(dtrace, spans, layers)
    else:
        res = drive.closed_loop(entry, pool, clients, seconds, keep)
        lat = np.asarray(res.latencies)
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        if lat.size:
            metrics["frames_per_s"] = {"value": res.frames / seconds,
                                       "unit": "frames/s"}
            metrics["latency_p95_ms"] = {
                "value": float(np.percentile(lat, 95)) * 1e3, "unit": "ms"}
        quarters = np.histogram(res.replied, 4, (res.window[0],
                                                  res.window[1]))[0]
        log(f"replies in each quarter of the window: {quarters.tolist()}")
        log(f"window {seconds} s: {lat.size} replies in it "
            f"({res.frames} frames), median "
            f"{float(np.median(lat)) * 1e3 if lat.size else 0:.3f} ms, "
            f"{res.late} late, {res.failed} failed of {res.attempted}")
        breakdown = None
        reported = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in reported}
    for e in res.errors:
        log(f"failed request: {e}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    samples = keep.items
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = [entry.judge(fid, out) for req, outs in samples
            for fid, out in zip(req.frames, outs)]
    numbers = judge.worst(rows, entry.limits)
    ok, checks = judge.verdict(entry.limits, numbers)
    for r in rows:
        for f in r.get("fault_list", [])[:5]:
            log(f"fault: {f}")
    correct = bool(ok and rows and res.failed == 0 and res.attempted > 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run holds modules it may not load: {found}")
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(peak), **extra}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line
