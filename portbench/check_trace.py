"""Checks the device trace's kernel times against CUDA events, on the card.

    python3 portbench/check_trace.py --workload <cell> --seed <n> \
        --requests <k>

The traced run's device_idle_pct and kernel_roofline_pct read kernel
intervals from the program's device trace (utils/profiler.py
device_trace). This runs k requests of the cell from one client under
that trace, with every kernel launch of the program (kernels/build.py
launch) bracketed by a pair of CUDA events, each pair queued behind a
spin kernel so that the kernel starts as soon as the first event
completes. It prints the kernels' time by the trace (the spin kernels
left out) beside the sum of the event pairs' times, and their ratio.
"""

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from libultrahdr_dev_tpu_torch.kernels import build
    from portbench import harness, tracing

    cell = harness.find_cell(args.workload)
    port = harness.import_port()
    dev = torch.device("cuda")
    entry = harness.make_entry(cell, port, dev)
    pool = entry.pool(args.seed)
    for req in pool:
        entry.call(req.payload)
    torch.cuda.synchronize()
    pairs = []
    launch = build.launch

    def bracketed(tensor, *a, **k):
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(tensor, *a, **k)
        e1.record()
        pairs.append((e0, e1))
        return out

    logdir = os.path.join(harness.CACHE, "check")
    for old in glob.glob(os.path.join(logdir, "trace_*.json")):
        os.remove(old)
    build.launch = bracketed
    rf = torch.profiler.record_function("portbench.window")
    try:
        with port.profiler.device_trace(logdir):
            t0 = time.perf_counter()
            rf.__enter__()
            for i in range(args.requests):
                entry.call(pool[i % len(pool)].payload)
            torch.cuda.synchronize()
            rf.__exit__(None, None, None)
            t1 = time.perf_counter()
    finally:
        build.launch = launch
    path = sorted(glob.glob(os.path.join(logdir, "trace_*.json")))[-1]
    trace = tracing.read_chrome_trace(path, "portbench.window", t0,
                                      (t0 - 1.0, t1 + 1.0))
    os.remove(path)
    names = sorted({o[0] for o in trace.kernels()})
    spin = [n for n in names if "spin" in n.lower() or "sleep" in n.lower()]
    # The program's own kernels: PyTorch's (at::) are not launched
    # through build.launch and have no event pair.
    ours = [o for o in trace.kernels()
            if o[0] not in spin and not o[0].startswith("at::")]
    trace_s = sum(o[3] - o[2] for o in ours)
    event_s = sum(e0.elapsed_time(e1) for e0, e1 in pairs) / 1e3
    print(json.dumps({
        "workload": args.workload, "requests": args.requests,
        "launches": len(pairs), "trace_kernels": len(ours),
        "spin_names": spin, "trace_kernel_s": trace_s,
        "event_kernel_s": event_s,
        "trace_over_events": trace_s / event_s if event_s else None,
        "trace_busy_s": tracing.busy_seconds(trace.ops),
        "kernel_names": names}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
