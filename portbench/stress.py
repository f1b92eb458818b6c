"""Counts a cell's failed requests at a given number of clients.

    python3 portbench/stress.py --workload <cell> --seeds <n> ... \
        --clients <c> --seconds <s>

For each seed: the cell's pool and warm-up, then its closed loop with
--clients client threads for --seconds, untimed and unjudged; prints a
JSON line of requests sent and failed, and the first errors. Used to
show a fault of the program that only concurrent clients reach."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--clients", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import drive, harness

    cell = harness.find_cell(args.workload)
    port = harness.import_port()
    for seed in args.seeds:
        entry = harness.make_entry(cell, port, "cuda")
        pool = entry.pool(seed)
        for req in pool:
            entry.call(req.payload)
        res = drive.closed_loop(entry, pool, args.clients, args.seconds,
                                None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "clients": args.clients, "seconds": args.seconds,
                          "attempted": res.attempted, "failed": res.failed,
                          "errors": [e.strip().splitlines()[-1]
                                     for e in res.errors]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
