"""Readings that the limits of judge.py are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... --seconds <s>

In one process: for each of --seeds, a whole run of the cell (set-up, a
window of --seconds at the cell's own load, the judge) and its numbers,
the program's sound readings; then for each of --control-seeds the same
numbers read by the control, the reference computed in bfloat16 in the
program's place, on as many frames of that seed's pool as a run judges.
The last line of standard output is a JSON summary: each number's
largest sound reading and smallest control reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness, judge

    cell = harness.find_cell(args.workload)
    port = harness.import_port()
    sound, control = [], []
    for seed in args.seeds:
        t = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                args.device, cell=cell, port=port)
        row = {k: v["value"] for k, v in line["checks"].items()}
        row.update(seed=seed, correct=line["correct"])
        sound.append(row)
        print(json.dumps({"sound": row,
                          "s": round(time.perf_counter() - t, 1)}),
              flush=True)
    dev = torch.device(args.device)
    entry = harness.make_entry(cell, port, dev)
    for seed in args.control_seeds:
        entry.pool(seed)
        rows = [entry.control(fid)
                for fid in range(int(cell.mix["judge_frames"]))]
        row = judge.worst(rows, entry.limits)
        row["seed"] = seed
        control.append(row)
        print(json.dumps({"control": row}), flush=True)
    names = list(entry.limits)
    summary = {"workload": args.workload,
               "lower": {k: max(r[k] for r in sound) for k in names},
               "upper": {k: min(r[k] for r in control) for k in names},
               "all_correct": all(r["correct"] for r in sound),
               "seeds": len(sound), "control_seeds": len(control)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
