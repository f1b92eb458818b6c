"""The benchmark of libultrahdr_dev_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The cell
is a workload of BENCHMARK.json. With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each beside whether the outputs were correct; the
last lines of standard error give each number compared and its limit.
Without a CUDA device, or with fewer than the cell asks for, the run
exits with code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell.spec["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell.spec['chips']}", file=sys.stderr)
        return 3
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START, cell)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
