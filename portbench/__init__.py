"""The benchmark of libultrahdr_dev_tpu_torch: run with
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (see portbench/run.py)."""
