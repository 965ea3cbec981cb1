"""The benchmark of ``repro_torch``: Table I's road and Kronecker graphs
through the front door. Run one cell with ``python3 ccbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
