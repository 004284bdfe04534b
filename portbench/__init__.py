"""The benchmark of the PyTorch and CUDA port (feat3dnet_tpu_torch).

One run of one cell: `python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`, from the root of a checkout. Configurations,
workloads and per-layer metrics are files found by name (configs/,
workloads/, metrics/); reference/ holds the plain PyTorch reference that
decides `correct`.
"""
