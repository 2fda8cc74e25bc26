"""The benchmark of styl3r_tpu_torch, the PyTorch and CUDA port:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository's root names the cells. Each cell's
parameters are data under portbench/: a configuration in
configs/<config>.json, a workload in workloads/<cell>.json that names its
traffic driver (drivers/<driver>.py), and one reader a per-layer metric in
metrics/<metric>.py. The yardstick (traffic, FLOP and byte counts, the
reference and the comparison) lives here and imports nothing of the
program's arithmetic; the program is only the system under test."""
