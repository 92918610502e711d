"""The benchmark of ``repro_torch``: one cell (a configuration under one
traffic mix) run once by ``python3 bench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the root names
the cells, the metrics and their bounds; each configuration, traffic mix,
metric and set of limits sits in a file of its own under ``bench/``."""
