"""The benchmark of arrowspace_torch: one cell of BENCHMARK.json per run.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  Configurations, traffic
mixes and metrics are files found by the names BENCHMARK.json gives.
"""
