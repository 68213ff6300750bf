"""Benchmark of petit_kernel_tpu_torch: one served cell a run.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` builds the cell's model from the seed, serves the cell's
traffic for `s` seconds and prints one JSON line. Configurations, traffic
mixes, cells, per-layer metrics and kernel families are data files found
by name (spec.py); nothing here imports JAX or the JAX package.
"""
