"""The benchmark of `aresdb_tpu_torch`, the PyTorch and CUDA port.

`run.py` is the entry; every configuration, traffic mix, query set and
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it.
"""
