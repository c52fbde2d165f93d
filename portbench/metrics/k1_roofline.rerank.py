"""Per-layer metric `k1_roofline.rerank` (BENCHMARK.json): `portbench/harness/readers.py::k1_roofline`."""

from portbench.harness import readers


def read(run):
    return readers.k1_roofline(run)
