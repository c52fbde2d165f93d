"""Per-layer metric `k2_roofline.train` (BENCHMARK.json): `portbench/harness/readers.py::k2_roofline`."""

from portbench.harness import readers


def read(run):
    return readers.k2_roofline(run)
