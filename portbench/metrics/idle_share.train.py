"""Per-layer metric `idle_share.train` (BENCHMARK.json): `portbench/harness/readers.py::idle_share`."""

from portbench.harness import readers


def read(run):
    return readers.idle_share(run)
