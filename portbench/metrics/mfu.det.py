"""Per-layer metric `mfu.det` (BENCHMARK.json): `portbench/harness/readers.py::mfu`."""

from portbench.harness import readers


def read(run):
    return readers.mfu(run)
