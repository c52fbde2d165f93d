"""Per-layer metric `peak_gib.train` (BENCHMARK.json): `portbench/harness/readers.py::peak_gib`."""

from portbench.harness import readers


def read(run):
    return readers.peak_gib(run)
