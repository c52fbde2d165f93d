"""Per-layer metric `head_ms.det` (BENCHMARK.json): the device ms of
the detector's head a pass, between the CUDA events of the
benchmark's forward hooks (`portbench/entries/detect.py::Spans`)."""

from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "head_ms")
