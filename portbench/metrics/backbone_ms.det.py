"""Per-layer metric `backbone_ms.det` (BENCHMARK.json): the device ms of
the detector's backbone a pass, between the CUDA events of the
benchmark's forward hooks (`portbench/entries/detect.py::Spans`)."""

from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "backbone_ms")
