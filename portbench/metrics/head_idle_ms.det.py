"""Per-layer metric `head_idle_ms.det` (BENCHMARK.json): the device-idle
ms a pass while the host is in the span `det.head` (the DyHead, the
module that `head_ms.det`'s hooks wrap);
`portbench/harness/spans.py::idle_ms`."""

from portbench.harness import spans


def read(run):
    return spans.idle_ms(run.trace, "det.head", "det.pass")
