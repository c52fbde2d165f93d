"""Per-layer metric `tool_idle_ms.det` (BENCHMARK.json): the device-idle
ms a call while the host is in the span `det.call` (`predict_detections`)
but not in `det.forward` (the model): prompts, staging, anchors and
postprocess, read-back, merge; `portbench/harness/spans.py::idle_ms`."""

from portbench.harness import spans


def read(run):
    return spans.idle_ms(run.trace, "det.call", "det.call",
                         but_not="det.forward")
