"""Per-layer metric `backward_idle_ms.train` (BENCHMARK.json): the
device-idle ms a step while the host is in the span `train.backward`
(autograd's backward, with remat's recompute);
`portbench/harness/spans.py::idle_ms`."""

from portbench.harness import spans


def read(run):
    return spans.idle_ms(run.trace, "train.backward", "train.step")
