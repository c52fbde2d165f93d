"""Per-layer metric `forward_idle_ms.train` (BENCHMARK.json): the
device-idle ms a step while the host is in the span `train.forward` (the
losses: staging, towers, ITC and queue, mining, ITM, MLM);
`portbench/harness/spans.py::idle_ms`."""

from portbench.harness import spans


def read(run):
    return spans.idle_ms(run.trace, "train.forward", "train.step")
