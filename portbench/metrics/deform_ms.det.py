"""Per-layer metric `deform_ms.det` (BENCHMARK.json): the device ms a pass
of the operations whose name holds `deform_im2col` (the DyHead's
deformable sampling kernel, `fiber_torch/csrc/deform_im2col.cu`), over the
traced window's `det.pass` spans.  Nothing to read where the program has
no such kernel."""

from portbench.harness import spans


def read(run):
    passes = spans.count(run.trace, "det.pass")
    spent = run.trace.device_s(("deform_im2col",))
    return spent * 1e3 / passes if passes and spent else None
