"""The traced window split by the program's spans (`fiber_torch/utils/
profiling.py::span`): host events named `train.forward`, `det.head`,
`rerank.pairs` and the like, on the profiler's clock like every other
event of the trace.

A span's idle time is the length of the device's idle intervals (the
complement of `Trace.busy_intervals()`) that overlaps the span's host
intervals.  A span's busy time is the device time of the operations whose
launching runtime call (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...) starts
inside the span's host intervals; it needs each device operation's launch,
which `LinkedTrace` keeps and `Trace` does not.  Both are inclusive of
child spans, and each is divided by the number of outer spans (steps,
passes or calls) in the window.  A reduction returns None where the trace
holds no such span.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench.harness.trace import Trace


def union(iv: np.ndarray) -> np.ndarray:
    """The union of (n, 2) ns intervals, as sorted disjoint intervals
    (`Trace.busy_intervals`' rule, for any intervals)."""
    if not len(iv):
        return np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > run_end[:-1]
    idx = np.flatnonzero(new)
    return np.stack([iv[idx, 0], np.append(run_end[idx[1:] - 1],
                                           run_end[-1])], axis=1)


def overlap_ns(a: np.ndarray, b: np.ndarray) -> int:
    """The length of the intersection of two sets of sorted disjoint
    intervals."""
    if not len(a) or not len(b):
        return 0
    edges = np.unique(np.concatenate([a.ravel(), b.ravel()]))
    mids = (edges[:-1] + edges[1:]) / 2

    def inside(iv):
        i = np.searchsorted(iv[:, 0], mids, side="right") - 1
        return (i >= 0) & (mids < iv[np.maximum(i, 0), 1])
    return int(np.diff(edges)[inside(a) & inside(b)].sum())


def minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted disjoint intervals a less sorted disjoint intervals b."""
    out = []
    for s, e in a.tolist():
        for bs, be in b[(b[:, 1] > s) & (b[:, 0] < e)].tolist():
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
        if s < e:
            out.append((s, e))
    return np.array(out, np.int64).reshape(-1, 2)


def intervals(trace: Trace, name: str) -> np.ndarray:
    """The host intervals of the spans named `name`, united."""
    hs, he, hn = trace.host
    hit = np.array([n == name for n in hn], bool)
    return union(np.stack([hs[hit], he[hit]], axis=1))


def count(trace: Trace, name: str) -> int:
    """The number of spans named `name` in the window."""
    return sum(n == name for n in trace.host[2])


def idle_ms(trace: Trace, name: str, per: str,
            but_not: Optional[str] = None) -> Optional[float]:
    """Device-idle ms while the host is in `name` (and not in `but_not`),
    per span `per`."""
    n = count(trace, per)
    spans = intervals(trace, name)
    if not n or not len(spans):
        return None
    if but_not is not None:
        spans = minus(spans, intervals(trace, but_not))
    inside = int((spans[:, 1] - spans[:, 0]).sum())
    return (inside - overlap_ns(spans, trace.busy_intervals())) / 1e6 / n


def busy_ms(trace: "LinkedTrace", name: str, per: str) -> Optional[float]:
    """Device-busy ms of the operations launched in `name`, per span
    `per`."""
    n = count(trace, per)
    spans = intervals(trace, name)
    if not n or not len(spans):
        return None
    i = np.searchsorted(spans[:, 0], trace.launch_ns, side="right") - 1
    hit = (i >= 0) & (trace.launch_ns <= spans[np.maximum(i, 0), 1])
    return float((trace.ends - trace.starts)[hit].sum()) / 1e6 / n


class LinkedTrace(Trace):
    """A `Trace` that also keeps, for each device operation, the host
    start of the call into CUDA that launched it (`launch_ns`, in the
    order of `starts`; -1 where the trace holds no launch).  A device
    operation's `correlation_id()` is that of the CUDA API call
    (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...; its
    `linked_correlation_id()` is the enclosing torch operation's, in
    another range of numbers on PyTorch 2.11)."""

    def _read(self, events) -> None:
        import torch
        super()._read(events)
        cuda = torch.autograd.DeviceType.CUDA
        launch, dev = {}, []
        for e in events:
            if e.is_user_annotation():
                continue
            if e.device_type() == cuda:
                dev.append((e.start_ns(), e.duration_ns(), e.name(),
                            e.correlation_id()))
            elif e.name().startswith("cu"):
                launch[e.correlation_id()] = e.start_ns()
        dev.sort()
        self.launch_ns = np.array([launch.get(r[3], -1) for r in dev],
                                  np.int64)
