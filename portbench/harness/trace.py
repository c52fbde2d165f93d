"""The traced window: `torch.profiler` over the card and the host, reduced
to what the per-layer metrics read.

From the profiler's raw events (grouping them through `key_averages` takes
long at a window's size): every device operation (kernels, copies and
sets, not the ranges of user annotations) with its start and end; the
window's length by the host's clock between two synchronisations; the
seconds in which some operation ran on the device (the union of the
intervals); the device time by operation name; and the longest idle gaps
between device operations, each named by the innermost host operation
running at its middle ("python, outside torch ops" where none is).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np


class Trace:
    """Profiles the work inside `with Trace(): ...` when enabled; a
    disabled one does nothing and reads nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.window_s = 0.0
        self.names: List[str] = []
        self.starts = self.ends = np.zeros(0, np.int64)
        self.host: Tuple[np.ndarray, np.ndarray, List[str]] = (
            np.zeros(0, np.int64), np.zeros(0, np.int64), [])

    def __enter__(self) -> "Trace":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        del self._prof

    def _read(self, events) -> None:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in events:
            if e.is_user_annotation():
                continue
            row = (e.start_ns(), e.duration_ns(), e.name())
            (dev if e.device_type() == cuda else host).append(row)
        dev.sort()
        self.starts = np.array([r[0] for r in dev], np.int64)
        self.ends = self.starts + np.array([r[1] for r in dev], np.int64)
        self.names = [r[2] for r in dev]
        hs = np.array([r[0] for r in host], np.int64)
        self.host = (hs, hs + np.array([r[1] for r in host], np.int64),
                     [r[2] for r in host])

    # ------------------------------------------------------------------
    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals, (n, 2) ns."""
        if not len(self.starts):
            return np.zeros((0, 2), np.int64)
        order = np.argsort(self.starts, kind="stable")
        s, e = self.starts[order], self.ends[order]
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        ends = np.append(run_end[idx[1:] - 1], run_end[-1])
        return np.stack([s[idx], ends], axis=1)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def device_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of
        `patterns`."""
        d = (self.ends - self.starts)
        hit = [i for i, n in enumerate(self.names)
               if any(p in n for p in patterns)]
        return float(d[hit].sum()) / 1e9 if hit else 0.0

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, d in zip(self.names, (self.ends - self.starts).tolist()):
            out[n] = out.get(n, 0.0) + d / 1e9
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        iv = self.busy_intervals()
        gaps = []
        if len(iv) > 1:
            g0, g1 = iv[:-1, 1], iv[1:, 0]
            order = np.argsort(g0 - g1)[:top]       # longest first
            hs, he, hn = self.host
            for i in order:
                mid = (g0[i] + g1[i]) // 2
                inside = np.flatnonzero((hs <= mid) & (he >= mid))
                name = ("python, outside torch ops" if not len(inside) else
                        hn[inside[np.argmin(he[inside] - hs[inside])]])
                gaps.append([name, float(g1[i] - g0[i]) / 1e9])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
