"""Training logging: smoothed meters + ETA + optional TensorBoard.

Behavioral spec: fine_grained utils/metric_logger.py:1-122 (MetricLogger
with median/avg smoothed meters and TensorboardLogger) and utils/logger.py
(per-process logging setup).

The port's copy of `fiber_tpu/utils/logging.py`.  `TensorboardWriter`
writes through torch's SummaryWriter (JAX's through tf.summary), imported
only when one is built, and is a no-op where it does not import (it needs
the tensorboard package).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Optional


def setup_logger(name: str = "fiber_torch",
                 output_dir: Optional[str] = None,
                 rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    if rank == 0:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(output_dir, f"log.rank{rank}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Window-median/average meter (ref metric_logger.py SmoothedValue)."""

    def __init__(self, window: int = 20):
        self.deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else float("nan")

    @property
    def avg(self) -> float:
        return (sum(self.deque) / len(self.deque)) if self.deque else \
            float("nan")

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else float("nan")


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self._start = time.time()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def eta(self, step: int, max_steps: int) -> str:
        elapsed = time.time() - self._start
        if step == 0:
            return "?"
        remain = elapsed / step * (max_steps - step)
        h, rem = divmod(int(remain), 3600)
        m, s = divmod(rem, 60)
        return f"{h}:{m:02d}:{s:02d}"

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{k}: {m.median:.4f} ({m.global_avg:.4f})"
            for k, m in sorted(self.meters.items()))


class TensorboardWriter:
    """Thin TB scalar writer (torch's SummaryWriter; no-op if it does not
    import)."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(logdir)
        except Exception:
            self._writer = None

    def scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
