"""Checkpoint save and restore, with auto-resume and a best-metric record.

The port's counterpart of `fiber_tpu/train/checkpoint.py` (orbax there,
`torch.save` here) with its interface: `save(step, state, metrics)`,
`restore(step=None)` (the latest by default), `latest_step`, `best_value`,
`max_to_keep`, and `best.json` holding the step and value of the highest
`best_metric_name` seen.  `state` is any object `torch.save` takes, such
as `CoarseTrainer.state_dict()`; restore it with the trainer's
`load_state_dict`.

Each checkpoint is `step_<n>.pt` in the directory.  It is written to a
temporary file there and renamed, so a run cut while saving leaves the
previous checkpoints and no half-written one; the same goes for
`best.json`.  Under a process group every rank calls `save` with the same
state: rank 0 writes and every rank waits at a barrier until it has, so
that any rank may then restore.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, List, Optional

import torch

from fiber_torch.parallel.multihost import process_index, sync_global_devices

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    """`write(file object)` into a temporary file beside `path`, then
    rename it over `path`."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2,
                 best_metric_name: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric_name = best_metric_name
        self._best_path = os.path.join(self.directory, "best.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        """The steps saved, oldest first."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any,
             metrics: Optional[dict] = None) -> None:
        """Write `state` as step `step`, keep the newest `max_to_keep`, and
        record `metrics[best_metric_name]` in best.json when it beats the
        best so far (higher is better).  Under a process group rank 0
        writes; every rank returns once it has."""
        if process_index() == 0:
            self._write(step, state, metrics)
        sync_global_devices("checkpoint")

    def _write(self, step: int, state: Any, metrics: Optional[dict]) -> None:
        _atomic_write(self._path(step), lambda f: torch.save(state, f))
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.unlink(self._path(old))
        if metrics and self.best_metric_name in metrics:
            current = float(metrics[self.best_metric_name])
            best = self.best_value()
            if best is None or current > best:
                record = json.dumps({"step": step, "value": current})
                _atomic_write(self._best_path,
                              lambda f: f.write(record.encode()))

    def best_value(self) -> Optional[float]:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)["value"]
        return None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at `step` (default: the latest), its tensors on
        the devices they were saved from, or where `map_location` (as
        `torch.load` takes it) puts them.  Raises FileNotFoundError when
        there is none."""
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint"
                                    f"{'' if step is None else f' {step}'} "
                                    f"in {self.directory}")
        # mapped, not read: each storage is copied once, to where it goes
        return torch.load(self._path(step), weights_only=False,
                          map_location=map_location, mmap=True)
