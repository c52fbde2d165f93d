"""Process-group bring-up and host-side gathers for data-parallel runs.

The PyTorch counterpart of `fiber_tpu/parallel/multihost.py`, over
`torch.distributed`:

* the rendezvous reads the same environment: `FIBER_COORDINATOR=host:port`
  with `FIBER_NUM_PROCESSES` and `FIBER_PROCESS_ID` becomes
  `init_process_group(init_method="tcp://host:port", world_size, rank)`;
  `FIBER_COORDINATOR=auto` defers to the launcher's environment
  (`env://`: `MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, as
  `torchrun` sets them), as JAX's `auto` defers to its own;
* the backend is NCCL when the card is there and gloo on the host, unless
  the caller names one (two ranks on one card need gloo);
* a rank's card is `cuda:<LOCAL_RANK>` where the launcher set it, else its
  process id modulo the host's card count;
* the object gathers for merging evaluations (`gather_objects`,
  `merge_eval_predictions`, `process_allgather`) go through
  `all_gather_object`.

Every helper degrades to the identity with no process group, so the same
scripts run in one process and in many.  A configured rendezvous that
fails raises: a run never carries on alone.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may wait before it raises
DEFAULT_TIMEOUT_S = 600.0


def is_distributed() -> bool:
    """True when a process group is up (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 with no process group."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes; 1 with no process group."""
    return dist.get_world_size() if is_distributed() else 1


def print0(*args, **kwargs) -> None:
    """`print` on process 0 only (every process with no group)."""
    if process_index() == 0:
        print(*args, **kwargs)


def local_device_index() -> int:
    """This rank's card on its host: `LOCAL_RANK` where the launcher set
    it, else the process id modulo the host's card count (0 without a
    card)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    return process_index() % n if n else 0


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S
                                 ) -> bool:
    """Start the process group if one is configured; True when a group of
    more than one process is (or already was) up.

    Configuration, in order: the arguments, then `FIBER_COORDINATOR` /
    `FIBER_NUM_PROCESSES` / `FIBER_PROCESS_ID`, then nothing (one process,
    False).  `backend` defaults to "nccl" with a card and "gloo" without;
    under NCCL the rank's card becomes the current device.  The rendezvous
    and every later collective wait at most `timeout_s`; a rendezvous that
    fails raises."""
    if is_distributed():
        return process_count() > 1
    coordinator = coordinator or os.environ.get("FIBER_COORDINATOR")
    if coordinator is None:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator == "auto":
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        num_processes = num_processes or int(
            os.environ["FIBER_NUM_PROCESSES"])
        process_id = (process_id if process_id is not None
                      else int(os.environ["FIBER_PROCESS_ID"]))
        init = (coordinator if "://" in coordinator
                else f"tcp://{coordinator}")
        dist.init_process_group(backend, init_method=init,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local_device_index())
    return process_count() > 1


def rank_device(device) -> torch.device:
    """`device` for this rank: a bare "cuda" becomes this rank's card under
    a process group; anything else is returned as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        return torch.device("cuda", local_device_index())
    return dev


def gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable `obj`, in rank order, on every process;
    [obj] with no process group."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def process_allgather(x) -> np.ndarray:
    """Every process's array stacked along a new leading axis, (P, ...)."""
    return np.stack([np.asarray(a) for a in gather_objects(np.asarray(x))])


def merge_eval_predictions(local: dict) -> dict:
    """The union of every process's {image_id: prediction} dict."""
    merged: dict = {}
    for part in gather_objects(local):
        merged.update(part)
    return merged


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of a global batch."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier across the processes (no-op with no process group);
    `name` is kept for the JAX package's signature."""
    del name
    if is_distributed():
        dist.barrier()
