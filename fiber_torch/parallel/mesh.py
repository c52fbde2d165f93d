"""The (data, model) device mesh and the batch shard of a rank.

The PyTorch counterpart of `fiber_tpu/parallel/mesh.py`.  There XLA
inserts the collectives of a global-view program; here the mesh is a
`torch.distributed` `DeviceMesh` whose `data` dimension names the process
group the trainers reduce over (`fiber_torch/parallel/data_parallel.py`)
and whose `model` dimension names the group a tensor-parallel model's
shards are gathered over (`fiber_torch/parallel/tp.py`).  Rank r of a
(data, model) mesh is data rank r // model and model rank r % model.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch.distributed as dist

from fiber_torch.parallel.multihost import is_distributed, process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: Optional[int] = None, model: int = 1):
    """A (data, model) `DeviceMesh` over every process of the running
    group.  Its device type follows the backend: "cuda" under NCCL, "cpu"
    under gloo (whose collectives also take CUDA tensors).  `data` times
    `model` must be the number of processes."""
    if not is_distributed():
        raise RuntimeError("create_mesh needs a process group: call "
                           "maybe_initialize_distributed first")
    n = process_count()
    data = data or n // model
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh over {n} processes")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh=None):
    """The process group the trainers reduce over: the mesh's `data`
    dimension, else the running group, else None (one process)."""
    if mesh is not None:
        return mesh.get_group(DATA_AXIS)
    return dist.group.WORLD if is_distributed() else None


def model_group(mesh=None):
    """The ranks that hold one data shard and split the model between
    them: the mesh's `model` dimension; None without a mesh or when that
    dimension is 1 (the model is whole on every rank)."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def shard_batch(batch: Mapping[str, Any], group=None) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors, the
    leading axis split evenly over `group`'s ranks, 0-dim entries kept);
    the batch itself with no group."""
    if group is None:
        return dict(batch)
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)

    def rows(x):
        if np.ndim(x) == 0:
            return x
        n = x.shape[0]
        if n % world:
            raise ValueError(f"a batch of {n} rows over {world} ranks")
        per = n // world
        return x[rank * per:(rank + 1) * per]
    return {k: rows(v) for k, v in batch.items()}

