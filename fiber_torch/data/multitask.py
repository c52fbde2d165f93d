"""Multitask dataset mixing (ref fiber/datamodules/multitask_datamodule.py:
MTDataModule concatenates the per-dataset modules — coco+vg+sbu+gcc for
pretraining — under one DistributedSampler).

`MultitaskIterator` samples batches from several sharded iterators with
probability proportional to dataset size (the concat-dataset equivalent),
deterministically per (seed, step).

The port's copy of `fiber_tpu/data/multitask.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from fiber_torch.data.arrow_dataset import ShardedBatchIterator


class MultitaskIterator:
    def __init__(self, sizes: Sequence[int], batch_size: int,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0):
        self.iters = [iter(ShardedBatchIterator(n, batch_size, host_id,
                                                num_hosts, seed + 31 * i))
                      for i, n in enumerate(sizes)]
        self.probs = np.asarray(sizes, np.float64) / sum(sizes)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        """Returns (dataset_index, indices) — the caller materializes the
        batch from the chosen dataset."""
        d = int(self.rng.choice(len(self.iters), p=self.probs))
        return d, next(self.iters[d])
