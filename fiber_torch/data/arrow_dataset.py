"""pyarrow-backed caption datasets (compatible with the reference's .arrow
files) + per-host sharded batching.

The reference memory-maps pyarrow tables with columns
[image (bytes), caption (list<str>), image_id, split] and flattens
(image, caption) pairs through an index_mapper (ref: base_dataset.py:11-150).
This reader keeps that on-disk format so existing prepared data works
unchanged, but replaces the torch DataLoader + DistributedSampler stack
with a per-host deterministic shard iterator feeding numpy batches
(SURVEY.md §2.3 "node-aware data sharding").

The port's copy of `fiber_tpu/data/arrow_dataset.py`: pyarrow and PIL are
imported inside the methods that need them, and `stage_image` stages for
the port's on-device preprocessing (`data/device_transforms.py`).
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ArrowCaptionDataset:
    """Flattened (image, caption) view over one or more .arrow files."""

    def __init__(self, paths: Sequence[str], caption_column: str = "caption",
                 image_column: str = "image"):
        import pyarrow as pa
        tables = []
        for p in paths:
            with pa.memory_map(p, "r") as source:
                tables.append(pa.ipc.RecordBatchFileReader(source).read_all())
        self.table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        self.caption_column = caption_column
        self.image_column = image_column
        # index_mapper: flat idx -> (row, caption_idx)
        self.index: List[Tuple[int, int]] = []
        caps = self.table[caption_column].to_pylist()
        for row, cap_list in enumerate(caps):
            if isinstance(cap_list, str):
                cap_list = [cap_list]
            for j in range(len(cap_list)):
                self.index.append((row, j))
        self._captions = caps

    def __len__(self) -> int:
        return len(self.index)

    def get_caption(self, i: int) -> str:
        row, j = self.index[i]
        caps = self._captions[row]
        return caps if isinstance(caps, str) else caps[j]

    def get_image(self, i: int, size: int, train: bool = False,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
        from PIL import Image
        from fiber_torch.data.transforms import resize_image
        row, _ = self.index[i]
        raw = self.table[self.image_column][row].as_py()
        img = Image.open(io.BytesIO(raw))
        return resize_image(img, size, train=train, rng=rng)

    def stage_image(self, i: int, staging_size: int):
        """Decode-only host path for the on-device preprocessing pipeline
        (data/device_transforms.py): returns (uint8 (S0, S0, 3) staging
        buffer, (h, w) native size) — no PIL filtering on the host."""
        from PIL import Image
        from fiber_torch.data.device_transforms import stage_host
        row, _ = self.index[i]
        raw = self.table[self.image_column][row].as_py()
        img = Image.open(io.BytesIO(raw))
        return stage_host(img, staging_size)


class ShardedBatchIterator:
    """Infinite deterministic per-host iterator.

    Each host sees a disjoint 1/num_hosts slice each epoch (reseeded
    per-epoch global permutation), the replacement for
    DistributedSampler (ref: multitask_datamodule.py:46-49).
    """

    def __init__(self, n: int, batch_size: int, host_id: int = 0,
                 num_hosts: int = 1, seed: int = 0, drop_last: bool = True):
        assert batch_size % 1 == 0
        self.n = n
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.n)
        per_host = self.n // self.num_hosts
        return perm[self.host_id * per_host:(self.host_id + 1) * per_host]

    def __iter__(self) -> Iterator[np.ndarray]:
        epoch = 0
        while True:
            idx = self.epoch_indices(epoch)
            nb = len(idx) // self.batch_size
            for b in range(nb):
                yield idx[b * self.batch_size:(b + 1) * self.batch_size]
            epoch += 1
