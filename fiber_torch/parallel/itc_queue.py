"""ALBEF-style ITC feature and raw-input queue on the device.

The PyTorch counterpart of `fiber_tpu/parallel/itc_queue.py::ItcQueue`:
five ring buffers (normalised image and text features in fp32, the raw
images in the compute dtype, the text ids and masks) plus the ring pointer
and the lifetime count, all on one device.  The JAX queue is functional
(`enqueue` returns a new queue); this one is written in place, so the
4096-slot raw-image ring (3.6 GB at 384^2 bf16) is never copied.  `ptr`
and `total` are 0-dim device tensors, so enqueueing needs no host sync.

Under data parallelism every rank enqueues the global batch, gathered in
rank order (`objectives/coarse.py::compute_itc`).  The feature rings,
`ptr` and `total` are whole and bit-equal on every rank: the contrastive
denominator reads them densely.  The three raw-input rings are split
along their slots over the data ranks, as `CoarseTrainer.shard_state`
places them in the JAX package: under a `group` of R > 1 ranks with
Q % R == 0, rank r holds slots [r Q / R, (r + 1) Q / R) and writes only
the rows of the global batch that land there (otherwise every rank holds
the whole rings).  `ring` reads any slots of a ring whole on every rank:
each owner fills the rows it holds and one all-reduce of their bytes sums
them, exactly.  `state_dict` gathers the rings and
`load_state_dict` slices them, so a checkpoint has one process's format
whatever the ranks.

The feature rings start as standard normal draws from a generator, as the
reference's buffers do: their random content takes part in the contrastive
denominator until it is overwritten.  The queue lives on the card unless
the caller names another device (`device="cpu"`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fiber_torch.parallel.data_parallel import (all_gather_rows,
                                                all_reduce_sum_, rank_world)

INPUT_RINGS = ("image_inputs", "text_inputs", "text_masks")


class ItcQueue:
    def __init__(self, queue_size: int, hidden_size: int, image_size: int,
                 max_text_len: int, input_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 group=None):
        kw = dict(device=device)
        self.image_feats = torch.randn(queue_size, hidden_size,
                                       generator=generator, **kw)
        self.text_feats = torch.randn(queue_size, hidden_size,
                                      generator=generator, **kw)
        rank, world = rank_world(group)
        self.sharded = world > 1 and queue_size % world == 0
        self.group = group if self.sharded else None
        # this rank's slots of the input rings: [lo, lo + slots)
        self.slots = queue_size // world if self.sharded else queue_size
        self.lo = rank * self.slots if self.sharded else 0
        self.image_inputs = torch.zeros(self.slots, image_size, image_size,
                                        3, dtype=input_dtype, **kw)
        self.text_inputs = torch.zeros(self.slots, max_text_len,
                                       dtype=torch.long, **kw)
        self.text_masks = torch.zeros(self.slots, max_text_len,
                                      dtype=torch.long, **kw)
        self.ptr = torch.zeros((), dtype=torch.long, **kw)
        self.total = torch.zeros((), dtype=torch.long, **kw)
        # `ptr` on the host, so that a rank finds its rows of a batch
        # without waiting for the device
        self._ptr = 0

    @property
    def size(self) -> int:
        return self.image_feats.shape[0]

    @torch.no_grad()
    def enqueue(self, image_feat: torch.Tensor, text_feat: torch.Tensor,
                image_input: torch.Tensor, text_input: torch.Tensor,
                text_mask: torch.Tensor) -> None:
        """Ring-buffer write of the (global) batch, in place; no gradients
        flow.  A sharded input ring takes the rows whose slots it holds."""
        bs, dev = image_feat.shape[0], self.ptr.device
        idx = (self.ptr + torch.arange(bs, device=dev)) % self.size
        self.image_feats.index_copy_(0, idx, image_feat.detach().float())
        self.text_feats.index_copy_(0, idx, text_feat.detach().float())
        rows, slots = None, idx
        if self.sharded:
            slot = [(self._ptr + j) % self.size for j in range(bs)]
            mine = [j for j, k in enumerate(slot)
                    if self.lo <= k < self.lo + self.slots]
            rows = torch.tensor(mine, dtype=torch.long, device=dev)
            slots = torch.tensor([slot[j] - self.lo for j in mine],
                                 dtype=torch.long, device=dev)
        for ring, x in ((self.image_inputs, image_input),
                        (self.text_inputs, text_input),
                        (self.text_masks, text_mask)):
            x = x.detach() if rows is None else x.detach()[rows]
            ring.index_copy_(0, slots, x.to(ring.dtype))
        self.ptr.copy_((self.ptr + bs) % self.size)
        self._ptr = (self._ptr + bs) % self.size
        self.total.add_(bs)

    def ring(self, name: str):
        """The input ring `name` as the negatives' gather reads it: the
        tensor when whole, else a view with the whole ring's shape whose
        rows by slot are read from their owners (a collective)."""
        if self.sharded:
            return _ShardedRing(self, name)
        return getattr(self, name)

    def input_bytes(self) -> int:
        """The bytes of this rank's input rings."""
        return sum(getattr(self, k).numel() * getattr(self, k).element_size()
                   for k in INPUT_RINGS)

    def valid_count(self) -> torch.Tensor:
        """Filled slots: the lifetime count, saturated at the size."""
        return self.total.clamp(max=self.size)

    _FIELDS = ("image_feats", "text_feats", "image_inputs", "text_inputs",
               "text_masks", "ptr", "total")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """One process's queue; sharded, every rank of the group calls it
        and gets the input rings gathered whole."""
        return {k: (all_gather_rows(getattr(self, k), self.group)
                    if k in INPUT_RINGS else getattr(self, k))
                for k in self._FIELDS}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Restore one process's queue (a sharded ring takes its slots)."""
        for k in self._FIELDS:
            dst, src = getattr(self, k), state[k]
            if k in INPUT_RINGS:
                if src.shape[0] != self.size:
                    raise ValueError(f"queue {k}: {src.shape[0]} slots, "
                                     f"expected {self.size}")
                src = src[self.lo:self.lo + self.slots]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"queue {k}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(src)
        self._ptr = int(self.ptr)


class _ShardedRing:
    """A sharded input ring seen whole: its shape, and its rows by slot."""

    def __init__(self, queue: ItcQueue, name: str):
        self.queue, self.ring = queue, getattr(queue, name)
        self.shape = (queue.size,) + tuple(self.ring.shape[1:])

    @torch.no_grad()
    def __getitem__(self, slots: torch.Tensor) -> torch.Tensor:
        """Rows `slots` (each in [0, Q)), whole; every rank of the group
        asks for the same slots.  Each fills the rows it holds, zeros
        elsewhere, and the bytes are summed over the ranks (one non-zero
        term each: exact)."""
        q, ring = self.queue, self.ring
        local = slots - q.lo
        own = (local >= 0) & (local < q.slots)
        rows = ring[local.clamp(0, q.slots - 1)]
        rows = torch.where(own.reshape((-1,) + (1,) * (ring.dim() - 1)),
                           rows, torch.zeros_like(rows))
        raw = rows.contiguous().view(torch.uint8)
        return all_reduce_sum_(raw, q.group).view(ring.dtype)
