"""ALBEF-style ITC feature and raw-input queue on the device.

The PyTorch counterpart of `fiber_tpu/parallel/itc_queue.py::ItcQueue`:
five ring buffers (normalised image and text features in fp32, the raw
images in the compute dtype, the text ids and masks) plus the ring pointer
and the lifetime count, all on one device.  The JAX queue is functional
(`enqueue` returns a new queue); this one is written in place, so the
4096-slot raw-image ring (3.6 GB at 384^2 bf16) is never copied.  `ptr`
and `total` are 0-dim device tensors, so enqueueing needs no host sync.

The feature rings start as standard normal draws from a generator, as the
reference's buffers do: their random content takes part in the contrastive
denominator until it is overwritten.  The queue lives on the card unless
the caller names another device (`device="cpu"`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class ItcQueue:
    def __init__(self, queue_size: int, hidden_size: int, image_size: int,
                 max_text_len: int, input_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        kw = dict(device=device)
        self.image_feats = torch.randn(queue_size, hidden_size,
                                       generator=generator, **kw)
        self.text_feats = torch.randn(queue_size, hidden_size,
                                      generator=generator, **kw)
        self.image_inputs = torch.zeros(queue_size, image_size, image_size, 3,
                                        dtype=input_dtype, **kw)
        self.text_inputs = torch.zeros(queue_size, max_text_len,
                                       dtype=torch.long, **kw)
        self.text_masks = torch.zeros(queue_size, max_text_len,
                                      dtype=torch.long, **kw)
        self.ptr = torch.zeros((), dtype=torch.long, **kw)
        self.total = torch.zeros((), dtype=torch.long, **kw)

    @property
    def size(self) -> int:
        return self.image_feats.shape[0]

    @torch.no_grad()
    def enqueue(self, image_feat: torch.Tensor, text_feat: torch.Tensor,
                image_input: torch.Tensor, text_input: torch.Tensor,
                text_mask: torch.Tensor) -> None:
        """Ring-buffer write of the batch, in place; no gradients flow."""
        bs = image_feat.shape[0]
        idx = (self.ptr + torch.arange(bs, device=self.ptr.device)) % self.size
        self.image_feats.index_copy_(0, idx, image_feat.detach().float())
        self.text_feats.index_copy_(0, idx, text_feat.detach().float())
        self.image_inputs.index_copy_(
            0, idx, image_input.detach().to(self.image_inputs.dtype))
        self.text_inputs.index_copy_(0, idx, text_input.long())
        self.text_masks.index_copy_(0, idx, text_mask.long())
        self.ptr.copy_((self.ptr + bs) % self.size)
        self.total.add_(bs)

    def valid_count(self) -> torch.Tensor:
        """Filled slots: the lifetime count, saturated at the size."""
        return self.total.clamp(max=self.size)

    _FIELDS = ("image_feats", "text_feats", "image_inputs", "text_inputs",
               "text_masks", "ptr", "total")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._FIELDS}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for k in self._FIELDS:
            dst = getattr(self, k)
            if tuple(state[k].shape) != tuple(dst.shape):
                raise ValueError(f"queue {k}: shape {tuple(state[k].shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(state[k])
