"""GLIP-style masked language modelling for the detection stack.

The PyTorch counterpart of `fiber_tpu/detection/mlm.py`: `random_word`
masking with greenlight maps, run as one vectorised decision on uniform
draws from an explicit generator, and the MLM cross-entropy:

    greenlight == -1       -> never masked, label -100
    token == pad           -> never masked, label -100
    u >= mask_prob         -> unmasked, label -100
    u < mask_prob:  u/p < 0.8  -> <mask>              } label = original id
                    u/p < 0.9  -> a random vocab id   } (then -100 wherever
                    else       -> unchanged           }  greenlight != 1)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

IGNORE_INDEX = -100


def random_word_mask(generator: Optional[torch.Generator],
                     input_ids: torch.Tensor, mask_token_id: int,
                     vocab_size: int, pad_token_id: int,
                     greenlight_map: Optional[torch.Tensor] = None,
                     mask_prob: float = 0.15,
                     probs: Optional[torch.Tensor] = None,
                     rand_tokens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids (B, T); greenlight_map (B, T) in {-1, 0, 1} or None.
    `probs` (uniform in [0, 1)) and `rand_tokens` (ids in [0, vocab_size))
    are drawn from `generator` unless given.  Returns (masked ids,
    labels)."""
    if probs is None:
        probs = torch.rand(input_ids.shape, device=input_ids.device,
                           generator=generator)
    if rand_tokens is None:
        rand_tokens = torch.randint(0, vocab_size, input_ids.shape,
                                    device=input_ids.device,
                                    generator=generator)
    probs = probs.to(input_ids.device)
    rand_tokens = rand_tokens.to(input_ids.device, input_ids.dtype)
    can_mask = (input_ids != pad_token_id) & (probs < mask_prob)
    if greenlight_map is not None:
        can_mask = can_mask & (greenlight_map != -1)
    sub = probs / mask_prob
    replacement = torch.where(
        sub < 0.8, torch.full_like(input_ids, mask_token_id),
        torch.where(sub < 0.9, rand_tokens, input_ids))
    masked_ids = torch.where(can_mask, replacement, input_ids)
    ignore = torch.full_like(input_ids, IGNORE_INDEX)
    labels = torch.where(can_mask, input_ids, ignore)
    if greenlight_map is not None:
        labels = torch.where(greenlight_map != 1, ignore, labels)
    return masked_ids, labels


def create_greenlight_map(spans: Sequence[Tuple[int, ...]],
                          offsets: Sequence[Tuple[int, int]],
                          max_len: int = 256) -> np.ndarray:
    """Char spans -> the (max_len,) greenlight map.  spans: [(beg, end),
    ...], the spans whose tokens may be masked and scored; an entry of
    another length makes the whole caption unmaskable (-1).  offsets: each
    token's (char_start, char_end), end exclusive, (0, 0) for special
    tokens."""
    gmap = np.zeros(max_len, np.float32)

    def char_to_token(pos: int) -> Optional[int]:
        for ti, (s, e) in enumerate(offsets):
            if s <= pos < e and e > s:
                return ti
        return None

    for item in spans:
        if len(item) != 2:
            gmap[:] = -1
            break
        beg, end = item
        beg_pos = char_to_token(beg)
        if beg_pos is None:
            beg_pos = char_to_token(beg + 1)
            if beg_pos is None:
                beg_pos = char_to_token(beg + 2)
        end_pos = char_to_token(end - 1)
        if end_pos is None:
            end_pos = char_to_token(end - 2)
            if end_pos is None:
                end_pos = char_to_token(end - 3)
        if beg_pos is None or end_pos is None:
            continue
        gmap[beg_pos:end_pos + 1] = 1
    return gmap


def mlm_loss(mlm_logits: torch.Tensor, mlm_labels: torch.Tensor,
             coef: float = 1.0) -> torch.Tensor:
    """Cross-entropy over the labelled positions (-100 ignored), their mean,
    x coef."""
    logp = torch.log_softmax(mlm_logits.float(), dim=-1)
    valid = mlm_labels != IGNORE_INDEX
    safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom * coef
