"""IoU matcher and balanced positive / negative sampler, fixed-shape.

The PyTorch counterpart of `fiber_tpu/detection/matcher.py`.  The matcher
is max / argmax algebra over a padded (G, N) quality matrix; the sampler
takes a fixed budget by ranking random keys (a stable sort, so equal keys
keep index order), in place of the reference's randperm.  The keys are
drawn from an explicit `torch.Generator`, or passed in (`keys`) so that a
caller can feed another package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BELOW_LOW = -1
BETWEEN = -2


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The index of the first maximum along `dim` (int64), on every device:
    the lowest index among equal maxima, as `jnp.argmax` picks it."""
    best = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == best, ar, n).amin(dim=dim)


def match_quality(quality: torch.Tensor, gt_valid: torch.Tensor,
                  high: float, low: float,
                  allow_low_quality: bool = False) -> torch.Tensor:
    """quality (G, N) padded, gt_valid (G,) -> matches (N,) int64 in [0, G)
    or BELOW_LOW / BETWEEN.  With `allow_low_quality` every prediction that
    ties a valid gt's best (positive) quality keeps its raw match."""
    gt_valid = gt_valid.bool()
    q = torch.where(gt_valid[:, None], quality, torch.full_like(quality, -1.0))
    matched_vals = q.amax(dim=0)
    all_matches = first_argmax(q, 0)
    matches = torch.where(matched_vals < low,
                          torch.full_like(all_matches, BELOW_LOW), all_matches)
    matches = torch.where((matched_vals >= low) & (matched_vals < high),
                          torch.full_like(all_matches, BETWEEN), matches)
    if allow_low_quality:
        best_per_gt = q.amax(dim=1, keepdim=True)                 # (G, 1)
        is_best = (q == best_per_gt) & gt_valid[:, None] & (q > 0)
        matches = torch.where(is_best.any(dim=0), all_matches, matches)
    return matches


def uniform_keys(generator: torch.Generator, n: int,
                 device) -> torch.Tensor:
    """(2, n) fp32 uniform keys from `generator` (drawn on its device),
    moved to `device`: the positives' row and the negatives'."""
    return torch.rand((2, n), generator=generator,
                      device=generator.device).to(device)


def balanced_sample(pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                    generator: Optional[torch.Generator], num_samples: int,
                    pos_fraction: float,
                    keys: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to int(num_samples * pos_fraction) positives and the rest of
    `num_samples` negatives, chosen by ranking random keys: `keys` (2, N)
    when given, else drawn from `generator`.  Returns boolean (N,) masks."""
    n = pos_mask.shape[0]
    n_pos_budget = int(num_samples * pos_fraction)
    if keys is None:
        keys = uniform_keys(generator, n, pos_mask.device)
    neg1 = torch.full_like(keys[0], -1.0)
    pos_keys = torch.where(pos_mask, keys[0], neg1)
    pos_rank = torch.sort(-pos_keys, stable=True).indices
    pos_sel = torch.zeros(n, dtype=torch.bool, device=pos_mask.device)
    pos_sel[pos_rank[:n_pos_budget]] = True
    pos_sel = pos_sel & pos_mask
    n_pos = pos_mask.sum().clamp(max=n_pos_budget)

    neg_keys = torch.where(neg_mask, keys[1], neg1)
    neg_rank = torch.sort(-neg_keys, stable=True).indices
    neg_order = torch.empty_like(neg_rank)
    neg_order[neg_rank] = torch.arange(n, device=neg_rank.device)
    neg_sel = (neg_order < num_samples - n_pos) & neg_mask
    return pos_sel, neg_sel
