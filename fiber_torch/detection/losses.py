"""Detection losses: sigmoid focal, token sigmoid focal, centerness BCE,
smooth L1.

The PyTorch counterpart of `fiber_tpu/detection/losses.py`: elementwise
tensor ops in fp32, each returning the per-element loss for the caller to
sum and normalise.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, class_targets: torch.Tensor,
                       num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Class-indexed focal loss: logits (N, C); class_targets (N,) in
    [0, C], 1-based class ids, 0 background (a negative id is ignored).
    Returns the per-element loss (N, C)."""
    logits = logits.float()
    t = class_targets[:, None]
    cls = torch.arange(1, num_classes + 1, device=logits.device)[None, :]
    pos = (t == cls).float()
    neg = ((t != cls) & (t >= 0)).float()
    p = torch.sigmoid(logits)
    pos_term = -pos * alpha * ((1 - p) ** gamma) * torch.log(
        p.clamp_min(1e-12))
    neg_term = -neg * (1 - alpha) * (p ** gamma) * torch.log(
        (1 - p).clamp_min(1e-12))
    return pos_term + neg_term


def token_sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                             text_mask: Optional[torch.Tensor] = None,
                             gamma: float = 2.0,
                             alpha: float = 0.25) -> torch.Tensor:
    """Binary focal loss of the grounding logits against the 0/1 rows of the
    positive map, (..., T), masked by the valid tokens; per element."""
    logits = logits.float()
    targets = targets.float()
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if text_mask is not None:
        loss = loss * text_mask.float()
    return loss


def centerness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """ATSS centerness from (l, t, r, b) regression targets."""
    l, t, r, b = reg_targets.unbind(-1)
    lr = torch.minimum(l, r) / torch.maximum(l, r).clamp_min(1e-9)
    tb = torch.minimum(t, b) / torch.maximum(t, b).clamp_min(1e-9)
    return torch.sqrt((lr * tb).clamp_min(0))


def centerness_bce(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(logits.float(), targets.float())


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
