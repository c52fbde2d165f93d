"""MDETR's contrastive alignment and GLIP's shallow contrastive loss.

The PyTorch counterpart of `fiber_tpu/detection/contrastive.py`.  The
positive anchors that the shallow loss reads are chosen by a top-k to a
fixed `max_anchors` slot count with validity masks, not gathered into
per-image lists of varying length: padded rows carry an empty positive map
and a -1e6 logit mask, so any `max_anchors` at least the positive count
gives the loss of the reference's dynamic padding.  One device holds the
whole batch, so the reference's all-gather is the identity here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

MASK_FILL = -1000000.0


def safe_l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise the last axis; an all-zero row stays zero, with a zero
    gradient (torch's `F.normalize` subgradient)."""
    n = torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-24)
    return x / n.clamp_min(1e-12)


def contrastive_align_loss(logits: torch.Tensor,
                           positive_map: torch.Tensor) -> torch.Tensor:
    """Box <-> token InfoNCE: logits (B, N, T), positive_map (B, N, T) bool,
    the token span of each anchor's matched gt.  Returns the sum over boxes
    and tokens, halved; the caller divides by the positive count."""
    logits = logits.float()
    pm = positive_map.bool()
    pos_logits = torch.where(pm, -logits, torch.zeros_like(logits))
    zero = torch.zeros((), device=logits.device)

    boxes_with_pos = pm.any(dim=2)
    nb_pos = pm.sum(dim=2) + 1e-6
    box_to_token = torch.where(
        boxes_with_pos,
        pos_logits.sum(dim=2) / nb_pos + torch.logsumexp(logits, dim=2),
        zero).sum()

    tokens_with_pos = pm.any(dim=1)
    nb_pos_t = pm.sum(dim=1) + 1e-6
    token_to_box = torch.where(
        tokens_with_pos,
        pos_logits.sum(dim=1) / nb_pos_t + torch.logsumexp(logits, dim=1),
        zero).sum()
    return (box_to_token + token_to_box) / 2.0


def nll_softmax_loss(logits: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """-target * log_softmax(logits, -1), elementwise."""
    return -target * torch.log_softmax(logits.float(), dim=-1)


def normalized_positive_map(pm: torch.Tensor) -> torch.Tensor:
    """Rows normalised over the last axis; an empty row divides by 1e-6."""
    pm = pm.float()
    denom = pm.sum(-1)
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-6), denom)
    return pm / denom[..., None]


def select_shallow_anchors(pos_mask: torch.Tensor, assigned_gt: torch.Tensor,
                           max_anchors: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-size stand-in for the reference's per-image positive index
    lists: (idx (B, K), is_pos (B, K) bool).  The positive set is the
    anchors whose matched gt index is not 0 (the reference's
    `nonzero(anchors_to_gt_indexs)`: a positive matched to gt slot 0 is
    dropped).  Positives come first in ascending anchor order, the pad
    slots continue with ascending non-positives; the scores are distinct,
    so the order is fixed."""
    N = pos_mask.shape[1]
    shallow_pos = pos_mask & (assigned_gt != 0)
    base = torch.arange(N, 0, -1, device=pos_mask.device)
    score = torch.where(shallow_pos, base + N, base)
    idx = torch.topk(score, max_anchors, dim=1).indices
    return idx, torch.gather(shallow_pos, 1, idx)


class ShallowProjections(nn.Module):
    """The learned pieces of the shallow contrastive loss: the image and
    text projections and the log temperature, under the reference loss
    evaluator's names.  It projects every FPN position; the loss then
    gathers the selected rows (a Linear acts on rows independently)."""

    def __init__(self, img_dim: int, lang_dim: int, hdim: int = 64):
        super().__init__()
        self.shallow_contrastive_projection_image = nn.Linear(img_dim, hdim)
        self.shallow_contrastive_projection_text = nn.Linear(lang_dim, hdim)
        self.shallow_log_scale = nn.Parameter(torch.zeros(1))

    def forward(self, img_feats: torch.Tensor, lang_emb: torch.Tensor):
        """img_feats (B, N, C), lang_emb (B, T, D) -> (qi (B, N, h), qt (B,
        T, h), log_scale (1,)), in fp32 whatever the parameters' dtype."""
        def project(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            return safe_l2_normalize(F.linear(x.float(), lin.weight.float(),
                                              lin.bias.float()))

        with torch.autocast(img_feats.device.type, enabled=False):
            return (project(self.shallow_contrastive_projection_image,
                            img_feats),
                    project(self.shallow_contrastive_projection_text,
                            lang_emb),
                    self.shallow_log_scale)


def shallow_contrastive_loss(qi: torch.Tensor, qt: torch.Tensor,
                             log_scale: torch.Tensor,
                             text_masks: torch.Tensor, sel_idx: torch.Tensor,
                             sel_is_pos: torch.Tensor,
                             assigned_gt: torch.Tensor,
                             positive_map: torch.Tensor,
                             gt_od_labels: torch.Tensor,
                             od_label_of_tokens: torch.Tensor,
                             num_pos_avg: torch.Tensor,
                             zero_pads: bool = False) -> torch.Tensor:
    """The batch-global NCE of the shallow contrastive loss.  qi (B, N, h)
    and qt (B, T, h) normalised projections; text_masks (B, T); sel_idx /
    sel_is_pos (B, K) from `select_shallow_anchors`; assigned_gt (B, N);
    positive_map (B, G, T); gt_od_labels (B, G); od_label_of_tokens (B, T)
    (-1: no label).  `zero_pads` masks the pad slots out; without it they
    stay as negative anchors with no image mask (the reference's
    default)."""
    B, _, h = qi.shape
    T = qt.shape[1]
    K = sel_idx.shape[1]
    qi = torch.gather(qi, 1, sel_idx[..., None].expand(B, K, h))
    if zero_pads:
        qi = torch.where(sel_is_pos[..., None], qi, torch.zeros_like(qi))

    logits = torch.einsum("bkh,cth->bkct", qi.float(), qt.float())
    logits = (logits / torch.exp(log_scale.float())).reshape(B * K, B * T)
    fill = torch.full_like(logits, MASK_FILL)
    logits = torch.where(text_masks.reshape(1, B * T).bool(), logits, fill)
    if zero_pads:
        logits = torch.where(sel_is_pos.reshape(B * K, 1), logits, fill)

    # the positive map F (B K, B T): od-label equality across the batch,
    # each image's own block the matched token spans; pad slots carry od
    # label -100 and empty rows
    sel_gt = torch.gather(assigned_gt, 1, sel_idx)                 # (B, K)
    pred_od = torch.gather(gt_od_labels.long(), 1, sel_gt)
    pred_od = torch.where(sel_is_pos, pred_od, torch.full_like(pred_od, -100))
    od_match = (pred_od.reshape(B * K, 1)
                == od_label_of_tokens.long().reshape(1, B * T))
    map_sel = torch.gather(positive_map.bool(), 1,
                           sel_gt[..., None].expand(B, K, T))
    map_sel = map_sel & sel_is_pos[..., None]                      # (B, K, T)
    own = torch.eye(B, dtype=torch.bool, device=qi.device)
    own = own.repeat_interleave(K, 0).repeat_interleave(T, 1)      # (BK, BT)
    map_tiled = map_sel[:, :, None, :].expand(B, K, B, T).reshape(B * K,
                                                                  B * T)
    F = torch.where(own, map_tiled, od_match)

    img_side = nll_softmax_loss(logits, normalized_positive_map(F)).sum()
    txt_side = nll_softmax_loss(logits.T, normalized_positive_map(F.T)).sum()
    return (img_side + txt_side) / 2.0 / num_pos_avg
