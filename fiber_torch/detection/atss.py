"""ATSS adaptive anchor assignment over padded ground truth, batched.

The PyTorch counterpart of `fiber_tpu/detection/atss.py`.  For each gt box,
the k anchors of each FPN level nearest its centre are candidates; a
candidate is positive when its IoU (legacy +1 convention) reaches the
candidates' mean + std (Bessel's n - 1) and its centre lies inside the box
by more than 0.01 px; an anchor positive for several boxes takes the one of
highest IoU (the first on a tie).  Every tensor has a fixed shape, (B, G,
N) over the batch, the padded gt slots and the anchors, so the assignment
runs on the device with no read-back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from fiber_torch.detection.boxes import box_iou_legacy, encode_boxes

NEG_INF = -1e30


class AtssAssignment(NamedTuple):
    assigned_gt: torch.Tensor   # (..., N) int64 gt row of each anchor (0 if none)
    pos_mask: torch.Tensor      # (..., N) bool, the anchor is positive
    reg_targets: torch.Tensor   # (..., N, 4) encoded regression targets


def batched_atss_assign(anchors: torch.Tensor, level_sizes: Sequence[int],
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        topk: int = 9,
                        anchors_per_loc: int = 1) -> AtssAssignment:
    """anchors (N, 4), all levels concatenated; level_sizes the per-level
    anchor counts, summing to N; gt_boxes (B, G, 4) padded; gt_valid (B, G)
    bool.

    The k nearest anchors of a level are the first k of a stable ascending
    sort of the centre distances, so that anchors at the same distance are
    taken in index order, as `lax.top_k` takes them."""
    N = anchors.shape[0]
    B, G = gt_boxes.shape[:2]
    gt_boxes = gt_boxes.float()
    a_cx = (anchors[:, 0] + anchors[:, 2]) / 2
    a_cy = (anchors[:, 1] + anchors[:, 3]) / 2
    g_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    g_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    dist = torch.sqrt((a_cx - g_cx[..., None]) ** 2
                      + (a_cy - g_cy[..., None]) ** 2)        # (B, G, N)

    parts, start = [], 0
    for n_lvl in level_sizes:
        k = min(topk * anchors_per_loc, n_lvl)
        idx = torch.sort(dist[..., start:start + n_lvl], dim=-1,
                         stable=True).indices[..., :k]
        parts.append(torch.zeros((B, G, n_lvl), dtype=torch.bool,
                                 device=dist.device).scatter_(-1, idx, True))
        start += n_lvl
    candidate = torch.cat(parts, dim=-1)                      # (B, G, N)

    ious = box_iou_legacy(gt_boxes.reshape(B * G, 4),
                          anchors).reshape(B, G, N)
    cand_f = candidate.float()
    n_cand = cand_f.sum(-1, keepdim=True).clamp_min(1)
    mean = (ious * cand_f).sum(-1, keepdim=True) / n_cand
    var = ((((ious - mean) ** 2) * cand_f).sum(-1, keepdim=True)
           / (n_cand - 1).clamp_min(1))
    thresh = mean + torch.sqrt(var)

    x1, y1, x2, y2 = (gt_boxes[..., i:i + 1] for i in range(4))
    inside = ((a_cx - x1 > 0.01) & (x2 - a_cx > 0.01)
              & (a_cy - y1 > 0.01) & (y2 - a_cy > 0.01))      # (B, G, N)
    pos = candidate & (ious >= thresh) & inside & gt_valid.bool()[..., None]

    masked = torch.where(pos, ious, torch.full_like(ious, NEG_INF))
    assigned_gt = masked.argmax(dim=1)                        # (B, N)
    pos_mask = pos.any(dim=1)
    matched = torch.gather(gt_boxes, 1,
                           assigned_gt[..., None].expand(B, N, 4))
    return AtssAssignment(assigned_gt=assigned_gt, pos_mask=pos_mask,
                          reg_targets=encode_boxes(matched, anchors))


def atss_assign(anchors: torch.Tensor, level_sizes: Sequence[int],
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                topk: int = 9, anchors_per_loc: int = 1) -> AtssAssignment:
    """`batched_atss_assign` of one image: gt_boxes (G, 4), gt_valid (G,)."""
    out = batched_atss_assign(anchors, level_sizes, gt_boxes[None],
                              gt_valid[None], topk, anchors_per_loc)
    return AtssAssignment(*(t[0] for t in out))
