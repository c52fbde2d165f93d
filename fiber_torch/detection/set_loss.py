"""DETR-style set prediction loss: Hungarian matching and the class / box
criterion.

The PyTorch counterpart of `fiber_tpu/detection/set_loss.py`.  Targets are
padded (B, G, ...) tensors with a validity mask; the three cost terms
(focal or softmax class cost, normalised L1, -GIoU) are one batched
computation.  The assignment is combinatorial host work, as in the
reference: `hungarian_match` copies the (B, Q, G) cost to the host once,
under `torch.no_grad`, and solves each image with scipy's
`linear_sum_assignment`.  The matched-pair losses are gathers and masked
sums over the valid gt count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def box_area_float(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def generalized_box_iou_matrix(a: torch.Tensor, b: torch.Tensor
                               ) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M) GIoU (float convention)."""
    area_a, area_b = box_area_float(a), box_area_float(b)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    iou = inter / union
    elt = torch.minimum(a[:, None, :2], b[None, :, :2])
    erb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    ewh = (erb - elt).clamp_min(0)
    enclose = ewh[..., 0] * ewh[..., 1]
    return iou - (enclose - union) / enclose


def _hungarian_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """scipy's assignment per image: cost (B, Q, G), n_valid (B,) ->
    (B, G) the query matched to each gt column (0 for padding)."""
    from scipy.optimize import linear_sum_assignment
    B, Q, G = cost.shape
    out = np.zeros((B, G), np.int64)
    for b in range(B):
        g = int(n_valid[b])
        if g == 0:
            continue
        c = np.nan_to_num(cost[b, :, :g], nan=0.0, posinf=0.0, neginf=0.0)
        rows, cols = linear_sum_assignment(c)
        out[b, cols] = rows
    return out


@torch.no_grad()
def hungarian_match(cost: torch.Tensor, gt_valid: torch.Tensor
                    ) -> torch.Tensor:
    """(B, Q, G) cost and (B, G) validity -> (B, G) int64 matched query of
    each gt, on the cost's device.  One copy to the host and back; no
    gradient flows through the decision."""
    B, Q, G = cost.shape
    n_valid = gt_valid.sum(dim=1).float()
    host = torch.cat([cost.detach().float().flatten(), n_valid]).cpu().numpy()
    n = B * Q * G
    match = _hungarian_host(host[:n].reshape(B, Q, G), host[n:])
    return torch.from_numpy(match).to(cost.device)


def _focal_class_cost(probs: torch.Tensor, gt_labels: torch.Tensor,
                      alpha: float, gamma: float) -> torch.Tensor:
    """(B, Q, C) sigmoid probabilities x (B, G) labels -> (B, Q, G)."""
    neg = (1 - alpha) * (probs ** gamma) * (-torch.log(1 - probs + 1e-8))
    pos = alpha * ((1 - probs) ** gamma) * (-torch.log(probs + 1e-8))
    diff = pos - neg
    idx = gt_labels.long()[:, None, :].expand(-1, diff.shape[1], -1)
    return diff.gather(2, idx)


def set_matching_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                      image_sizes_xyxy: torch.Tensor,
                      cost_class: float = 1.0, cost_bbox: float = 1.0,
                      cost_giou: float = 1.0, use_focal: bool = False,
                      focal_alpha: float = 0.25, focal_gamma: float = 2.0
                      ) -> torch.Tensor:
    """(B, Q, G) matching cost.  Boxes absolute xyxy; image_sizes_xyxy
    (B, 4) = (w, h, w, h) normalises the L1 term."""
    logits = pred_logits.float()
    if use_focal:
        c_class = _focal_class_cost(torch.sigmoid(logits), gt_labels,
                                    focal_alpha, focal_gamma)
    else:
        probs = torch.softmax(logits, dim=-1)
        idx = gt_labels.long()[:, None, :].expand(-1, probs.shape[1], -1)
        c_class = -probs.gather(2, idx)
    scale = image_sizes_xyxy[:, None, :].float()
    pb = pred_boxes.float() / scale
    gb = gt_boxes.float() / scale
    c_bbox = (pb[:, :, None, :] - gb[:, None, :, :]).abs().sum(-1)
    c_giou = -torch.stack([generalized_box_iou_matrix(p, g) for p, g in
                           zip(pred_boxes.float(), gt_boxes.float())])
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.nan_to_num(cost, nan=0.0, posinf=0.0, neginf=0.0)


def set_criterion(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor, image_sizes: torch.Tensor,
                  num_classes: int, use_focal: bool = True,
                  cost_class: float = 1.0, cost_bbox: float = 1.0,
                  cost_giou: float = 1.0, eos_coef: float = 0.1,
                  focal_alpha: float = 0.25, focal_gamma: float = 2.0
                  ) -> Dict[str, torch.Tensor]:
    """Match, then the class, L1 and GIoU losses.  pred_logits (B, Q, C
    (+1 without focal)), pred_boxes (B, Q, 4) absolute xyxy; gt_boxes (B,
    G, 4), gt_labels (B, G) 0-based classes, gt_valid (B, G); image_sizes
    (B, 2) (h, w).  The losses are / the valid gt count."""
    B, Q, _ = pred_logits.shape
    gt_valid = gt_valid.bool()
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    sizes_xyxy = torch.cat([w, h, w, h], dim=1)
    cost = set_matching_cost(pred_logits, pred_boxes, gt_boxes, gt_labels,
                             sizes_xyxy, cost_class, cost_bbox, cost_giou,
                             use_focal, focal_alpha, focal_gamma)
    # a padded gt column never wins a real query
    cost = torch.where(gt_valid[:, None, :], cost, 1e9)
    match = hungarian_match(cost, gt_valid)                      # (B, G)
    num_boxes = gt_valid.sum().float().clamp_min(1.0)

    # the class target of each query: its matched gt's class or no-object
    dev = pred_logits.device
    q_idx = torch.where(gt_valid, match, Q)           # padding -> slot Q
    target = torch.full((B, Q + 1), num_classes, dtype=torch.long, device=dev)
    target.scatter_(1, q_idx, gt_labels.long())
    target = target[:, :Q]

    logits = pred_logits.float()
    if use_focal:
        onehot = F.one_hot(target, num_classes + 1)[..., :num_classes].float()
        p = torch.sigmoid(logits)
        ce = (logits.clamp_min(0) - logits * onehot
              + torch.log1p(torch.exp(-logits.abs())))
        p_t = p * onehot + (1 - p) * (1 - onehot)
        loss = ce * ((1 - p_t) ** focal_gamma)
        alpha_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
        loss_ce = (alpha_t * loss).sum() / num_boxes
    else:
        lsm = torch.log_softmax(logits, dim=-1)
        nll = -lsm.gather(-1, target[..., None])[..., 0]
        wgt = torch.where(target == num_classes, eos_coef, 1.0)
        loss_ce = (nll * wgt).sum() / wgt.sum()

    matched_pred = pred_boxes.float().gather(
        1, match[..., None].expand(-1, -1, 4))                  # (B, G, 4)
    gtb = gt_boxes.float()
    giou = torch.stack([torch.diagonal(generalized_box_iou_matrix(p, g))
                        for p, g in zip(matched_pred, gtb)])
    loss_giou = torch.where(gt_valid, 1.0 - giou, 0.0).sum() / num_boxes
    scale = sizes_xyxy[:, None, :]
    l1 = (matched_pred / scale - gtb / scale).abs().sum(-1)
    loss_bbox = (l1 * gt_valid.float()).sum() / num_boxes
    return {"loss_ce": loss_ce, "loss_giou": loss_giou,
            "loss_bbox": loss_bbox}
