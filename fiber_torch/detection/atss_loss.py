"""The ATSS grounding loss: focal objectness, GIoU regression, centerness
and the dot-product token focal loss, with the optional token and
contrastive-align entries.

The PyTorch counterpart of `fiber_tpu/detection/atss_loss.py`:

* anchors are assigned by ATSS (`fiber_torch.detection.atss`);
* cls: binary sigmoid focal over the anchors (1 at positives), / num_pos;
* dot-product token: focal of the grounding logits against the matched
  gt's positive-map row; an unmatched anchor targets the last ("no
  object") token, / num_pos;
* reg: GIoU of the decoded prediction and target at the positives,
  weighted by the centerness targets, / their sum, x `reg_loss_weight`;
* centerness: BCE against the (l, t, r, b)-derived target, / num_pos.

The sums run over the local batch; under a process `group` the counts
they are divided by (num_pos, the centerness sum) are summed over the
ranks, so that each rank's loss is its partial of the global batch's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from fiber_torch.detection.atss import AtssAssignment, batched_atss_assign
from fiber_torch.detection.boxes import decode_boxes
from fiber_torch.detection.contrastive import contrastive_align_loss
from fiber_torch.detection.losses import (centerness_bce, sigmoid_focal_loss,
                                          token_sigmoid_focal_loss)
from fiber_torch.parallel.data_parallel import global_count


def centerness_from_targets(reg_targets: torch.Tensor,
                            anchors: torch.Tensor) -> torch.Tensor:
    """(..., 4) encoded targets on their anchors -> centerness in [0, 1]."""
    gts = decode_boxes(reg_targets, anchors)
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    l = acx - gts[..., 0]
    t = acy - gts[..., 1]
    r = gts[..., 2] - acx
    b = gts[..., 3] - acy
    lr = torch.minimum(l, r) / torch.maximum(l, r).clamp_min(1e-9)
    tb = torch.minimum(t, b) / torch.maximum(t, b).clamp_min(1e-9)
    return torch.sqrt((lr * tb).clamp_min(0.0))


def _giou_decoded(pred_deltas: torch.Tensor, target_deltas: torch.Tensor,
                  anchors: torch.Tensor) -> torch.Tensor:
    """GIoU of the decoded boxes, a degenerate prediction taken as x2 :=
    max(x1, x2) (zero area allowed), 1e-7 in the enclosure and the
    union."""
    pred = decode_boxes(pred_deltas, anchors)
    gt = decode_boxes(target_deltas, anchors)
    px1, py1 = pred[..., 0], pred[..., 1]
    px2 = torch.maximum(px1, pred[..., 2])
    py2 = torch.maximum(py1, pred[..., 3])
    gx1, gy1, gx2, gy2 = gt.unbind(-1)
    pa = (px2 - px1) * (py2 - py1)
    ga = (gx2 - gx1) * (gy2 - gy1)
    ix1 = torch.maximum(px1, gx1)
    iy1 = torch.maximum(py1, gy1)
    ix2 = torch.minimum(px2, gx2)
    iy2 = torch.minimum(py2, gy2)
    inter = torch.where((ix2 > ix1) & (iy2 > iy1), (ix2 - ix1) * (iy2 - iy1),
                        torch.zeros_like(ix1))
    ex1 = torch.minimum(px1, gx1)
    ey1 = torch.minimum(py1, gy1)
    ex2 = torch.maximum(px2, gx2)
    ey2 = torch.maximum(py2, gy2)
    enclose = (ex2 - ex1) * (ey2 - ey1) + 1e-7
    union = pa + ga - inter + 1e-7
    return inter / union - (enclose - union) / enclose


def _flat(per_level: List[torch.Tensor], B: int, ch: int) -> torch.Tensor:
    return torch.cat([x.reshape(B, -1, ch) for x in per_level], dim=1)


def atss_grounding_loss(head_out: Dict[str, List[torch.Tensor]],
                        anchors: torch.Tensor, level_sizes: Sequence[int],
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        positive_map: torch.Tensor, text_masks: torch.Tensor,
                        reg_loss_weight: float = 2.0, topk: int = 9,
                        assign: Optional[AtssAssignment] = None, group=None
                        ) -> Dict[str, torch.Tensor]:
    """head_out: VLDyHead's per-level lists; anchors (N, 4); gt_boxes (B, G,
    4), gt_valid (B, G), positive_map (B, G, T), text_masks (B, T).

    `token_logits` in head_out adds `loss_token`, `contrastive_logits`
    adds `loss_contrastive_align`.  `assign` is a precomputed assignment
    (shared with the shallow contrastive loss).  `group`: the counts are
    the global batch's (data parallel)."""
    B = gt_boxes.shape[0]
    box_cls = _flat(head_out["box_cls"], B, 1)[..., 0].float()      # (B, N)
    box_reg = _flat(head_out["bbox_reg"], B, 4).float()             # (B, N, 4)
    centerness = _flat(head_out["centerness"], B, 1)[..., 0].float()
    dot_logits = torch.cat(head_out["dot_product_logits"], dim=1)  # (B, N, T)

    if assign is None:
        assign = batched_atss_assign(anchors, level_sizes, gt_boxes, gt_valid,
                                     topk=topk)
    pos = assign.pos_mask                                           # (B, N)
    num_pos = global_count(pos.sum(), group).float().clamp_min(1.0)

    cls_loss = sigmoid_focal_loss(box_cls.reshape(-1, 1),
                                  pos.long().reshape(-1),
                                  num_classes=1).sum() / num_pos

    T = positive_map.shape[-1]
    matched_map = torch.gather(
        positive_map.float(), 1,
        assign.assigned_gt[..., None].expand(B, pos.shape[1], T))  # (B, N, T)
    no_object = torch.zeros(T, device=matched_map.device)
    no_object[-1] = 1.0
    token_labels = torch.where(pos[..., None], matched_map, no_object)
    tmask = text_masks[:, None, :]
    token_loss = token_sigmoid_focal_loss(dot_logits, token_labels,
                                          text_mask=tmask).sum() / num_pos

    anchors_b = anchors[None].expand(B, *anchors.shape)
    zero = torch.zeros_like(box_cls)
    ctr_t = torch.where(pos, centerness_from_targets(assign.reg_targets,
                                                     anchors_b), zero)
    sum_ctr = global_count(ctr_t.sum(), group).clamp_min(1e-6)
    giou = _giou_decoded(box_reg, assign.reg_targets, anchors_b)
    reg_loss = (torch.where(pos, (1.0 - giou) * ctr_t, zero).sum()
                / sum_ctr) * reg_loss_weight
    ctr_loss = torch.where(pos, centerness_bce(centerness, ctr_t),
                           zero).sum() / num_pos

    out = {"loss_cls": cls_loss, "loss_reg": reg_loss,
           "loss_centerness": ctr_loss, "loss_dot_product_token": token_loss}
    if "token_logits" in head_out:
        t_logits = torch.cat(head_out["token_logits"], dim=1)
        out["loss_token"] = token_sigmoid_focal_loss(
            t_logits, token_labels, text_mask=tmask).sum() / num_pos
    if "contrastive_logits" in head_out:
        c_logits = torch.cat(head_out["contrastive_logits"], dim=1)
        # the matched gt's token span at positives, empty rows elsewhere (no
        # no-object entry)
        map_labels = pos[..., None] & (matched_map > 0)
        out["loss_contrastive_align"] = contrastive_align_loss(
            c_logits, map_labels) / num_pos
    return out
