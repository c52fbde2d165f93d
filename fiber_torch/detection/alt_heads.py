"""The dense detection heads besides the VL head: RPN, RetinaNet, FCOS and
plain (class-based) ATSS, their losses, and the head registry.

The PyTorch counterpart of `fiber_tpu/detection/alt_heads.py`.  The heads
take NCHW levels and return, as `VLDyHead` does, per-level (B, H, W, k)
outputs (the JAX package's layout), so that the losses read anchors in
(y, x, anchor) order.  Every loss is a fixed-shape program over padded gt
with validity masks, in fp32; the matchers and the sampler come from
`fiber_torch.detection.matcher`, and the RPN's sampler draws from an
explicit generator (or takes the draws).  Module names are the
reference's `rpn.head.` keys: `conv`, `cls_logits`, `bbox_pred`,
`centerness`, `scales.{l}.scale`, and the towers `cls_tower` /
`bbox_tower` as Sequentials (conv, GroupNorm, ReLU at 3i, 3i + 1, 3i + 2;
without GroupNorm conv and ReLU at 2i, 2i + 1).
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.detection.atss import batched_atss_assign
from fiber_torch.detection.atss_loss import (_flat, _giou_decoded,
                                             centerness_from_targets)
from fiber_torch.detection.boxes import (batched_nms, box_iou_legacy,
                                         clip_boxes, decode_boxes,
                                         encode_boxes)
from fiber_torch.detection.dyhead import GroupNorm, Scale, VLDyHead
from fiber_torch.detection.losses import (centerness_bce, sigmoid_focal_loss,
                                          smooth_l1_loss)
from fiber_torch.detection.matcher import (BELOW_LOW, BETWEEN,
                                           balanced_sample, first_argmax,
                                           match_quality, uniform_keys)
from fiber_torch.detection.roi_heads import _built

INF = 1e8


def prior_bias(p: float = 0.01) -> float:
    return -math.log((1 - p) / p)


class ConvTower(nn.Sequential):
    """n 3x3 convs, each with an optional GroupNorm (gcd(32, C) groups, eps
    1e-5) and a ReLU: the dense heads' shared tower."""

    def __init__(self, in_channels: int, channels: int, n_convs: int = 4,
                 use_gn: bool = True):
        layers = []
        for i in range(n_convs):
            layers.append(nn.Conv2d(in_channels if i == 0 else channels,
                                    channels, 3, padding=1))
            if use_gn:
                layers.append(GroupNorm(math.gcd(32, channels), channels,
                                        eps=1e-5))
            layers.append(nn.ReLU())
        super().__init__(*layers)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------
class RPNHead(nn.Module):
    """One shared 3x3 conv and the objectness / box predictors, per
    level."""

    def __init__(self, channels: int, num_anchors: int = 1,
                 in_channels: Optional[int] = None, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels or channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, 4 * num_anchors, 1)
        _built(self, device, seed)

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        logits, bbox = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(_nhwc(self.cls_logits(t)))
            bbox.append(_nhwc(self.bbox_pred(t)))
        return {"objectness": logits, "bbox_reg": bbox}


def rpn_loss(head_out: Dict[str, List[torch.Tensor]], anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             batch_per_image: int = 256, positive_fraction: float = 0.5,
             fg_iou: float = 0.7, bg_iou: float = 0.3,
             keys: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Binary objectness over the sampled anchors and smooth L1 (beta
    1/9) at the sampled positives, both / the sampled count (Matcher(0.7,
    0.3) with the low-quality matches).  `keys` (B, 2, N): each image's
    sampler draws, else taken from `generator`."""
    B, N = gt_boxes.shape[0], anchors.shape[0]
    obj = _flat(head_out["objectness"], B, 1)[..., 0].float()
    reg = _flat(head_out["bbox_reg"], B, 4).float()
    if keys is None:
        keys = torch.stack([uniform_keys(generator, N, obj.device)
                            for _ in range(B)])
    pos_sel, neg_sel, targets = [], [], []
    for b in range(B):
        quality = box_iou_legacy(gt_boxes[b], anchors)
        matches = match_quality(quality, gt_valid[b], fg_iou, bg_iou,
                                allow_low_quality=True)
        ps, ns = balanced_sample(matches >= 0, matches == BELOW_LOW, None,
                                 batch_per_image, positive_fraction,
                                 keys=keys[b])
        pos_sel.append(ps)
        neg_sel.append(ns)
        targets.append(encode_boxes(gt_boxes[b][matches.clamp_min(0)],
                                    anchors))
    pos_sel, neg_sel = torch.stack(pos_sel), torch.stack(neg_sel)
    targets = torch.stack(targets)
    sampled = pos_sel | neg_sel
    n_sampled = sampled.sum().float().clamp_min(1.0)
    labels = pos_sel.float()
    bce = (obj.clamp_min(0) - obj * labels
           + torch.log1p(torch.exp(-obj.abs())))
    loss_obj = torch.where(sampled, bce, 0.0).sum() / n_sampled
    l1 = smooth_l1_loss(reg, targets).sum(-1)
    loss_reg = torch.where(pos_sel, l1, 0.0).sum() / n_sampled
    return {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_reg}


def rpn_proposals(head_out: Dict[str, List[torch.Tensor]],
                  anchors_per_level: Sequence[torch.Tensor],
                  image_sizes: torch.Tensor, pre_nms_top_n: int = 1000,
                  post_nms_top_n: int = 256, nms_thresh: float = 0.7
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode, each level's top pre_nms_top_n (equal scores in index
    order), clip to the image (h, w) and NMS -> (B, post_nms_top_n, 4)
    proposals, their scores (0 where not valid) and validity."""
    B = head_out["objectness"][0].shape[0]
    all_boxes, all_scores = [], []
    for lvl, anchors in enumerate(anchors_per_level):
        scores = torch.sigmoid(
            head_out["objectness"][lvl].reshape(B, -1).float())
        reg = head_out["bbox_reg"][lvl].reshape(B, -1, 4)
        k = min(pre_nms_top_n, scores.shape[1])
        top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        deltas = reg.gather(1, idx[..., None].expand(B, k, 4))
        boxes = decode_boxes(deltas, anchors[idx])
        all_boxes.append(clip_boxes(boxes, image_sizes[:, 0:1],
                                    image_sizes[:, 1:2]))
        all_scores.append(top)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    keep, ok = batched_nms(boxes, scores, nms_thresh, post_nms_top_n)
    kept = boxes.gather(1, keep[..., None].expand(B, post_nms_top_n, 4))
    return kept, torch.where(ok, scores.gather(1, keep), 0.0), ok


# ---------------------------------------------------------------------
# RetinaNet
# ---------------------------------------------------------------------
class RetinaNetHead(nn.Module):
    def __init__(self, channels: int, num_classes: int, num_anchors: int = 1,
                 n_convs: int = 4, use_gn: bool = False,
                 in_channels: Optional[int] = None, device="cuda",
                 seed: int = 0):
        super().__init__()
        cin = in_channels or channels
        self.cls_tower = ConvTower(cin, channels, n_convs, use_gn)
        self.bbox_tower = ConvTower(cin, channels, n_convs, use_gn)
        self.cls_logits = nn.Conv2d(channels, num_anchors * num_classes, 3,
                                    padding=1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 3, padding=1)
        _built(self, device, seed)
        nn.init.constant_(self.cls_logits.bias, prior_bias())

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        logits = [_nhwc(self.cls_logits(self.cls_tower(f))) for f in features]
        bbox = [_nhwc(self.bbox_pred(self.bbox_tower(f))) for f in features]
        return {"box_cls": logits, "bbox_reg": bbox}


def retinanet_loss(head_out: Dict[str, List[torch.Tensor]],
                   anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int, fg_iou: float = 0.5, bg_iou: float = 0.4,
                   gamma: float = 2.0, alpha: float = 0.25,
                   beta: float = 0.11) -> Dict[str, torch.Tensor]:
    """Focal loss over every anchor not between the thresholds and smooth L1
    at the positives, both / the positives."""
    B = gt_boxes.shape[0]
    cls = _flat(head_out["box_cls"], B, num_classes)
    reg = _flat(head_out["bbox_reg"], B, 4).float()
    pos, cls_t, targets = [], [], []
    for b in range(B):
        quality = box_iou_legacy(gt_boxes[b], anchors)
        matches = match_quality(quality, gt_valid[b], fg_iou, bg_iou,
                                allow_low_quality=True)
        m = matches.clamp_min(0)
        t = torch.where(matches >= 0, gt_labels[b].long()[m], 0)
        cls_t.append(torch.where(matches == BETWEEN, -1, t))
        pos.append(matches >= 0)
        targets.append(encode_boxes(gt_boxes[b][m], anchors))
    pos, cls_t, targets = (torch.stack(pos), torch.stack(cls_t),
                           torch.stack(targets))
    n_pos = pos.sum().float().clamp_min(1.0)
    focal = sigmoid_focal_loss(cls.reshape(-1, num_classes), cls_t.reshape(-1),
                               num_classes, gamma=gamma, alpha=alpha)
    l1 = smooth_l1_loss(reg, targets, beta=beta).sum(-1)
    return {"loss_retina_cls": focal.sum() / n_pos,
            "loss_retina_reg": torch.where(pos, l1, 0.0).sum() / n_pos}


# ---------------------------------------------------------------------
# FCOS and plain ATSS
# ---------------------------------------------------------------------
class _CenternessHead(nn.Module):
    """The towers (with GroupNorm), class / box / centerness predictors
    and a learnt scale a level, shared by FCOS and plain ATSS; the box
    output is exp'd (FCOS's ltrb distances) when `exp_reg`."""

    def __init__(self, channels: int, num_classes: int, n_convs: int,
                 num_levels: int, in_channels: Optional[int], device,
                 seed: int, exp_reg: bool):
        super().__init__()
        self.exp_reg = exp_reg
        cin = in_channels or channels
        self.cls_tower = ConvTower(cin, channels, n_convs, True)
        self.bbox_tower = ConvTower(cin, channels, n_convs, True)
        self.cls_logits = nn.Conv2d(channels, num_classes, 3, padding=1)
        self.bbox_pred = nn.Conv2d(channels, 4, 3, padding=1)
        self.centerness = nn.Conv2d(channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in range(num_levels)])
        _built(self, device, seed)
        nn.init.constant_(self.cls_logits.bias, prior_bias())

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        out = {"box_cls": [], "bbox_reg": [], "centerness": []}
        for lvl, f in enumerate(features):
            ct, bt = self.cls_tower(f), self.bbox_tower(f)
            reg = self.bbox_pred(bt).float() * self.scales[lvl].scale.float()
            out["box_cls"].append(_nhwc(self.cls_logits(ct)))
            out["bbox_reg"].append(_nhwc(torch.exp(reg) if self.exp_reg
                                         else reg))
            out["centerness"].append(_nhwc(self.centerness(bt)))
        return out


class FCOSHead(_CenternessHead):
    def __init__(self, channels: int, num_classes: int, n_convs: int = 4,
                 num_levels: int = 5, norm_reg_targets: bool = False,
                 in_channels: Optional[int] = None, device="cuda",
                 seed: int = 0):
        super().__init__(channels, num_classes, n_convs, num_levels,
                         in_channels, device, seed,
                         exp_reg=not norm_reg_targets)


def fcos_locations(feat_sizes: Sequence[Tuple[int, int]],
                   strides: Sequence[int] = (8, 16, 32, 64, 128),
                   device="cuda") -> List[torch.Tensor]:
    """Per-level (H W, 2) points (x, y) at stride // 2 offsets."""
    out = []
    for (h, w), s in zip(feat_sizes, strides):
        ys = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        xs = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return out


FCOS_SIZE_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def fcos_assign(locations: torch.Tensor, level_ranges: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A point is positive for a gt when it lies inside the box and its
    largest side distance is in the level's range; among several gts the
    smallest box (the first on a tie).  locations / level_ranges (N, 2).
    Returns labels (N,) int64, ltrb targets (N, 4), pos (N,)."""
    xs, ys = locations[:, 0], locations[:, 1]
    l = xs[:, None] - gt_boxes[None, :, 0]
    t = ys[:, None] - gt_boxes[None, :, 1]
    r = gt_boxes[None, :, 2] - xs[:, None]
    b = gt_boxes[None, :, 3] - ys[:, None]
    ltrb = torch.stack([l, t, r, b], dim=-1)                   # (N, G, 4)
    inside = ltrb.amin(dim=-1) > 0
    max_reg = ltrb.amax(dim=-1)
    in_range = ((max_reg >= level_ranges[:, None, 0])
                & (max_reg <= level_ranges[:, None, 1]))
    area = ((gt_boxes[:, 2] - gt_boxes[:, 0])
            * (gt_boxes[:, 3] - gt_boxes[:, 1]))
    candidate = inside & in_range & gt_valid.bool()[None, :]
    masked_area = torch.where(candidate, area[None, :],
                              torch.full_like(max_reg, INF))
    assigned = first_argmax(-masked_area, 1)
    pos = candidate.any(dim=1)
    labels = torch.where(pos, gt_labels.long()[assigned], 0)
    reg_targets = ltrb.gather(
        1, assigned[:, None, None].expand(-1, 1, 4))[:, 0]
    return labels, reg_targets, pos


def fcos_loss(head_out: Dict[str, List[torch.Tensor]],
              feat_sizes: Sequence[Tuple[int, int]], gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              num_classes: int, strides: Sequence[int] = (8, 16, 32, 64, 128)
              ) -> Dict[str, torch.Tensor]:
    """Focal classification / the positives, IoU regression weighted by
    the centerness targets / their sum, centerness BCE / the positives."""
    B, dev = gt_boxes.shape[0], gt_boxes.device
    locs = fcos_locations(feat_sizes, strides, device=dev)
    ranges = torch.cat([
        torch.tensor(FCOS_SIZE_RANGES[i], dtype=torch.float32,
                     device=dev).expand(l.shape[0], 2)
        for i, l in enumerate(locs)], dim=0)
    locations = torch.cat(locs, dim=0)
    assigned = [fcos_assign(locations, ranges, gt_boxes[b], gt_labels[b],
                            gt_valid[b]) for b in range(B)]
    labels, reg_t, pos = (torch.stack(t) for t in zip(*assigned))

    cls = _flat(head_out["box_cls"], B, num_classes).float()
    reg = _flat(head_out["bbox_reg"], B, 4).float()
    ctr = _flat(head_out["centerness"], B, 1)[..., 0].float()
    n_pos = pos.sum().float().clamp_min(1.0)
    focal = sigmoid_focal_loss(cls.reshape(-1, num_classes),
                               labels.reshape(-1), num_classes)
    loss_cls = focal.sum() / n_pos

    lr = torch.minimum(reg_t[..., 0], reg_t[..., 2]) / torch.maximum(
        reg_t[..., 0], reg_t[..., 2]).clamp_min(1e-9)
    tb = torch.minimum(reg_t[..., 1], reg_t[..., 3]) / torch.maximum(
        reg_t[..., 1], reg_t[..., 3]).clamp_min(1e-9)
    ctr_t = torch.where(pos, torch.sqrt((lr * tb).clamp_min(0.0)), 0.0)
    sum_ctr = ctr_t.sum().clamp_min(1e-6)

    pw = reg[..., 0] + reg[..., 2]
    ph = reg[..., 1] + reg[..., 3]
    tw = reg_t[..., 0] + reg_t[..., 2]
    th = reg_t[..., 1] + reg_t[..., 3]
    iw = (torch.minimum(reg[..., 0], reg_t[..., 0])
          + torch.minimum(reg[..., 2], reg_t[..., 2]))
    ih = (torch.minimum(reg[..., 1], reg_t[..., 1])
          + torch.minimum(reg[..., 3], reg_t[..., 3]))
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    union = pw * ph + tw * th - inter
    iou = (inter + 1.0) / (union + 1.0)
    loss_reg = torch.where(pos, -torch.log(iou) * ctr_t, 0.0).sum() / sum_ctr
    loss_ctr = torch.where(pos, centerness_bce(ctr, ctr_t), 0.0).sum() / n_pos
    return {"loss_fcos_cls": loss_cls, "loss_fcos_reg": loss_reg,
            "loss_fcos_centerness": loss_ctr}


class PlainAtssHead(_CenternessHead):
    """The class-based ATSS head: VLDyHead's predictions without the
    language (box deltas, not ltrb distances)."""

    def __init__(self, channels: int, num_classes: int, n_convs: int = 4,
                 num_levels: int = 5, in_channels: Optional[int] = None,
                 device="cuda", seed: int = 0):
        super().__init__(channels, num_classes, n_convs, num_levels,
                         in_channels, device, seed, exp_reg=False)


def plain_atss_loss(head_out: Dict[str, List[torch.Tensor]],
                    anchors: torch.Tensor, level_sizes: Sequence[int],
                    gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_valid: torch.Tensor, num_classes: int,
                    reg_loss_weight: float = 2.0) -> Dict[str, torch.Tensor]:
    """Focal over the classes, GIoU weighted by centerness and centerness
    BCE, on the ATSS assignment of the VL head."""
    B = gt_boxes.shape[0]
    cls = _flat(head_out["box_cls"], B, num_classes).float()
    reg = _flat(head_out["bbox_reg"], B, 4).float()
    ctr = _flat(head_out["centerness"], B, 1)[..., 0].float()
    assign = batched_atss_assign(anchors, level_sizes, gt_boxes, gt_valid)
    pos = assign.pos_mask
    labels = torch.where(pos, gt_labels.long().gather(1, assign.assigned_gt),
                         0)
    n_pos = pos.sum().float().clamp_min(1.0)
    focal = sigmoid_focal_loss(cls.reshape(-1, num_classes),
                               labels.reshape(-1), num_classes)
    anchors_b = anchors[None].expand(B, *anchors.shape)
    ctr_t = torch.where(pos, centerness_from_targets(assign.reg_targets,
                                                     anchors_b), 0.0)
    sum_ctr = ctr_t.sum().clamp_min(1e-6)
    giou = _giou_decoded(reg, assign.reg_targets, anchors_b)
    loss_reg = (torch.where(pos, (1.0 - giou) * ctr_t, 0.0).sum()
                / sum_ctr) * reg_loss_weight
    loss_ctr = torch.where(pos, centerness_bce(ctr, ctr_t), 0.0).sum() / n_pos
    return {"loss_cls": focal.sum() / n_pos, "loss_reg": loss_reg,
            "loss_centerness": loss_ctr}


# ---------------------------------------------------------------------
# Registry (the reference's build_rpn)
# ---------------------------------------------------------------------
HEADS = {"RPN": RPNHead, "RETINA": RetinaNetHead, "FCOS": FCOSHead,
         "ATSS": PlainAtssHead, "VLDYHEAD": VLDyHead}


def build_head(name: str, channels: int, num_classes: int,
               num_anchors: int = 1, **kw) -> nn.Module:
    """The head registered as `name` (RPN | RETINA | FCOS | ATSS |
    VLDYHEAD); keyword arguments the head does not take are dropped, as
    the JAX registry drops them.  VLDYHEAD takes only `kw`, and is built
    on the host (move it with `.to`)."""
    cls = HEADS.get(name.upper())
    if cls is None:
        raise KeyError(f"unknown head {name!r} "
                       "(RPN|RETINA|FCOS|ATSS|VLDYHEAD)")
    kwargs = dict(kw) if cls is VLDyHead else dict(
        channels=channels, num_classes=num_classes, num_anchors=num_anchors,
        **kw)
    fields = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
