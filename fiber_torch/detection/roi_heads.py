"""ROI heads: the Faster R-CNN box head, the Mask R-CNN mask head and the
keypoint head, in NCHW.

The PyTorch counterpart of `fiber_tpu/detection/roi_heads.py`: fixed-size
proposal sets with validity masks, ROIAlign from each box's FPN level,
losses as masked sums.  Module names are the reference's state_dict keys
under `roi_heads.box.` (`feature_extractor.fc6 / fc7`, `predictor.
cls_score / bbox_pred`), `roi_heads.mask.` (`feature_extractor.
mask_fcn{1-4}`, `predictor.conv5_mask / mask_fcn_logits`) and
`roi_heads.keypoint.` (`feature_extractor.conv_fcn{1-8}`, `predictor.
kps_score_lowres`).  The box head flattens its (C, P, P) pool channel
first, as the reference does.  Fresh weights are drawn as flax draws them:
lecun-normal kernels, zero biases.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.detection.boxes import (box_iou_legacy, clip_boxes,
                                         decode_boxes, encode_boxes, ml_nms)
from fiber_torch.detection.matcher import (BELOW_LOW, balanced_sample,
                                           first_argmax, match_quality)
from fiber_torch.detection.roi_align import exact_div, flat_rows, pool_rows
from fiber_torch.data.device_transforms import resize_axes
from fiber_torch.models.fiber import resolve_device
from fiber_torch.models.layers import lecun_normal_


@torch.no_grad()
def init_flax_default(module: nn.Module, gen: torch.Generator) -> None:
    """Every Linear, Conv2d and ConvTranspose2d of `module` lecun-normal
    (a transposed conv's fan-in: in channels x kernel area), biases zero,
    norms unit."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            lecun_normal_(m.weight, gen, m.weight[:, 0].numel())
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, gen)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def _built(module: nn.Module, device, seed: int) -> None:
    """Draw `module`'s weights from `seed` on the host, then move it."""
    init_flax_default(module, torch.Generator().manual_seed(seed))
    module.to(resolve_device(device))


def assign_fpn_level(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                     canonical_scale: float = 224.0,
                     canonical_level: int = 4) -> torch.Tensor:
    """The FPN paper's level, floor(k0 + log2(sqrt(w h) / 224)), clipped
    to [k_min, k_max], less k_min (int64)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    s = torch.sqrt(w * h)
    k = torch.floor(canonical_level
                    + torch.log2(exact_div(s, canonical_scale) + 1e-8))
    return k.clamp(k_min, k_max).long() - k_min


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                         output_size: int,
                         strides: Sequence[int] = (4, 8, 16, 32),
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Pool each box from its assigned FPN level (one image): features
    per level (C, H_l, W_l), boxes (R, 4) -> (R, C, P, P).  The levels
    share one flat buffer and each box reads only its own level, which
    gives the values of pooling every box from every level and then
    selecting (a box's pool does not depend on the others)."""
    lvl = assign_fpn_level(boxes, k_min=int(math.log2(strides[0])),
                           k_max=int(math.log2(strides[-1])))
    dev = boxes.device
    flat = torch.cat([flat_rows(f) for f in features], dim=0)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    starts = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                          device=dev)
    Hs = torch.tensor([f.shape[1] for f in features], device=dev)
    Ws = torch.tensor([f.shape[2] for f in features], device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=boxes.dtype,
                          device=dev)
    return pool_rows(flat, starts[lvl], Hs[lvl], Ws[lvl], scales[lvl], boxes,
                     output_size, sampling_ratio)


# ---------------------------------------------------------------------
# Box head
# ---------------------------------------------------------------------
class BoxHead(nn.Module):
    """Two FCs and the class / box predictors (FPN2MLPFeatureExtractor and
    FPNPredictor).  forward: pooled (R, C, P, P) -> (class logits (R,
    num_classes), box deltas (R, 4) or (R, 4 num_classes))."""

    def __init__(self, in_channels: int, num_classes: int,
                 representation_size: int = 1024, pool_size: int = 7,
                 class_agnostic_reg: bool = False, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.pool_size = pool_size
        self.feature_extractor = nn.Module()
        self.feature_extractor.fc6 = nn.Linear(
            in_channels * pool_size ** 2, representation_size)
        self.feature_extractor.fc7 = nn.Linear(representation_size,
                                               representation_size)
        self.predictor = nn.Module()
        self.predictor.cls_score = nn.Linear(representation_size, num_classes)
        self.predictor.bbox_pred = nn.Linear(
            representation_size, 4 if class_agnostic_reg else 4 * num_classes)
        _built(self, device, seed)

    def forward(self, pooled: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        fe, pr = self.feature_extractor, self.predictor
        x = F.relu(fe.fc6(pooled.flatten(1)))
        x = F.relu(fe.fc7(x))
        return pr.cls_score(x), pr.bbox_pred(x)


def sample_proposals(proposals: torch.Tensor, prop_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     batch_size: int = 512, pos_fraction: float = 0.25,
                     fg_iou: float = 0.5, bg_iou: float = 0.5,
                     keys: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Match and subsample the proposals of one image for the box head,
    the gt boxes appended to them.  `keys` (2, R + G): the sampler's
    draws, else taken from `generator`.  Returns boxes (R + G, 4),
    selected / pos (R + G,) bool, labels (int64, 0 background), the
    regression targets and each box's matched gt row (`matched_gt`, 0
    where unmatched: the instance whose mask or keypoints it learns)."""
    all_boxes = torch.cat([proposals, gt_boxes], dim=0)
    all_valid = torch.cat([prop_valid.bool(), gt_valid.bool()], dim=0)
    quality = box_iou_legacy(gt_boxes, all_boxes)
    quality = torch.where(all_valid[None, :], quality,
                          torch.full_like(quality, -1.0))
    matches = match_quality(quality, gt_valid, fg_iou, bg_iou)
    pos = (matches >= 0) & all_valid
    neg = (matches == BELOW_LOW) & all_valid
    pos_sel, neg_sel = balanced_sample(pos, neg, generator, batch_size,
                                       pos_fraction, keys=keys)
    m = matches.clamp_min(0)
    labels = torch.where(pos_sel, gt_labels.long()[m], 0)
    return {"boxes": all_boxes, "selected": pos_sel | neg_sel, "pos": pos_sel,
            "labels": labels, "matched_gt": m,
            "reg_targets": encode_boxes(gt_boxes[m], all_boxes)}


def box_head_loss(cls_logits: torch.Tensor, reg: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor,
                  selected: torch.Tensor, pos: torch.Tensor,
                  class_agnostic_reg: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Softmax cross-entropy over the sampled ROIs and smooth L1 (beta 1)
    at the matched class's deltas of the positives, both / the sampled
    count."""
    n_sel = selected.sum().float().clamp_min(1.0)
    zero = torch.zeros((), device=cls_logits.device)
    lsm = torch.log_softmax(cls_logits.float(), dim=-1)
    nll = -lsm.gather(-1, labels[..., None])[..., 0]
    loss_cls = torch.where(selected, nll, zero).sum() / n_sel
    if class_agnostic_reg:
        reg_sel = reg
    else:
        reg_c = reg.reshape(reg.shape[:-1] + (-1, 4))
        idx = labels[..., None, None].expand(labels.shape + (1, 4))
        reg_sel = reg_c.gather(-2, idx)[..., 0, :]
    d = (reg_sel.float() - reg_targets).abs()
    l1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    loss_reg = torch.where(pos, l1, zero).sum() / n_sel
    return {"loss_classifier": loss_cls, "loss_box_reg": loss_reg}


def box_head_inference(cls_logits: torch.Tensor, reg: torch.Tensor,
                       proposals: torch.Tensor, prop_valid: torch.Tensor,
                       image_size: torch.Tensor, num_classes: int,
                       score_thresh: float = 0.05, nms_thresh: float = 0.5,
                       max_detections: int = 100,
                       class_agnostic_reg: bool = False):
    """Per-class decode and class-aware NMS of one image; image_size (h,
    w).  Returns fixed-size (boxes (K, 4), scores (K,), labels (K,) int64
    1-based, valid (K,))."""
    probs = torch.softmax(cls_logits.float(), dim=-1)
    R, C = proposals.shape[0], num_classes - 1
    if class_agnostic_reg:
        boxes = decode_boxes(reg.reshape(R, 4), proposals)[:, None, :]
        boxes = boxes.expand(R, C, 4)
    else:
        reg_c = reg.reshape(R, num_classes, 4)[:, 1:, :]
        boxes = decode_boxes(reg_c, proposals[:, None, :].expand(R, C, 4))
    image_size = torch.as_tensor(image_size, device=boxes.device)
    boxes = clip_boxes(boxes, image_size[0], image_size[1])
    scores = probs[:, 1:]                                        # (R, C)
    valid = (scores > score_thresh) & prop_valid.bool()[:, None]
    flat_boxes = boxes.reshape(R * C, 4)
    flat_scores = torch.where(valid, scores, 0.0).reshape(R * C)
    flat_labels = torch.arange(1, C + 1, device=boxes.device)[None, :]
    flat_labels = flat_labels.expand(R, C).reshape(R * C)
    keep, ok = ml_nms(flat_boxes, flat_scores, flat_labels, nms_thresh,
                      max_detections, valid=valid.reshape(-1))
    return (flat_boxes[keep], torch.where(ok, flat_scores[keep], 0.0),
            flat_labels[keep], ok)


# ---------------------------------------------------------------------
# Mask head
# ---------------------------------------------------------------------
class MaskHead(nn.Module):
    """Four 3x3 convs, a 2x2 stride-2 transposed conv and a per-class 1x1
    (MaskRCNNFPNFeatureExtractor, MaskRCNNC4Predictor).  forward: pooled
    (R, C, P, P) -> mask logits (R, num_classes, 2P, 2P)."""

    def __init__(self, in_channels: int, num_classes: int,
                 channels: int = 256, n_convs: int = 4, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.feature_extractor = nn.Module()
        for i in range(n_convs):
            self.feature_extractor.add_module(
                f"mask_fcn{i + 1}",
                nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                          padding=1))
        self.predictor = nn.Module()
        self.predictor.conv5_mask = nn.ConvTranspose2d(channels, channels, 2,
                                                       stride=2)
        self.predictor.mask_fcn_logits = nn.Conv2d(channels, num_classes, 1)
        _built(self, device, seed)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled
        for conv in self.feature_extractor.children():
            x = F.relu(conv(x))
        x = F.relu(self.predictor.conv5_mask(x))
        return self.predictor.mask_fcn_logits(x)


def mask_head_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                   labels: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-class BCE at the positives, at each ROI's class channel
    (labels - 1): mean over the pixels, / the positives."""
    idx = (labels.long() - 1).clamp_min(0)
    R, _, M, _ = mask_logits.shape
    logits = mask_logits.gather(1, idx[:, None, None, None].expand(R, 1, M, M))
    logits = logits[:, 0].float()
    t = mask_targets.float()
    bce = (logits.clamp_min(0) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    per_roi = bce.mean(dim=(1, 2))
    n_pos = pos.sum().float().clamp_min(1.0)
    return torch.where(pos, per_roi, 0.0).sum() / n_pos


# ---------------------------------------------------------------------
# Keypoint head
# ---------------------------------------------------------------------
class KeypointHead(nn.Module):
    """Eight 3x3 convs, a 4x4 stride-2 transposed conv and a 2x bilinear
    upsample to per-joint heatmaps (KeypointRCNNFeatureExtractor and
    predictor).  forward: pooled (R, C, P, P) -> heatmap logits (R, K, 4P,
    4P)."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 channels: int = 512, n_convs: int = 8, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.feature_extractor = nn.Module()
        for i in range(n_convs):
            self.feature_extractor.add_module(
                f"conv_fcn{i + 1}",
                nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                          padding=1))
        self.predictor = nn.Module()
        # flax's "SAME" padding of a 4x4 stride-2 transposed conv: 4 // 2 - 1
        self.predictor.kps_score_lowres = nn.ConvTranspose2d(
            channels, num_keypoints, 4, stride=2, padding=1)
        _built(self, device, seed)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled
        for conv in self.feature_extractor.children():
            x = F.relu(conv(x))
        x = self.predictor.kps_score_lowres(x)
        H, W = x.shape[-2:]
        return resize_axes(x, {2: 2 * H, 3: 2 * W})


def keypoint_head_loss(kp_logits: torch.Tensor, target_bins: torch.Tensor,
                       target_vis: torch.Tensor, pos: torch.Tensor
                       ) -> torch.Tensor:
    """Spatial softmax cross-entropy of each visible joint of the
    positives, / their count."""
    R, K = kp_logits.shape[:2]
    lsm = torch.log_softmax(kp_logits.float().reshape(R, K, -1), dim=-1)
    nll = -lsm.gather(-1, target_bins.long()[..., None])[..., 0]
    vis = target_vis & pos[:, None]
    n_vis = vis.sum().float().clamp_min(1.0)
    return torch.where(vis, nll, 0.0).sum() / n_vis


def heatmaps_to_keypoints(kp_logits: torch.Tensor, rois: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode heatmaps at their own resolution: each joint's first peak
    bin, mapped to its centre in the ROI (+0.5, bin size = ROI side /
    heatmap side, sides at least 1), as the JAX package decodes (not the
    reference's cubic resize to the ROI).  kp_logits (R, K, H, W), rois
    (R, 4).  Returns keypoints (R, K, 3) fp32 (x, y, 1) and scores (R, K),
    the peak logit."""
    R, K, H, W = kp_logits.shape
    flat = kp_logits.float().reshape(R, K, H * W)
    pos = first_argmax(flat, 2)                                  # (R, K)
    x_int = (pos % W).float()
    y_int = torch.div(pos, W, rounding_mode="floor").float()
    scores = flat.amax(dim=2)
    x1, y1 = rois[:, 0], rois[:, 1]
    w = (rois[:, 2] - rois[:, 0]).clamp_min(1.0)
    h = (rois[:, 3] - rois[:, 1]).clamp_min(1.0)
    x = (x_int + 0.5) * exact_div(w, W)[:, None] + x1[:, None]
    y = (y_int + 0.5) * exact_div(h, H)[:, None] + y1[:, None]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1), scores
