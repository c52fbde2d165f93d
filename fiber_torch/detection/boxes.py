"""Box geometry and NMS for detection inference, as fixed-shape tensor ops.

The PyTorch counterpart of the inference half of
`fiber_tpu/detection/boxes.py`.  Boxes are (..., 4) xyxy tensors; padded
rows are tracked by a separate validity mask, so every shape is fixed and
NMS runs as a fixed number of device steps with no read-back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# log(1000 / 16): the largest width / height delta the decoder takes
BBOX_XFORM_CLIP = 4.135166556742356


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy (..., 4) -> area, float convention (x2 - x1, no +1)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) IoU matrix (float convention)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp_min(1e-9)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_outputs: int,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over each row of a batch: boxes (B, N, 4), scores (B, N),
    valid (B, N) bool.

    `max_outputs` steps, each picking the highest live score (the lowest
    index among equal scores) and suppressing the boxes whose IoU with it,
    in the legacy +1 pixel convention, is at least `iou_threshold`.  No
    step reads a value back to the host.  Returns (keep (B, max_outputs)
    int64, ok (B, max_outputs) bool); a slot past the live boxes has index
    0 and ok False."""
    B, n = scores.shape
    live = (torch.ones((B, n), dtype=torch.bool, device=scores.device)
            if valid is None else valid.bool().clone())
    area = ((boxes[..., 2] - boxes[..., 0] + 1)
            * (boxes[..., 3] - boxes[..., 1] + 1))
    ar = torch.arange(n, device=scores.device)
    neg = torch.full_like(scores, NEG_INF)
    keep, ok = [], []
    for _ in range(max_outputs):
        masked = torch.where(live, scores, neg)
        idx = masked.argmax(dim=1, keepdim=True)                 # (B, 1)
        ok.append(masked.gather(1, idx)[:, 0] > NEG_INF / 2)
        keep.append(idx[:, 0])
        box = boxes.gather(1, idx[..., None].expand(B, 1, 4))    # (B, 1, 4)
        lt = torch.maximum(box[..., :2], boxes[..., :2])
        rb = torch.minimum(box[..., 2:], boxes[..., 2:])
        wh = (rb - lt + 1).clamp_min(0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area.gather(1, idx) + area - inter)
        live = live & ~(iou >= iou_threshold) & (ar != idx)
    return torch.stack(keep, 1), torch.stack(ok, 1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int, valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`batched_nms` of one image: boxes (N, 4), scores (N,) ->
    (keep (max_outputs,), ok (max_outputs,))."""
    keep, ok = batched_nms(boxes[None], scores[None], iou_threshold,
                           max_outputs,
                           None if valid is None else valid[None])
    return keep[0], ok[0]


def batched_ml_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   labels: torch.Tensor, iou_threshold: float,
                   max_outputs: int, valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS over each row of a batch: boxes of different labels
    never suppress each other.  Each label is moved into its own region,
    offset by the span max - min + 1 of all the row's boxes, valid or
    not."""
    span = (boxes.amax(dim=(1, 2)) - boxes.amin(dim=(1, 2)) + 1.0)
    offset = labels.to(boxes.dtype)[..., None] * span[:, None, None]
    return batched_nms(boxes + offset, scores, iou_threshold, max_outputs,
                       valid=valid)


def ml_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
           iou_threshold: float, max_outputs: int,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`batched_ml_nms` of one image."""
    keep, ok = batched_ml_nms(boxes[None], scores[None], labels[None],
                              iou_threshold, max_outputs,
                              None if valid is None else valid[None])
    return keep[0], ok[0]


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10., 10., 5., 5.),
                 clamp: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas on anchors -> xyxy boxes: inclusive +1
    anchor widths, midpoint centres, x1 = ctr - 0.5 (w - 1), x2 = ctr +
    0.5 (w - 1), the width and height deltas clamped at `clamp`."""
    aw = anchors[..., 2] - anchors[..., 0] + 1
    ah = anchors[..., 3] - anchors[..., 1] + 1
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clamp)
    dh = (deltas[..., 3] / wh).clamp(max=clamp)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                        cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy boxes into [0, width - 1] x [0, height - 1]; `height` and
    `width` are numbers or tensors that broadcast against boxes[..., 0]."""
    hi_y, hi_x = (torch.as_tensor(v, dtype=boxes.dtype,
                                  device=boxes.device) - 1
                  for v in (height, width))
    return torch.stack([
        torch.minimum(boxes[..., 0].clamp_min(0), hi_x),
        torch.minimum(boxes[..., 1].clamp_min(0), hi_y),
        torch.minimum(boxes[..., 2].clamp_min(0), hi_x),
        torch.minimum(boxes[..., 3].clamp_min(0), hi_y)], dim=-1)


def remove_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Validity mask of the boxes whose sides (+1) are both >= min_size."""
    w = boxes[..., 2] - boxes[..., 0] + 1
    h = boxes[..., 3] - boxes[..., 1] + 1
    return (w >= min_size) & (h >= min_size)
