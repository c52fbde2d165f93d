"""Multi-scale and flip test-time augmentation with box voting.

The PyTorch counterpart of `fiber_tpu/detection/box_aug.py`: inference at
each scale and its horizontal flip, the detections of every pass in the
original image's coordinates, then a vote-merge of overlapping same-class
boxes weighted by score and a class-aware NMS, on the host in numpy.  The
scales resize as `jax.image.resize` does (antialiased bilinear,
`data/loader.resize_bilinear`).  `detector_infer_fn` makes the per-pass
function from the port's `detection_inference`.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from fiber_torch.data.loader import resize_bilinear
from fiber_torch.detection.detector import detection_inference


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def box_voting(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
               vote_thresh: float = 0.66, score_method: str = "avg"
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge each cluster of same-class boxes at IoU >= vote_thresh with
    the highest unused box (and that box itself, also when it has no
    area) into their score-weighted mean; its score the cluster's mean
    ("avg") or max."""
    order = np.argsort(-scores)
    boxes, scores, labels = boxes[order], scores[order], labels[order]
    used = np.zeros(len(boxes), bool)
    out_b, out_s, out_l = [], [], []
    for i in range(len(boxes)):
        if used[i]:
            continue
        same = (labels == labels[i]) & ~used
        iou = _iou_matrix(boxes[i:i + 1], boxes)[0]
        cluster = same & (iou >= vote_thresh)
        # a zero-area box has IoU 0 with itself; it still votes for itself
        cluster[i] = True
        used |= cluster
        w = scores[cluster]
        out_b.append((boxes[cluster] * w[:, None]).sum(0) / w.sum())
        out_s.append(float(w.mean()) if score_method == "avg"
                     else float(w.max()))
        out_l.append(labels[i])
    return (np.asarray(out_b).reshape(-1, 4), np.asarray(out_s),
            np.asarray(out_l, labels.dtype))


def _nms_host(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
              thresh: float) -> np.ndarray:
    """Greedy class-aware NMS on the host -> kept indices, best first."""
    keep = []
    order = np.argsort(-scores)
    supp = np.zeros(len(boxes), bool)
    for i in order:
        if supp[i]:
            continue
        keep.append(i)
        same = labels == labels[i]
        iou = _iou_matrix(boxes[i:i + 1], boxes)[0]
        supp |= same & (iou >= thresh)
    return np.asarray(keep, np.int64)


def im_detect_bbox_aug(
    infer_fn: Callable[[np.ndarray, bool], Dict[str, np.ndarray]],
    image: np.ndarray, scales: Sequence[float] = (0.75, 1.0, 1.25),
    hflip: bool = True, vote_thresh: float = 0.66, nms_thresh: float = 0.5,
    max_detections: int = 100, use_voting: bool = True,
) -> Dict[str, np.ndarray]:
    """Run `infer_fn(image at a scale, flipped) -> {boxes, scores,
    labels}` (boxes in the frame of the image it was given) over the scale
    and flip grid, map the boxes back to `image`'s frame, vote and NMS.
    image (H, W, C)."""
    all_b, all_s, all_l = [], [], []
    h, w = image.shape[:2]
    for s in scales:
        for flip in ((False, True) if hflip else (False,)):
            img = image
            if s != 1.0:
                img = resize_bilinear(image.astype(np.float32), int(h * s),
                                      int(w * s)).astype(image.dtype)
            if flip:
                img = img[:, ::-1]
            det = infer_fn(img, flip)
            b = np.asarray(det["boxes"], np.float32) / s
            if flip:
                b = np.stack([w - b[:, 2] - 1, b[:, 1], w - b[:, 0] - 1,
                              b[:, 3]], 1)
            all_b.append(b)
            all_s.append(np.asarray(det["scores"], np.float32))
            all_l.append(np.asarray(det["labels"]))
    boxes, scores = np.concatenate(all_b), np.concatenate(all_s)
    labels = np.concatenate(all_l)
    if len(boxes) == 0:
        return {"boxes": boxes, "scores": scores, "labels": labels}
    if use_voting:
        boxes, scores, labels = box_voting(boxes, scores, labels, vote_thresh)
    keep = _nms_host(boxes, scores, labels, nms_thresh)[:max_detections]
    return {"boxes": boxes[keep], "scores": scores[keep],
            "labels": labels[keep]}


def detector_infer_fn(model, input_ids, attention_mask, agg_matrix,
                      size_divisible: int = 32, **pp_kwargs
                      ) -> Callable[[np.ndarray, bool], Dict[str, np.ndarray]]:
    """`infer_fn` for `im_detect_bbox_aug` over the port's
    `detection_inference`: the (h, w, 3) image zero-padded at the bottom
    and right to multiples of `size_divisible`, one pass with the (1, T)
    prompt, its valid detections as numpy in the image's frame."""
    def infer(img: np.ndarray, flipped: bool) -> Dict[str, np.ndarray]:
        h, w = img.shape[:2]
        H = -(-h // size_divisible) * size_divisible
        W = -(-w // size_divisible) * size_divisible
        canvas = np.zeros((1, H, W, img.shape[2]), np.float32)
        canvas[0, :h, :w] = img
        det = detection_inference(
            model, {"images": canvas, "input_ids": input_ids,
                    "attention_mask": attention_mask,
                    "image_sizes": np.asarray([[h, w]], np.float32)},
            agg_matrix, **pp_kwargs)
        ok = det.valid[0]
        return {"boxes": det.boxes[0][ok].float().cpu().numpy(),
                "scores": det.scores[0][ok].float().cpu().numpy(),
                "labels": det.labels[0][ok].cpu().numpy()}

    return infer
