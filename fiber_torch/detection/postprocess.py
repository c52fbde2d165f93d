"""ATSS postprocessing: grounding logits to class scores, per-level top-k,
decode, class-aware NMS, all at fixed shapes.

The PyTorch counterpart of `fiber_tpu/detection/postprocess.py`.  Each
image's dynamic candidate list of the reference becomes a fixed-size top-k
with a validity mask, and the grounding-to-class conversion one (A, T) x
(T, C) product.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from fiber_torch.detection.boxes import (batched_ml_nms, clip_boxes,
                                         decode_boxes, remove_small_boxes)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4)
    scores: torch.Tensor   # (B, K)
    labels: torch.Tensor   # (B, K) int64, 1-based class ids
    valid: torch.Tensor    # (B, K) bool


def label_to_token_matrix(positive_map_label_to_token: Dict[int, Sequence[int]],
                          num_classes: int, num_tokens: int) -> np.ndarray:
    """Dense (C, T) mean-aggregation matrix from the {label: [token ids]}
    map built at query time."""
    m = np.zeros((num_classes, num_tokens), np.float32)
    for label, toks in positive_map_label_to_token.items():
        if len(toks):
            m[label - 1, list(toks)] = 1.0 / len(toks)
    return m


def grounding_to_od_scores(dot_product_logits: torch.Tensor,
                           agg_matrix: torch.Tensor) -> torch.Tensor:
    """sigmoid(logits) (B, A, T) times the (C, T) mean aggregation ->
    (B, A, C), in fp32."""
    probs = torch.sigmoid(dot_product_logits.float())
    return torch.matmul(probs, agg_matrix.float().t())


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest of each row, and their indices, the lower index first
    among equal values (as `lax.top_k` orders them; `torch.topk` promises
    no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def atss_postprocess(head_out: Dict[str, List[torch.Tensor]],
                     anchors_per_level: Sequence[torch.Tensor],
                     agg_matrix: torch.Tensor, image_sizes: torch.Tensor,
                     pre_nms_thresh: float = 0.05, pre_nms_top_n: int = 1000,
                     nms_thresh: float = 0.6, post_nms_top_n: int = 100,
                     min_size: float = 0.0) -> Detections:
    """Per level: sigmoid, mean aggregation over the (C, T) matrix, the
    candidate threshold, times the centerness, top-k over the flat (A C),
    decode, clip to each image's (h, w), small-box removal and the square
    root of the score.  Then class-aware NMS over all levels, per image."""
    num_classes = agg_matrix.shape[0]
    B = head_out["centerness"][0].shape[0]
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for lvl, anchors in enumerate(anchors_per_level):
        ctr = torch.sigmoid(
            head_out["centerness"][lvl].reshape(B, -1).float())
        reg = head_out["bbox_reg"][lvl].reshape(B, -1, 4)
        scores = grounding_to_od_scores(head_out["dot_product_logits"][lvl],
                                        agg_matrix)          # (B, A, C)
        candidate = scores > pre_nms_thresh
        scores = scores * ctr[:, :, None]
        A = scores.shape[1]
        k = min(pre_nms_top_n, A * num_classes)
        flat = torch.where(candidate, scores, torch.zeros_like(scores))
        top_scores, top_idx = top_k_stable(flat.reshape(B, -1), k)
        loc = torch.div(top_idx, num_classes, rounding_mode="floor")
        cls = top_idx % num_classes + 1
        valid = top_scores > 0.0
        deltas = reg.gather(1, loc[..., None].expand(B, k, 4))
        boxes = decode_boxes(deltas, anchors[loc])
        boxes = clip_boxes(boxes, image_sizes[:, 0:1].to(boxes.dtype),
                           image_sizes[:, 1:2].to(boxes.dtype))
        valid = valid & remove_small_boxes(boxes, min_size)
        all_boxes.append(boxes)
        all_scores.append(torch.sqrt(top_scores.clamp_min(0.0)))
        all_labels.append(cls)
        all_valid.append(valid)

    boxes = torch.cat(all_boxes, 1)
    scores = torch.cat(all_scores, 1)
    labels = torch.cat(all_labels, 1)
    valid = torch.cat(all_valid, 1)
    keep, ok = batched_ml_nms(boxes, scores, labels, nms_thresh,
                              post_nms_top_n, valid=valid)
    kept = lambda t: t.gather(1, keep)
    return Detections(
        boxes=boxes.gather(1, keep[..., None].expand(*keep.shape, 4)),
        scores=torch.where(ok, kept(scores), torch.zeros_like(kept(scores))),
        labels=kept(labels), valid=ok)
