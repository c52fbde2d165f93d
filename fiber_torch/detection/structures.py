"""Instance masks and keypoints, fixed-shape.

The PyTorch counterpart of `fiber_tpu/detection/structures.py`.  Masks are
padded (N, H, W) bool tensors with an (N,) validity mask (polygons are
rasterised on the host when the data is loaded); keypoints are padded (N,
K, 3) tensors (x, y, visibility).  Every transform is a batched tensor op.
The resize is `jax.image.resize`'s antialiased bilinear
(`data/device_transforms.resize_axes`), not `F.interpolate`.
Mask pasting for evaluation (`paste_masks_in_image`) is host numpy, the
reference Masker's arithmetic.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fiber_torch.data.device_transforms import resize_axes
from fiber_torch.detection.roi_align import pool_rows


# ---------------------------------------------------------------------
# host-side polygon rasterisation (the data loader)
# ---------------------------------------------------------------------
def rasterize_polygons(polygons: Sequence[np.ndarray], height: int,
                       width: int) -> np.ndarray:
    """COCO polygon list -> (H, W) bool mask: the union of the polygons,
    each filled even-odd, tested at pixel centres.  Each polygon is tested
    only over its bounding box grown by a pixel: a centre outside it
    crosses none of its edges, or an even number of them."""
    mask = np.zeros((height, width), bool)
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        n = len(p)
        if n == 0:
            continue
        lo = np.floor(p.min(axis=0)).astype(np.int64) - 1
        hi = np.ceil(p.max(axis=0)).astype(np.int64) + 2
        x0, y0 = max(lo[0], 0), max(lo[1], 0)
        x1, y1 = min(hi[0], width), min(hi[1], height)
        if x1 <= x0 or y1 <= y0:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        pts_y = ys + 0.5
        pts_x = xs + 0.5
        inside = np.zeros(pts_y.shape, bool)
        j = n - 1
        for i in range(n):
            xi, yi = p[i]
            xj, yj = p[j]
            cond = ((yi > pts_y) != (yj > pts_y)) & (
                pts_x < (xj - xi) * (pts_y - yi) / (yj - yi + 1e-12) + xi)
            inside ^= cond
            j = i
        mask[y0:y1, x0:x1] |= inside
    return mask


class SegmentationMasks:
    """Padded (N, H, W) bool masks and their (N,) validity."""

    def __init__(self, masks: torch.Tensor, valid: torch.Tensor):
        self.masks = masks
        self.valid = valid

    @classmethod
    def from_polygons(cls, polys_per_instance, height: int, width: int,
                      pad_to: int, device="cuda") -> "SegmentationMasks":
        n = len(polys_per_instance)
        arr = np.zeros((pad_to, height, width), bool)
        for i, polys in enumerate(polys_per_instance[:pad_to]):
            arr[i] = rasterize_polygons(polys, height, width)
        valid = np.zeros((pad_to,), bool)
        valid[:min(n, pad_to)] = True
        return cls(torch.from_numpy(arr).to(device),
                   torch.from_numpy(valid).to(device))

    def resize(self, height: int, width: int) -> "SegmentationMasks":
        out = resize_axes(self.masks.float(), {1: height, 2: width})
        return SegmentationMasks(out > 0.5, self.valid)

    def hflip(self) -> "SegmentationMasks":
        return SegmentationMasks(self.masks.flip(-1), self.valid)

    def crop_and_resize(self, boxes: torch.Tensor, size: int,
                        index: torch.Tensor = None) -> torch.Tensor:
        """Project a mask into each box -> (R, size, size) fp32 targets for
        the mask head: ROIAlignV2 (2 x 2 samples a bin) of mask index[r]
        (default r, one box a mask) at box r."""
        N, H, W = self.masks.shape
        R, dev = boxes.shape[0], boxes.device
        if index is None:
            index = torch.arange(N, device=dev)
        const = lambda v: torch.full((R,), v, dtype=torch.long, device=dev)
        flat = self.masks.reshape(N * H * W, 1).float()
        out = pool_rows(flat, index * (H * W), const(H), const(W),
                        torch.ones(R, dtype=boxes.dtype, device=dev), boxes,
                        size)
        return out[:, 0]

    def areas(self) -> torch.Tensor:
        return self.masks.sum(dim=(1, 2)) * self.valid


# ---------------------------------------------------------------------
# keypoints
# ---------------------------------------------------------------------
COCO_PERSON_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle")

_FLIP_MAP = {name: name.replace("left_", "right_")
             for name in COCO_PERSON_KEYPOINT_NAMES
             if name.startswith("left_")}


def flip_indices() -> np.ndarray:
    """The joint order after a horizontal flip: left and right swapped."""
    idx = np.arange(len(COCO_PERSON_KEYPOINT_NAMES))
    names = list(COCO_PERSON_KEYPOINT_NAMES)
    for left, right in _FLIP_MAP.items():
        li, ri = names.index(left), names.index(right)
        idx[li], idx[ri] = ri, li
    return idx


class Keypoints:
    """Padded (N, K, 3) keypoints (x, y, visibility) and (N,) validity."""

    def __init__(self, kps: torch.Tensor, valid: torch.Tensor):
        self.kps = kps
        self.valid = valid

    def resize(self, scale_y: float, scale_x: float) -> "Keypoints":
        s = torch.tensor([scale_x, scale_y, 1.0], dtype=self.kps.dtype,
                         device=self.kps.device)
        return Keypoints(self.kps * s, self.valid)

    def hflip(self, width: int) -> "Keypoints":
        """Mirror x and swap the left and right joints."""
        idx = torch.from_numpy(flip_indices()).to(self.kps.device)
        kps = self.kps[:, idx]
        x = width - kps[..., 0] - 1
        return Keypoints(torch.stack([x, kps[..., 1], kps[..., 2]], dim=-1),
                         self.valid)

    def to_heatmap_targets(self, boxes: torch.Tensor, heatmap_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each joint's bin y * size + x in its box's size x size grid
        (int64 (N, K)), and whether it is visible, inside the box and of a
        valid instance (bool (N, K))."""
        x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
        w = (boxes[:, 2:3] - boxes[:, 0:1]).clamp_min(1e-6)
        h = (boxes[:, 3:4] - boxes[:, 1:2]).clamp_min(1e-6)
        x = (self.kps[..., 0] - x1) / w * heatmap_size
        y = (self.kps[..., 1] - y1) / h * heatmap_size
        xi = torch.floor(x).clamp(0, heatmap_size - 1).long()
        yi = torch.floor(y).clamp(0, heatmap_size - 1).long()
        inside = ((x >= 0) & (x < heatmap_size)
                  & (y >= 0) & (y < heatmap_size))
        vis = (self.kps[..., 2] > 0) & inside & self.valid.bool()[:, None]
        return yi * heatmap_size + xi, vis


# ---------------------------------------------------------------------
# mask pasting (evaluation, host numpy; the reference Masker)
# ---------------------------------------------------------------------
def _bilinear_resize(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """`F.interpolate(mode="bilinear", align_corners=False)` of one (H, W)
    float array."""
    H, W = mask.shape
    ys = (np.arange(h, dtype=np.float64) + 0.5) * H / h - 0.5
    xs = (np.arange(w, dtype=np.float64) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys), 0, H - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(np.floor(xs), 0, W - 1).astype(np.int64)
    x1 = np.clip(x0 + 1, 0, W - 1)
    # the weights where the source coordinate fell outside [0, H - 1]
    # clamp to the edge (align_corners=False)
    wy = np.clip(ys, 0, H - 1)[:, None] - y0[:, None]
    wx = np.clip(xs, 0, W - 1)[None, :] - x0[None, :]
    v00 = mask[y0][:, x0]
    v01 = mask[y0][:, x1]
    v10 = mask[y1][:, x0]
    v11 = mask[y1][:, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def paste_mask_in_image(mask: np.ndarray, box: np.ndarray, im_h: int,
                        im_w: int, thresh: float = 0.5,
                        padding: int = 1) -> np.ndarray:
    """One (M, M) mask probability -> (im_h, im_w) bool: padded by
    `padding`, its box grown by (M + 2 p) / M about the centre and cast to
    int32, resized bilinear to the box's inclusive size, thresholded and
    pasted, clipped to the image."""
    M = mask.shape[-1]
    pad2 = 2 * padding
    scale = float(M + pad2) / M
    padded = np.zeros((M + pad2, M + pad2), np.float64)
    padded[padding:-padding, padding:-padding] = mask

    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    x_c = (box[2] + box[0]) * 0.5
    y_c = (box[3] + box[1]) * 0.5
    ebox = np.array([x_c - w_half, y_c - h_half, x_c + w_half,
                     y_c + h_half]).astype(np.int32)

    w = max(int(ebox[2] - ebox[0] + 1), 1)
    h = max(int(ebox[3] - ebox[1] + 1), 1)
    resized = _bilinear_resize(padded, h, w)
    binm = resized > thresh if thresh >= 0 else resized > 0

    im_mask = np.zeros((im_h, im_w), bool)
    x_0 = max(int(ebox[0]), 0)
    x_1 = min(int(ebox[2]) + 1, im_w)
    y_0 = max(int(ebox[1]), 0)
    y_1 = min(int(ebox[3]) + 1, im_h)
    if x_1 > x_0 and y_1 > y_0:
        im_mask[y_0:y_1, x_0:x_1] = binm[
            y_0 - ebox[1]:y_1 - ebox[1], x_0 - ebox[0]:x_1 - ebox[0]]
    return im_mask


def paste_masks_in_image(mask_probs, boxes, im_h: int, im_w: int,
                         thresh: float = 0.5, padding: int = 1) -> np.ndarray:
    """(N, M, M) mask probabilities and (N, 4) xyxy boxes (numpy arrays or
    tensors on any device) -> (N, im_h, im_w) bool masks, as
    `evaluation.coco_map(iou_type="segm")` scores them."""
    host = lambda a: np.asarray(a.detach().cpu() if torch.is_tensor(a)
                                else a, np.float64)
    mask_probs, boxes = host(mask_probs), host(boxes)
    if len(mask_probs) == 0:
        return np.zeros((0, im_h, im_w), bool)
    return np.stack([paste_mask_in_image(m, b, im_h, im_w, thresh, padding)
                     for m, b in zip(mask_probs, boxes)])
