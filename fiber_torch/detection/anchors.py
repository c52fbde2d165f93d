"""Anchor generation for FPN levels (static numpy).

The port's copy of `fiber_tpu/detection/anchors.py` (numpy only, bit-equal
to it).  One anchor per cell, sizes 64..1024 octave x stride 8..128, aspect
1.0 (the reference's FIBER detection configs).  Anchors depend only on the
padded feature sizes, so they are numpy constants cached per shape.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def cell_anchors(size: int, aspect_ratios: Tuple[float, ...] = (1.0,),
                 octave: float = 2.0, scales_per_octave: int = 1
                 ) -> np.ndarray:
    """(A, 4) anchors centered at the origin for one level."""
    out = []
    for i in range(scales_per_octave):
        s = size * (octave ** (i / scales_per_octave))
        area = s * s
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = w * ar
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=None)
def grid_anchors(feat_h: int, feat_w: int, stride: int, size: int,
                 aspect_ratios: Tuple[float, ...] = (1.0,),
                 scales_per_octave: int = 1) -> np.ndarray:
    """(feat_h * feat_w * A, 4) anchors in image coordinates, row-major
    over (y, x, anchor) like the reference grid ordering."""
    base = cell_anchors(size, aspect_ratios,
                        scales_per_octave=scales_per_octave)  # (A, 4)
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    cx, cy = np.meshgrid(xs, ys)                    # (H, W)
    shifts = np.stack([cx, cy, cx, cy], axis=-1)    # (H, W, 4)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]
    return anchors.reshape(-1, 4)


def fpn_anchors(feat_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int] = (8, 16, 32, 64, 128),
                sizes: Sequence[int] = (64, 128, 256, 512, 1024),
                aspect_ratios: Tuple[float, ...] = (1.0,),
                scales_per_octave: int = 1) -> List[np.ndarray]:
    """Per-level anchors for the FIBER detection FPN."""
    return [grid_anchors(h, w, st, sz, aspect_ratios,
                         scales_per_octave=scales_per_octave)
            for (h, w), st, sz in zip(feat_sizes, strides, sizes)]
