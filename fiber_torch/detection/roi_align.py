"""ROIAlign and ROIPool as gathers, in plain PyTorch.

The PyTorch counterpart of `fiber_tpu/detection/roi_align.py`.  Bilinear
sampling is four row gathers from a (rows, C) view of the feature map and
a weighted sum; autograd gives the backward (a scatter-add).  Each ROI may
read a map of its own: `pool_rows` takes per-ROI row offsets, heights,
widths and scales into one flat buffer, so that FPN levels
(`roi_heads.multilevel_roi_align`) and instance masks
(`structures.SegmentationMasks.crop_and_resize`) pool every box from its
own map in one pass, with no pass over the maps it does not read.
"""

from __future__ import annotations

import torch


def exact_div(a: torch.Tensor, n) -> torch.Tensor:
    """a / n correctly rounded on every device.  CUDA divides by a host
    number through its reciprocal, which can round a sample position an
    ulp away from the host's (and the JAX package's) and move it across a
    pixel: the bilinear weights' gradient jumps there."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def flat_rows(feature: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (H W, C), row y W + x holding pixel (y, x)."""
    return feature.flatten(1).t()


def _bilinear(flat: torch.Tensor, base: torch.Tensor, H: torch.Tensor,
              W: torch.Tensor, y: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """Bilinear samples at (y, x) of the map whose pixel (0, 0) is row
    `base` of `flat` (rows, C), of size H x W; base, H and W broadcast
    against y and x.  A sample outside (-1, H) x (-1, W) is 0.  Returns
    (..., C)."""
    Hf, Wf = H.to(y.dtype), W.to(x.dtype)
    valid = (y > -1.0) & (y < Hf) & (x > -1.0) & (x < Wf)
    y = torch.minimum(y.clamp_min(0.0), Hf - 1)
    x = torch.minimum(x.clamp_min(0.0), Wf - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.minimum(y0 + 1, H - 1)
    x1 = torch.minimum(x0 + 1, W - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]
    row0, row1 = base + y0 * W, base + y1 * W
    v00, v01 = flat[row0 + x0], flat[row0 + x1]
    v10, v11 = flat[row1 + x0], flat[row1 + x1]
    out = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
           + v10 * ly * (1 - lx) + v11 * ly * lx)
    return out * valid[..., None]


def pool_rows(flat: torch.Tensor, base: torch.Tensor, H: torch.Tensor,
              W: torch.Tensor, scale: torch.Tensor, rois: torch.Tensor,
              output_size: int, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """ROIAlign of each ROI r on its own map: rows base[r] ... of `flat`
    (rows, C), H[r] x W[r], at spatial scale scale[r] (int64 / fp32 (R,)
    tensors).  rois (R, 4) xyxy in image coordinates.  Returns (R, C, P,
    P), P = output_size: the mean of S x S bilinear samples a bin, S =
    sampling_ratio.  `aligned` is ROIAlignV2 (half-pixel offset);
    otherwise the legacy kernel (ROI sides at least 1)."""
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    x2 = rois[:, 2] * scale - off
    y2 = rois[:, 3] * scale - off
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
    P, S = output_size, sampling_ratio
    R = rois.shape[0]
    bin_h = exact_div(rh, P)
    bin_w = exact_div(rw, P)
    dev = rois.device
    sub = exact_div(torch.arange(S, device=dev, dtype=rois.dtype) + 0.5, S)
    iy = torch.arange(P, device=dev)[None, :, None] + sub[None, None, :]
    ys = (y1[:, None, None] + iy * bin_h[:, None, None]).reshape(R, P * S)
    xs = (x1[:, None, None] + iy * bin_w[:, None, None]).reshape(R, P * S)
    yy = ys[:, :, None].expand(R, P * S, P * S)
    xx = xs[:, None, :].expand(R, P * S, P * S)
    col = lambda t: t.reshape(R, 1, 1)
    # (R, PS, PS, C)
    sampled = _bilinear(flat, col(base), col(H), col(W), yy, xx)
    C = sampled.shape[-1]
    pooled = sampled.reshape(R, P, S, P, S, C).mean(dim=(2, 4))
    return pooled.permute(0, 3, 1, 2)


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """features (C, H, W), one image; rois (R, 4) xyxy in image
    coordinates.  Returns (R, C, P, P) (`pool_rows` on the one map)."""
    _, H, W = features.shape
    R, dev = rois.shape[0], rois.device
    const = lambda v, dt: torch.full((R,), v, dtype=dt, device=dev)
    return pool_rows(flat_rows(features), const(0, torch.long),
                     const(H, torch.long), const(W, torch.long),
                     const(spatial_scale, rois.dtype), rois, output_size,
                     sampling_ratio, aligned)


def roi_pool(features: torch.Tensor, rois: torch.Tensor, output_size: int,
             spatial_scale: float) -> torch.Tensor:
    """ROI pooling as the JAX package writes it: `roi_align`'s mean of 4 x
    4 samples a bin, unaligned (not the reference kernel's max)."""
    return roi_align(features, rois, output_size, spatial_scale,
                     sampling_ratio=4, aligned=False)
