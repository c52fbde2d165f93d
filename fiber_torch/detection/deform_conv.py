"""Modulated deformable convolution (DCNv2), 3x3, padding 1, in plain
PyTorch.

The PyTorch counterpart of `fiber_tpu/detection/deform_conv.py::
modulated_deform_conv2d`, batched directly and in NCHW.  All nine taps are
sampled at once: each sample position is fp32 `base + (k - 1) + offset`,
its four corners are gathered from the map padded by a zero border (a
corner outside the map reads 0, so a sample that straddles the border gets
part of its weight), a sample outside (-1, H) x (-1, W) is 0, and the
result is weighted by the mask.  One im2col product in the input's dtype
then applies the weight.  The positions are rounded exactly as the JAX
package rounds them, not through `F.grid_sample`, whose coordinate
normalisation rounds them another way.

Offsets are DCNv2's: channel 2k holds tap k's dy, channel 2k + 1 its dx,
taps in row-major order.

`deform_psroi_pool` is the deformable position-sensitive ROI pooling of
the same JAX module, a gather of one channel a sample.
"""

from __future__ import annotations

from typing import Optional

import torch

from fiber_torch.detection.roi_align import exact_div

# the 3x3 taps' offsets from the centre, row-major
_TAP_DY = (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
_TAP_DX = (-1.0, 0.0, 1.0, -1.0, 0.0, 1.0, -1.0, 0.0, 1.0)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1) -> torch.Tensor:
    """x (B, Cin, H, W); offset (B, 18, Ho, Wo); mask (B, 9, Ho, Wo) in
    [0, 1]; weight (Cout, Cin, 3, 3).  Returns (B, Cout, Ho, Wo) in x's
    dtype, Ho and Wo being the offsets' (ceil(H / stride) for a 3x3 conv
    with padding 1)."""
    B, Cin, H, W = x.shape
    Cout = weight.shape[0]
    Ho, Wo = offset.shape[-2:]
    f32, dev = torch.float32, x.device
    K = len(_TAP_DY)
    off = offset.permute(0, 2, 3, 1).float()                  # (B, Ho, Wo, 2K)
    # the grid in the input's dtype, as the JAX package builds it
    base_y = (torch.arange(Ho, device=dev).to(x.dtype) * stride).float()
    base_x = (torch.arange(Wo, device=dev).to(x.dtype) * stride).float()
    tap_y = torch.tensor(_TAP_DY, dtype=f32, device=dev)
    tap_x = torch.tensor(_TAP_DX, dtype=f32, device=dev)
    sy = (base_y[:, None, None] + tap_y) + off[..., 0::2]    # (B, Ho, Wo, K)
    sx = (base_x[None, :, None] + tap_x) + off[..., 1::2]
    valid = (sy > -1.0) & (sy < H) & (sx > -1.0) & (sx < W)
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    ly, lx = (sy - y0f)[..., None], (sx - x0f)[..., None]
    # corner (y0, x0) sits at (y0 + 1, x0 + 1) of the zero-bordered map;
    # clamping keeps the (already zeroed) outside samples in range
    Hp, Wp = H + 2, W + 2
    yi = (y0f.long() + 1).clamp(0, H)
    xi = (x0f.long() + 1).clamp(0, W)
    b = torch.arange(B, device=dev)[:, None, None, None]
    idx = (b * Hp + yi) * Wp + xi                            # (B, Ho, Wo, K)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1)
    xp = xp.reshape(B * Hp * Wp, Cin)
    sampled = (xp[idx] * ((1 - ly) * (1 - lx)) + xp[idx + 1] * ((1 - ly) * lx)
               + xp[idx + Wp] * (ly * (1 - lx)) + xp[idx + Wp + 1] * (ly * lx))
    w_pt = valid.float() * mask.permute(0, 2, 3, 1).float()
    cols = (sampled * w_pt[..., None]).to(x.dtype)           # (B, Ho, Wo, K, Cin)
    wmat = weight.permute(2, 3, 1, 0).reshape(K * Cin, Cout).to(x.dtype)
    out = torch.matmul(cols.reshape(B * Ho * Wo, K * Cin), wmat)
    if bias is not None:
        out = out.float() + bias.to(x.dtype).float()
    return out.to(x.dtype).reshape(B, Ho, Wo, Cout).permute(0, 3, 1, 2)


def deform_psroi_pool(x: torch.Tensor, rois: torch.Tensor,
                      trans: Optional[torch.Tensor], *, spatial_scale: float,
                      output_dim: int, group_size: int, pooled_size: int,
                      part_size: Optional[int] = None,
                      sample_per_part: int = 4,
                      trans_std: float = 0.0) -> torch.Tensor:
    """Deformable position-sensitive ROI pooling (the reference's
    DeformablePSROIPoolForwardKernel) of one image.

    x (C, H, W) with C = output_dim * group_size ** 2; rois (R, 4) xyxy in
    image coordinates; trans (R, num_classes, 2, part_size, part_size)
    normalised bin offsets (x then y), or None.  Returns (R, output_dim,
    P, P), P = pooled_size: for each output channel and bin the mean of
    its sample_per_part ** 2 bilinear samples that fall inside the map,
    read from that bin's channel of the channel group (0 where none
    falls inside).  Each sample gathers only its one channel, from a (H W
    C,) view of x; autograd gives the backward."""
    C, H, W = x.shape
    P, S = pooled_size, sample_per_part
    part_size = pooled_size if part_size is None else part_size
    R, dev, f32 = rois.shape[0], x.device, torch.float32
    rois = rois.float()
    start_w = torch.round(rois[:, 0]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 1]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    roi_w = (end_w - start_w).clamp_min(0.1)
    roi_h = (end_h - start_h).clamp_min(0.1)
    bin_w, bin_h = exact_div(roi_w, P), exact_div(roi_h, P)
    sub_w, sub_h = exact_div(bin_w, S), exact_div(bin_h, S)

    ph = torch.arange(P, device=dev)
    part = torch.floor(exact_div(ph.to(f32), P) * part_size).long()
    ctop = torch.arange(output_dim, device=dev)
    if trans is not None:
        per_class = output_dim // trans.shape[1]
        t = trans.float()[:, ctop // per_class]           # (R, OD, 2, ps, ps)
        t = t[:, :, :, part][:, :, :, :, part]            # (R, OD, 2, P, P)
        trans_x, trans_y = t[:, :, 0] * trans_std, t[:, :, 1] * trans_std
    else:
        trans_x = trans_y = torch.zeros((R, 1, P, P), dtype=f32, device=dev)

    col = lambda v: v[:, None, None, None]
    pf = ph.to(f32)
    wstart = pf[None, None, None, :] * col(bin_w) + col(start_w) \
        + trans_x * col(roi_w)                            # (R, OD|1, P, P)
    hstart = pf[None, None, :, None] * col(bin_h) + col(start_h) \
        + trans_y * col(roi_h)
    iw = torch.arange(S, dtype=f32, device=dev)
    sw = wstart[..., None, None] + iw[None, None, None, None, None, :] \
        * sub_w[:, None, None, None, None, None]          # (R, ., P, P, S, S)
    sh = hstart[..., None, None] + iw[None, None, None, None, :, None] \
        * sub_h[:, None, None, None, None, None]
    keep = (sw >= -0.5) & (sw <= W - 0.5) & (sh >= -0.5) & (sh <= H - 0.5)
    swc = sw.clamp(0.0, W - 1.0)
    shc = sh.clamp(0.0, H - 1.0)
    x0 = torch.floor(swc).long()
    x1 = torch.ceil(swc).long().clamp(max=W - 1)
    y0 = torch.floor(shc).long()
    y1 = torch.ceil(shc).long().clamp(max=H - 1)
    lx, ly = swc - x0, shc - y0

    # the channel of output channel ctop at bin (ph, pw): its group's
    # (gh, gw) member
    G = group_size
    g = ((ph * G) // P).clamp(0, G - 1)
    cidx = (ctop[:, None, None] * G + g[None, :, None]) * G + g[None, None, :]
    c = cidx[None, :, :, :, None, None]                   # (1, OD, P, P, 1, 1)
    flat = x.float().permute(1, 2, 0).reshape(-1)         # (H W C,)
    corner = lambda yi, xi: flat[(yi * W + xi) * C + c]
    val = (corner(y0, x0) * ((1 - ly) * (1 - lx))
           + corner(y1, x0) * (ly * (1 - lx))
           + corner(y0, x1) * ((1 - ly) * lx)
           + corner(y1, x1) * (ly * lx))
    keep = keep.expand(val.shape)
    val = val * keep
    counts = keep.sum(dim=(-1, -2)).to(f32)               # (R, OD, P, P)
    summed = val.sum(dim=(-1, -2))
    out = torch.where(counts > 0, summed / counts.clamp_min(1.0),
                      torch.zeros_like(summed))
    return out.to(x.dtype)
