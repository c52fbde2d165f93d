"""Modulated deformable convolution (DCNv2), 3x3, padding 1, in plain
PyTorch: the reference's frozen copy of the port's
`fiber_torch/detection/deform_conv.py::modulated_deform_conv2d`.  All
nine taps are sampled at once at fp32 positions `base + (k - 1) +
offset`; the four corners are gathered from the map padded by a zero
border; a sample outside (-1, H) x (-1, W) is 0; the mask weighs each
sample; one im2col product applies the weight.  Offsets are DCNv2's:
channel 2k holds tap k's dy, 2k + 1 its dx, taps in row-major order.
"""

from __future__ import annotations

from typing import Optional

import torch


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


