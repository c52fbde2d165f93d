"""Modulated deformable convolution (DCNv2), 3x3, padding 1.

`modulated_deform_conv2d` is the PyTorch counterpart of
`fiber_tpu/detection/deform_conv.py::modulated_deform_conv2d`, batched
directly and in NCHW.  All nine taps are sampled at once: each sample
position is fp32 `base + (k - 1) + offset`, its four corners are read from
the map with a zero border (a corner outside the map reads 0, so a sample
that straddles the border gets part of its weight), a sample outside (-1,
H) x (-1, W) is 0, and the result is weighted by the mask.  One im2col
product in the input's dtype then applies the weight.  The positions are
rounded exactly as the JAX package rounds them, not through
`F.grid_sample`, whose coordinate normalisation rounds them another way.

On a CPU tensor it runs `_modulated_deform_conv2d_plain`, the plain
PyTorch version (about 35 small ops: four corner gathers and fp32
elementwise products), and autograd differentiates it.  On a CUDA tensor
the sampling is one hand-written kernel, `deform_im2col`
(`fiber_torch/csrc/deform_im2col.cu`), which writes the plain version's
im2col matrix bit for bit; the product with the weight stays a
`torch.matmul`, so the layer's output keeps the plain version's bits.
When grad is enabled and an input requires it, the kernel runs inside
`_DeformConvFunction`, which saves only its inputs and whose backward
recomputes the plain version and returns its vector-Jacobian product.
On the card the kernel launches or raises: there is no fallback to the
plain version in the forward.

Offsets are DCNv2's: channel 2k holds tap k's dy, channel 2k + 1 its dx,
taps in row-major order.

`deform_psroi_pool` is the deformable position-sensitive ROI pooling of
the same JAX module, a gather of one channel a sample.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fiber_torch.detection.roi_align import exact_div

_TAPS = 9  # the 3x3 taps, row-major
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _apply_weight(cols: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], B: int, Ho: int, Wo: int
                  ) -> torch.Tensor:
    """The im2col product: cols (B Ho Wo, 9 Cin) times the weight
    (Cout, Cin, 3, 3), both in cols' dtype, the bias added in fp32; (B,
    Cout, Ho, Wo) in cols' dtype."""
    dt, Cout = cols.dtype, weight.shape[0]
    wmat = weight.permute(2, 3, 1, 0).reshape(-1, Cout).to(dt)
    out = torch.matmul(cols, wmat)
    if bias is not None:
        out = out.float() + bias.to(dt).float()
    return out.to(dt).reshape(B, Ho, Wo, Cout).permute(0, 3, 1, 2)


def _deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                         mask: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The plain version of the sampling: the im2col matrix (B Ho Wo,
    9 Cin) in x's dtype, in PyTorch operations that autograd
    differentiates."""
    B, Cin, H, W = x.shape
    Ho, Wo = offset.shape[-2:]
    dev = x.device
    off = offset.permute(0, 2, 3, 1).float()                  # (B, Ho, Wo, 2K)
    # the grid in the input's dtype, as the JAX package builds it
    base_y = (torch.arange(Ho, device=dev).to(x.dtype) * stride).float()
    base_x = (torch.arange(Wo, device=dev).to(x.dtype) * stride).float()
    # the taps' offsets from the centre, made on the device: a copy from
    # the host would wait for the device
    k = torch.arange(_TAPS, device=dev)
    tap_y, tap_x = (k // 3 - 1).float(), (k % 3 - 1).float()
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
    return cols.reshape(B * Ho * Wo, _TAPS * Cin)


def _modulated_deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                                   mask: torch.Tensor, weight: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None,
                                   stride: int = 1) -> torch.Tensor:
    """The plain version: `modulated_deform_conv2d` in PyTorch operations,
    which autograd differentiates."""
    return _apply_weight(_deform_im2col_plain(x, offset, mask, stride),
                         weight, bias, x.shape[0], *offset.shape[-2:])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The sampling kernel's library, built on first use, with its C
    signature."""
    from fiber_torch.kernels import _build
    lib = _build.load("deform_im2col")
    lib.fiber_deform_im2col.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fiber_deform_im2col.restype = ctypes.c_int
    return lib


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """Launch the sampling kernel: the im2col matrix (B Ho Wo, 9 Cin) in
    x's dtype, row (b, ho, wo), column k Cin + c, equal to the plain
    version's (`_deform_im2col_plain`).  x (B, Cin, H, W) in fp32 or
    bf16 (read through one NHWC copy); offset (B, 18, Ho, Wo) and mask
    (B, 9, Ho, Wo) in fp32 or bf16, of any strides.  Raises on anything
    the kernel does not take, and where the launch fails.  Counts its
    launches in `modulated_deform_conv2d.launches`."""
    tensors = {"x": x, "offset": offset, "mask": mask}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"deform_im2col: x, offset and mask must be on "
                             f"one CUDA device, got {name} on {t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"deform_im2col: {name} dtype {t.dtype} not "
                            f"supported (float32 or bfloat16)")
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError("deform_im2col: x, offset and mask must be 4-d")
    B, Cin, H, W = x.shape
    Ho, Wo = offset.shape[-2:]
    if (tuple(offset.shape) != (B, 2 * _TAPS, Ho, Wo)
            or tuple(mask.shape) != (B, _TAPS, Ho, Wo)):
        raise ValueError(f"deform_im2col: offset must be {(B, 18, Ho, Wo)} "
                         f"and mask {(B, 9, Ho, Wo)}, got "
                         f"{tuple(offset.shape)} and {tuple(mask.shape)}")
    if H < 1 or W < 1 or stride < 1:
        raise ValueError(f"deform_im2col: needs a map of at least 1x1 and "
                         f"stride >= 1, got {H}x{W}, stride {stride}")
    xh = x.permute(0, 2, 3, 1).contiguous()
    cols = torch.empty((B * Ho * Wo, _TAPS * Cin), dtype=x.dtype,
                       device=x.device)
    if cols.numel() == 0:
        return cols
    with torch.cuda.device(x.device):
        err = _lib().fiber_deform_im2col(
            xh.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            cols.data_ptr(), B, Cin, H, W, Ho, Wo, stride, *offset.stride(),
            *mask.stride(), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[offset.dtype], _DTYPE_CODES[mask.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"deform_im2col kernel launch failed: CUDA error "
                           f"{err}")
    modulated_deform_conv2d.launches += 1
    return cols


def _modulated_deform_conv2d_cuda(x, offset, mask, weight, bias, stride):
    """The layer on the card: the sampling kernel, then the product."""
    B, Ho, Wo = x.shape[0], *offset.shape[-2:]
    if weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"modulated_deform_conv2d: weight must be (Cout, "
                         f"{x.shape[1]}, 3, 3), got {tuple(weight.shape)}")
    return _apply_weight(deform_im2col(x, offset, mask, stride), weight,
                         bias, B, Ho, Wo)


class _DeformConvFunction(torch.autograd.Function):
    """The kernel and the product forward; the backward recomputes the
    plain version (under the forward's autocast state) and returns its
    vector-Jacobian product.  Saves only the inputs."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset, mask, weight, bias, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, offset, mask, weight, bias)
        return _modulated_deform_conv2d_cuda(x, offset, mask, weight, bias,
                                             stride)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        need = ctx.needs_input_grad[:5]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = _modulated_deform_conv2d_plain(*inputs, stride=ctx.stride)
        wrt = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, dout))
        return (*(next(grads) if n else None for n in need), None)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1) -> torch.Tensor:
    """x (B, Cin, H, W); offset (B, 18, Ho, Wo); mask (B, 9, Ho, Wo) in
    [0, 1]; weight (Cout, Cin, 3, 3).  Returns (B, Cout, Ho, Wo) in x's
    dtype, Ho and Wo being the offsets' (ceil(H / stride) for a 3x3 conv
    with padding 1).  The plain version on a CPU tensor, the sampling
    kernel and a matmul on a CUDA one.

    `modulated_deform_conv2d.launches` counts the kernel's launches."""
    if not x.is_cuda:
        return _modulated_deform_conv2d_plain(x, offset, mask, weight, bias,
                                              stride)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        return _DeformConvFunction.apply(x, offset, mask, weight, bias, stride)
    return _modulated_deform_conv2d_cuda(x, offset, mask, weight, bias,
                                         stride)


modulated_deform_conv2d.launches = 0


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
