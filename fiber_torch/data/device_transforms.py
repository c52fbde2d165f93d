"""On-device image preprocessing: the geometric pipeline as torch ops.

The reference runs PIL transforms on CPU dataloader workers
(ref fiber/transforms/transform.py:10-45: eval = Resize((S,S), bicubic);
train = RandomResizedCrop(0.5-1.0) + HFlip + RandAugment(2, 7)).  PIL
bicubic at 384^2 on a few host cores cannot keep a GPU fed, so the host
only *decodes* to uint8 and pads into a fixed staging buffer, and
everything geometric runs on the device, batched:

  host:   decode -> uint8 (h, w, 3), pad into (S0, S0, 3) staging
          (nearest-downscale only if the native image exceeds S0)
  device: per-image bicubic resize / random-resized-crop as two batched
          contractions with dense (B, S0, out) weight matrices built from
          the crop boxes, horizontal flip, the geometric RandAugment subset
          (Shear/Translate/Rotate as one batched affine bilinear warp a
          round, a (B, 2, 3) matrix per image), then normalize.

The port's counterpart of `fiber_tpu/data/device_transforms.py`.  The
resize is JAX's `jax.image.scale_and_translate(method="cubic",
antialias=True)` algorithm, written out: the Keys cubic with a = -0.5,
the kernel widened by max(1/scale, 1) on downscale, samples at
(i + 0.5 - t) / s - 0.5, weights normalised by their column sum where that
sum exceeds 1000 eps32, and zeroed where the sample falls outside
[-0.5, in - 0.5].  (`F.interpolate`'s bicubic uses a = -0.75 and takes no
per-image crop box.)  Everything runs in fp32 on the device of the tensors
given, with no host sync; numpy inputs are placed on `device`, the card by
default, and a missing card raises.

The training draws (crop, flip, ops, magnitudes and signs) come from a
`torch.Generator` on the batch's device through `draw_train_params`;
`apply_train_preprocess` applies given draws, so that the draws of any
source (the JAX package's own, in the tests) can be fed to it.

Numerics against PIL: jax's and this "cubic" is the Keys kernel with
a=-0.5 — the same family as PIL BICUBIC — and the resampler antialiases on
downscale like PIL's, but tap windows differ slightly, so device-vs-PIL
pixels agree to ~1-2/255, not bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from fiber_torch.data.transforms import (IMAGENET_DEFAULT_MEAN,
                                         IMAGENET_DEFAULT_STD,
                                         normalize_on_device)
from fiber_torch.models.fiber import resolve_device

_EPS32 = float(np.finfo(np.float32).eps)
# pi / 180 as XLA folds (m * pi) / 180: pi in fp32 times the fp32 1 / 180
_DEG_TO_RAD = float(np.float32(math.pi) * np.float32(1 / 180))
# RandAugment's geometric subset: op index -> magnitude at level 10
# (ref randaug.py arg ranges: shear 0.3, translate 0.45 of the side,
# rotate 30 degrees; Identity first)
RANDAUG_OPS = ("identity", "shear_x", "shear_y", "translate_x",
               "translate_y", "rotate")
_RANDAUG_RANGE = (0.0, 0.3, 0.3, 0.45, 0.45, 30.0)


# ---------------------------------------------------------------------------
# host side: decode + stage
# ---------------------------------------------------------------------------
def stage_host(pil_img, staging_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL image or uint8 (h, w, 3) array -> (uint8 (S0, S0, 3) padded
    staging buffer, (h, w)).

    No filtering work on the host beyond a nearest-neighbor shrink when
    the native image exceeds the staging buffer (cheap: pure indexing).
    """
    img = pil_img.convert("RGB") if hasattr(pil_img, "convert") else pil_img
    arr = np.asarray(img, np.uint8)
    h, w = arr.shape[:2]
    if max(h, w) > staging_size:
        s = staging_size / max(h, w)
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        yi = np.linspace(0, h - 1, nh).round().astype(np.int64)
        xi = np.linspace(0, w - 1, nw).round().astype(np.int64)
        arr = arr[yi][:, xi]
        h, w = nh, nw
    out = np.zeros((staging_size, staging_size, 3), np.uint8)
    out[:h, :w] = arr
    # edge-replicate into the padding: resampling taps near the native
    # image edge (cubic + antialias support) read past (h, w); black
    # padding would bleed a dark fringe into edge pixels, replication
    # reproduces PIL's edge-clamp behavior
    out[h:, :w] = arr[h - 1][None, :]
    out[:, w:] = out[:, w - 1][:, None]
    return out, np.array([h, w], np.int32)


def stage_host_batch(pil_imgs, staging_size: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    staged, sizes = zip(*(stage_host(p, staging_size) for p in pil_imgs))
    return np.stack(staged), np.stack(sizes)


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------
def _tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to `device`."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to fp32, as a fused multiply-add: the product
    of two fp32 values is exact in fp64."""
    f64 = torch.float64
    b = b.to(f64) if torch.is_tensor(b) else b
    c = c.to(f64) if torch.is_tensor(c) else c
    return (a.to(f64) * b + c).to(torch.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5, at |offset| x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The bilinear (triangle) kernel at |offset| x >= 0."""
    return (1.0 - x).clamp_min(0.0)


def resize_weights(start: torch.Tensor, length: torch.Tensor, in_size: int,
                   out_size: int) -> torch.Tensor:
    """(B, in_size, out_size) fp32 weights that resample the span
    [start, start + length) of each image's axis to `out_size` samples:
    scale out / length, translation -start * out / length, antialiased,
    the Keys cubic kernel."""
    # a Python number over a tensor is the tensor's reciprocal times the
    # number in torch, rounded twice: divide tensors, as jnp does
    out = torch.full_like(length, out_size)
    scale = out / length                                   # (B,)
    translation = -start * out_size / length
    inv_scale = torch.ones_like(scale) / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    dev = start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    # (i + 0.5) * inv_scale - translation * inv_scale with one fused
    # multiply-add, as XLA computes the JAX package's positions
    sample = _fma(i[None], inv_scale[:, None],
                  -(translation * inv_scale)[:, None]) - 0.5  # (B, out)
    return _kernel_weights(sample, kernel_scale, in_size, _keys_cubic)


def static_resize_weights(in_size: int, out_size: int,
                          kernel=_triangle) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of `jax.image.resize` on the host
    (its scale a Python number, so its inverse in_size / out_size rounded
    once to fp32, no translation), antialiased; the triangle kernel is
    its "bilinear"."""
    inv_scale = torch.tensor([in_size / out_size], dtype=torch.float32)
    i = torch.arange(out_size, dtype=torch.float32) + 0.5
    sample = i[None] * inv_scale[:, None] - 0.5
    return _kernel_weights(sample, inv_scale.clamp_min(1.0), in_size,
                           kernel)[0]


def resize_axes(x: torch.Tensor, sizes: Dict[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` of a float tensor on its
    device: the axes of `sizes` ({axis: new size}) resampled one after
    another by `static_resize_weights`, an axis whose size stays left
    alone, as there."""
    for axis, n in sorted(sizes.items()):
        m = x.shape[axis]
        if m == n:
            continue
        w = static_resize_weights(m, n).to(x.device, x.dtype)       # (m, n)
        x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return x


def _kernel_weights(sample: torch.Tensor, kernel_scale: torch.Tensor,
                    in_size: int, kernel) -> torch.Tensor:
    """`scale_and_translate`'s weights at the sample positions (B, out):
    the kernel at |sample - source| / kernel_scale, normalised over the
    sources, zero where a sample lies outside the input."""
    src = torch.arange(in_size, dtype=torch.float32, device=sample.device)
    x = ((sample[:, None, :] - src[None, :, None]).abs()
         / kernel_scale[:, None, None])                    # (B, in, out)
    w = kernel(x)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def resize_crops(staged: torch.Tensor, crops: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Bicubic-resample the crop box [y0, x0, ch, cw] of each staged image
    (B, S0, S0, 3) to (B, out, out, 3) fp32 on the 0-255 scale."""
    img = staged.to(torch.float32)
    S0h, S0w = img.shape[1], img.shape[2]
    crops = crops.to(torch.float32)
    wy = resize_weights(crops[:, 0], crops[:, 2], S0h, out_size)
    wx = resize_weights(crops[:, 1], crops[:, 3], S0w, out_size)
    img = torch.einsum("bhwc,bho->bowc", img, wy)
    return torch.einsum("bowc,bwp->bopc", img, wx)


def affine_warp(imgs: torch.Tensor, mats: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Inverse-affine bilinear warp of (B, S, S, C), one matrix a image:
    output(y, x) = img(a y + b x + c, d y + e x + f), mats (B, 2, 3) =
    [[a, b, c], [d, e, f]]; taps outside the image read `fill`."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    m = mats.to(torch.float32)[:, :, :, None, None]        # (B, 2, 3, 1, 1)
    # a y + b x + c with a fused multiply-add for a y, as XLA computes it
    sy = _fma(m[:, 0, 0], ys, m[:, 0, 1] * xs) + m[:, 0, 2]  # (B, H, W)
    sx = _fma(m[:, 1, 0], ys, m[:, 1, 1] * xs) + m[:, 1, 2]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    flat = imgs.reshape(B, H * W, C)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1).long() * W
               + xx.clamp(0, W - 1).long()).reshape(B, H * W, 1)
        v = torch.gather(flat, 1, idx.expand(B, H * W, C)).reshape(
            B, H, W, C)
        return torch.where(ok[..., None], v, torch.full_like(v, fill))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def randaug_matrices(ops: torch.Tensor, magnitude: torch.Tensor,
                     size: int) -> torch.Tensor:
    """(B, 2, 3) warp matrices of one RandAugment round: op `ops[b]` (an
    index into RANDAUG_OPS) at `magnitude[b]` (shear factor, translation
    as a fraction of the side, or degrees) on an image of side `size`.
    Identity is the identity matrix, whose warp returns the image
    exactly (its weights are 0 and 1)."""
    m = magnitude.to(torch.float32)
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    c = (size - 1) / 2.0
    # the rotation's angle, sine, cosine and offsets rounded as XLA
    # computes the JAX package's: m * pi / 180 folded into one product,
    # sin and cos to the nearest fp32, the offsets by fused multiply-adds
    th = m * _DEG_TO_RAD
    cs = torch.cos(th.to(torch.float64)).to(torch.float32)
    sn = torch.sin(th.to(torch.float64)).to(torch.float32)
    off_y = _fma(-sn, c, _fma(-cs, c, c))                  # c - cs c - sn c
    off_x = _fma(-cs, c, _fma(sn, c, c))                   # c + sn c - cs c

    def mat(a, b, t0, d, e, t1):
        return torch.stack([torch.stack([a, b, t0], -1),
                            torch.stack([d, e, t1], -1)], -2)

    candidates = torch.stack([
        mat(one, zero, zero, zero, one, zero),                 # identity
        mat(one, zero, zero, m, one, zero),                    # shear x
        mat(one, m, zero, zero, one, zero),                    # shear y
        mat(one, zero, zero, zero, one, m * size),             # translate x
        mat(one, zero, m * size, zero, one, zero),             # translate y
        mat(cs, sn, off_y, -sn, cs, off_x),                    # rotate about
                                                               # the center
    ], dim=1)                                                  # (B, 6, 2, 3)
    return candidates[torch.arange(m.shape[0], device=m.device), ops.long()]


def device_eval_preprocess(staged, sizes, out_size: int,
                           mean=IMAGENET_DEFAULT_MEAN,
                           std=IMAGENET_DEFAULT_STD,
                           dtype: torch.dtype = torch.bfloat16,
                           device="cuda") -> torch.Tensor:
    """(B, S0, S0, 3) uint8 staging + (B, 2) native sizes ->
    (B, out, out, 3) normalized: the albef eval transform
    (Resize((S,S), bicubic) + normalize), on the staged tensor's device."""
    staged = _tensor(staged, device)
    sizes = _tensor(sizes, staged.device).to(torch.float32)
    crops = torch.cat([torch.zeros_like(sizes), sizes], dim=1)
    return normalize_on_device(resize_crops(staged, crops, out_size), mean,
                               std, dtype)


def draw_train_params(sizes, generator: torch.Generator, n_randaug: int = 2,
                      randaug_level: int = 7) -> Dict[str, torch.Tensor]:
    """The draws of `device_train_preprocess` for (B, 2) native sizes, on
    the generator's device: RandomResizedCrop(scale 0.5-1.0, ratio
    3/4-4/3) boxes "crops" (B, 4) = [y0, x0, ch, cw], horizontal "flip"
    (B,) bool, and per RandAugment round the op "ops" (n, B) and its signed
    magnitude "mags" (n, B).

    Crop sampling: one draw of (area, log-ratio), clamped to fit the
    native image — same distribution family as torchvision's rejection
    loop (which falls back to center crop after 10 failures); clamping
    replaces rejection so that nothing waits on the host."""
    dev = generator.device
    hw = _tensor(sizes, dev).to(torch.float32)
    B = hw.shape[0]

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    area = hw[:, 0] * hw[:, 1]
    target = (0.5 + 0.5 * uniform(B)) * area
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    ar = torch.exp(lo + (hi - lo) * uniform(B))
    cw = torch.minimum(torch.sqrt(target * ar), hw[:, 1])
    ch = torch.minimum(torch.sqrt(target / ar), hw[:, 0])
    u = uniform(B, 2)
    y0 = u[:, 0] * (hw[:, 0] - ch)
    x0 = u[:, 1] * (hw[:, 1] - cw)
    flip = uniform(B) < 0.5
    ops = torch.randint(0, len(RANDAUG_OPS), (n_randaug, B),
                        generator=generator, device=dev)
    sgn = torch.where(uniform(n_randaug, B) < 0.5, 1.0, -1.0)
    lvl = randaug_level / 10.0
    top = torch.tensor([r * lvl for r in _RANDAUG_RANGE],
                       dtype=torch.float32, device=dev)
    mags = top[ops] * uniform(n_randaug, B) * sgn
    return {"crops": torch.stack([y0, x0, ch, cw], dim=1), "flip": flip,
            "ops": ops, "mags": mags}


def apply_train_preprocess(staged, draws: Dict[str, torch.Tensor],
                           out_size: int, mean=IMAGENET_DEFAULT_MEAN,
                           std=IMAGENET_DEFAULT_STD,
                           dtype: torch.dtype = torch.bfloat16,
                           device="cuda") -> torch.Tensor:
    """Crop-resize, flip, the RandAugment rounds and normalize, with the
    draws given (`draw_train_params`'s keys), on the staged tensor's
    device."""
    staged = _tensor(staged, device)
    d = {k: _tensor(v, staged.device) for k, v in draws.items()}
    imgs = resize_crops(staged, d["crops"], out_size)
    imgs = torch.where(d["flip"][:, None, None, None], imgs.flip(2), imgs)
    for ops, mags in zip(d["ops"], d["mags"]):
        imgs = affine_warp(imgs, randaug_matrices(ops, mags, out_size))
    return normalize_on_device(imgs, mean, std, dtype)


def device_train_preprocess(staged, sizes, generator: torch.Generator,
                            out_size: int, mean=IMAGENET_DEFAULT_MEAN,
                            std=IMAGENET_DEFAULT_STD,
                            dtype: torch.dtype = torch.bfloat16,
                            n_randaug: int = 2,
                            randaug_level: int = 7) -> torch.Tensor:
    """RandomResizedCrop(scale 0.5-1.0, ratio 3/4-4/3) + HFlip + the
    geometric RandAugment subset + normalize, batched on the generator's
    device: `apply_train_preprocess` of `draw_train_params`."""
    draws = draw_train_params(sizes, generator, n_randaug, randaug_level)
    return apply_train_preprocess(staged, draws, out_size, mean, std, dtype,
                                  device=generator.device)
