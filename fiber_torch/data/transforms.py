"""Image preprocessing: host-side decode/resize, device-side normalize.

The reference uses torchvision "albef" transforms on CPU workers
(ref: fiber/transforms/transform.py:10-45): train = RandomResizedCrop +
HFlip + RandAugment(2, 7); eval = Resize(square) + normalize with the
torchvision ImageNet mean/std (transform.py:15).  Here decode and the
geometric ops of this path stay on the host (PIL), and the normalize runs
on the device as torch ops, so that uint8 images cross PCIe (4x less
traffic than fp32).  `data/device_transforms.py` moves the geometric ops
to the device too.

The port's counterpart of `fiber_tpu/data/transforms.py`; PIL is imported
inside `resize_image`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# The reference albef transforms normalize with the torchvision ImageNet
# defaults (ref transform.py:15,43), NOT the 0.5 inception constants.
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
# aliases kept for back-compat with earlier imports
IMAGENET_INCEPTION_MEAN = IMAGENET_DEFAULT_MEAN
IMAGENET_INCEPTION_STD = IMAGENET_DEFAULT_STD


def normalize_on_device(img_u8: torch.Tensor, mean=IMAGENET_INCEPTION_MEAN,
                        std=IMAGENET_INCEPTION_STD,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 (or 0-255 float) NHWC -> normalized NHWC in `dtype`, on the
    tensor's device."""
    x = img_u8.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def resize_image(pil_img, size: int, train: bool = False,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Host-side decode path -> (size, size, 3) uint8.

    Eval: square resize (matches ref albef_transform's Resize((size,size))).
    Train: RandomResizedCrop(scale 0.5-1.0) + horizontal flip.
    """
    from PIL import Image
    img = pil_img.convert("RGB")
    if train:
        rng = rng or np.random.default_rng()
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = rng.uniform(0.5, 1.0) * area
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x0 = rng.integers(0, w - cw + 1)
                y0 = rng.integers(0, h - ch + 1)
                img = img.crop((x0, y0, x0 + cw, y0 + ch))
                break
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)
