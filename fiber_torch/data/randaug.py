"""RandAugment for training transforms (ref fiber/transforms/randaug.py,
used by albef_transform_randaug with N=2, M=7).

PIL-based host-side implementation of the standard op set minus the
color-destructive ops the reference also excludes for VL training
(Invert/Cutout kept mild).

The port's copy of `fiber_tpu/data/randaug.py`: the same ops and the same
draws from the same `np.random.Generator`, with PIL imported inside the
ops, so that importing the module needs no PIL.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MAX_LEVEL = 10


def _sign(rng) -> int:
    return 1 if rng.random() < 0.5 else -1


def _op_identity(img, level, rng):
    return img


def _op_auto_contrast(img, level, rng):
    from PIL import ImageOps
    return ImageOps.autocontrast(img)


def _op_equalize(img, level, rng):
    from PIL import ImageOps
    return ImageOps.equalize(img)


def _op_rotate(img, level, rng):
    deg = 30 * level / MAX_LEVEL * _sign(rng)
    return img.rotate(deg, fillcolor=(128, 128, 128))


def _op_posterize(img, level, rng):
    from PIL import ImageOps
    bits = 8 - int(4 * level / MAX_LEVEL)
    return ImageOps.posterize(img, max(bits, 4))


def _op_solarize(img, level, rng):
    from PIL import ImageOps
    thr = 256 - int(110 * level / MAX_LEVEL)
    return ImageOps.solarize(img, thr)


def _enhance(name):
    def apply(img, level, rng):
        from PIL import ImageEnhance
        return getattr(ImageEnhance, name)(img).enhance(
            1 + 0.9 * level / MAX_LEVEL * _sign(rng))
    return apply


_op_color = _enhance("Color")
_op_contrast = _enhance("Contrast")
_op_brightness = _enhance("Brightness")
_op_sharpness = _enhance("Sharpness")


def _affine(img, coeffs):
    from PIL import Image
    return img.transform(img.size, Image.AFFINE, coeffs,
                         fillcolor=(128, 128, 128))


def _op_shear_x(img, level, rng):
    v = 0.3 * level / MAX_LEVEL * _sign(rng)
    return _affine(img, (1, v, 0, 0, 1, 0))


def _op_shear_y(img, level, rng):
    v = 0.3 * level / MAX_LEVEL * _sign(rng)
    return _affine(img, (1, 0, 0, v, 1, 0))


def _op_translate_x(img, level, rng):
    v = 0.3 * level / MAX_LEVEL * img.size[0] * _sign(rng)
    return _affine(img, (1, 0, v, 0, 1, 0))


def _op_translate_y(img, level, rng):
    v = 0.3 * level / MAX_LEVEL * img.size[1] * _sign(rng)
    return _affine(img, (1, 0, 0, 0, 1, v))


OPS = [_op_identity, _op_auto_contrast, _op_equalize, _op_rotate,
       _op_posterize, _op_solarize, _op_color, _op_contrast,
       _op_brightness, _op_sharpness, _op_shear_x, _op_shear_y,
       _op_translate_x, _op_translate_y]


def rand_augment(img, n: int = 2, m: int = 7,
                 rng: Optional[np.random.Generator] = None):
    """`n` ops drawn from OPS, each at level `m`, applied to a PIL image."""
    rng = rng or np.random.default_rng()
    for _ in range(n):
        op = OPS[rng.integers(len(OPS))]
        img = op(img, m, rng)
    return img
