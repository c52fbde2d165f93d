"""The detection backbone registry against `fiber_tpu` on the CPU, fp32:
every `BACKBONES` name through `build_backbone`: five levels of the
output width, the `language_aware` flag, the parameter tree (JAX's own, by
`jax.eval_shape`, carried to the port by `utils/convert.py::
backbone_params_from_flax` with strict names and shapes) and the levels
within 1e-4 of JAX's (of each level's max-abs, at least 1); the
unknown-name error.

Each family's JAX forward runs once, on its first name; a name that
shares the family (the -RETINANET twins) loads the same parameters and is
held to the same JAX levels.  Sizes: 64 x 96 and 32 channels (those of
`tests/test_backbone_registry.py`), but 128 x 192 and 64 channels for the
EfficientNet-BiFPN: its GroupNorms take gcd(32, C) groups, and at 32
channels the 1 x 2 level leaves two values a group, which normalise to
+-1 and lift fp32 rounding to 1e-2 (both packages alike).  R-101,
EfficientNet-B7 and the fusion backbone's JAX side run in the slow
`test_torch_backbones_slow.py`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import backbones as jbb
from fiber_torch.detection import backbones as tbb
from fiber_torch.detection.fusion_backbone import FusionSwinFPN
from fiber_torch.utils.convert import backbone_params_from_flax
from torch_zoo_parity import (abstract_params, assert_close, jax_apply,
                              random_params, text)

torch.set_num_threads(1)
B, LT = 2, 8
# each family's names, the first the one JAX runs
FAMILIES = {
    "resnet50": ["R-50-FPN", "R-50-FPN-RETINANET"],
    "resnet101": ["R-101-FPN", "R-101-FPN-RETINANET"],
    "swint": ["SWINT-FPN", "SWINT-FPN-RETINANET"],
    "swint_vl": ["SWINT-VL-FPN-RETINANET"],
    "swint_v2": ["SWINT-V2-FPN-RETINANET"],
    "swint_v2_vl": ["SWINT-V2-VL-FPN-RETINANET"],
    "effnet_b0": ["EFFICIENTNET-BIFPN"],
    "effnet_b7": ["EFFICIENTNET-B7-BIFPN"],
    "fbnet": ["FBNET-FPN-RETINANET"],
    "fbnet_c": ["FBNET-C-FPN-RETINANET"],
}
SLOW = ("resnet101", "effnet_b7")
CASES = [(b, n) for b, names in FAMILIES.items() for n in names]


def size_of(family):
    return ((128, 192), 64) if family.startswith("effnet") else ((64, 96), 32)


def _inputs(lang_aware, img, seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, *img, 3)).astype(np.float32)
    if not lang_aware:
        return (images,)
    t, mask = text(B, LT, 768, seed + 1)
    return images, t, mask


@functools.lru_cache(maxsize=None)
def jax_side(family):
    """(flat parameters, inputs, JAX levels, JAX language dict, flag) of
    the family's first name."""
    name = FAMILIES[family][0]
    img, out = size_of(family)
    jm, lang_aware = jbb.build_backbone(name, img, out_channels=out)
    args = _inputs(lang_aware, img, seed=len(name))
    jargs = [jnp.asarray(a) for a in args]
    flat = random_params(abstract_params(jm, *jargs), seed=1)
    want = jax_apply(jm, flat, *jargs)
    lang = None
    if lang_aware:
        want, lang = want
    return flat, args, [np.asarray(w) for w in want], lang, lang_aware


def check_name(family, name):
    flat, args, want, wlang, lang_aware = jax_side(family)
    img, out = size_of(family)
    tm, tlang = tbb.build_backbone(name, img, out_channels=out)
    assert tlang == lang_aware
    tm.load_state_dict(backbone_params_from_flax(name, flat, tm),
                       strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in args])
    if tlang:
        got, glang = got
        assert_close(glang["hidden"], wlang["hidden"], 1e-4, "lang")
    assert len(got) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == out
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4, f"{name} P{lvl + 3}")


@pytest.mark.parametrize("family,name",
                         [c for c in CASES if c[0] not in SLOW])
def test_backbone_matches_jax(family, name):
    check_name(family, name)


def test_registry_names_match_jax():
    assert set(tbb.BACKBONES) == set(jbb.BACKBONES)
    assert len(tbb.BACKBONES) == 14
    assert {n for _, n in CASES} | {"FUSION-SWINT-FPN-RETINANET"} == \
        set(jbb.BACKBONES)


def test_unknown_backbone_raises():
    with pytest.raises(KeyError, match="unknown backbone"):
        tbb.build_backbone("NOPE", (64, 96))


def test_fusion_backbone_entry():
    """FIBER's own: the port's `FusionSwinFPN`, language-aware, as JAX's
    entry is."""
    tm, tlang = tbb.build_backbone("FUSION-SWINT-FPN-RETINANET", (64, 96),
                                   out_channels=32)
    _, jlang = jbb.build_backbone("FUSION-SWINT-FPN-RETINANET", (64, 96),
                                  out_channels=32)
    assert tlang and jlang and isinstance(tm, FusionSwinFPN)
