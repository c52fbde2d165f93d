"""The registry's backbones whose JAX side costs tens of seconds on the
CPU: R-101 (both names), EfficientNet-B7, and FIBER's fusion backbone at
FIBER-B width (its tree carried strictly and its levels against JAX's at
1e-4).  Marked slow; `test_torch_backbones.py` holds the rest."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import backbones as jbb
from fiber_torch.detection import backbones as tbb
from fiber_torch.utils.convert import backbone_params_from_flax
from test_torch_backbones import CASES, SLOW, check_name
from torch_zoo_parity import (abstract_params, assert_close, jax_apply,
                              random_params)

pytestmark = pytest.mark.slow
torch.set_num_threads(1)


@pytest.mark.parametrize("family,name", [c for c in CASES if c[0] in SLOW])
def test_backbone_matches_jax(family, name):
    check_name(family, name)


def test_fusion_backbone_matches_jax():
    name, img, out, T = "FUSION-SWINT-FPN-RETINANET", (64, 96), 32, 8
    jm, _ = jbb.build_backbone(name, img, out_channels=out)
    tm, _ = tbb.build_backbone(name, img, out_channels=out)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((1, *img, 3)).astype(np.float32)
    ids = rng.integers(4, 1000, (1, T)).astype(np.int32)
    mask = np.ones((1, T), np.int32)
    args = (jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
    flat = random_params(abstract_params(jm, *args), seed=2)
    tm.load_state_dict(backbone_params_from_flax(name, flat, tm),
                       strict=True)
    tm.eval()
    want, wlang = jax_apply(jm, flat, *args)
    with torch.no_grad():
        got, glang = tm(torch.from_numpy(images),
                        torch.from_numpy(ids).long(),
                        torch.from_numpy(mask).long())
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4, f"P{lvl + 3}")
    assert_close(glang["hidden"], wlang["hidden"], 1e-4, "hidden")
