"""The port's parameter names are the reference checkpoint's: its
state_dict goes through the JAX package's checkpoint converter
(`convert_fiber_state_dict(strict=True)`) and gives back the
`FiberCoarse.init_full` tree, and `params_from_flax` is that converter's
inverse."""

import numpy as np
import pytest
import torch

from fiber_tpu.utils.checkpoint_convert import convert_fiber_state_dict
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.utils.convert import params_from_flax
from torch_parity import LOSSES, build_models, flatten

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    _, _, tm, flat = build_models(seed=0)
    return tm, flat


def _convert(state_dict):
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params, unmapped = convert_fiber_state_dict(sd, strict=True)
    assert unmapped == []
    return flatten(params)


def test_round_trip_is_identity(models):
    """flax tree -> params_from_flax -> port -> state_dict -> converter
    gives back the same tree, key for key and value for value."""
    tm, flat = models
    back = _convert(tm.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_seeded_port_converts_to_init_full_shapes(models):
    """A port model drawn from its own seed converts strictly, into the
    shapes of the JAX init_full tree."""
    _, flat = models
    fresh = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES),
                        device="cpu", seed=1)
    back = _convert(fresh.state_dict())
    assert {k: v.shape for k, v in back.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_state_dict_holds_parameters_only(models):
    tm, _ = models
    assert set(tm.state_dict()) == {n for n, _ in tm.named_parameters()}


def test_params_from_flax_rejects_unknown_path(models):
    tm, flat = models
    bad = dict(flat)
    bad["vit_model/layers_0/blocks_0/attn/extra/kernel"] = np.zeros((2, 2))
    with pytest.raises(ValueError, match="no place"):
        params_from_flax(bad, tm)


def test_params_from_flax_rejects_unset_parameter(models):
    tm, flat = models
    bad = {k: v for k, v in flat.items() if not k.endswith("alpha_i2t")}
    with pytest.raises(ValueError, match="unset"):
        params_from_flax(bad, tm)


def test_params_from_flax_layouts(models):
    """Dense kernels are transposed, conv kernels go HWIO -> OIHW, gates
    keep their (1,) shape."""
    _, flat = models
    sd = params_from_flax(flat)
    k = "vit_model/layers_0/blocks_0/attn/qkv/kernel"
    np.testing.assert_array_equal(
        sd["vit_model.layers.0.blocks.0.attn.qkv.weight"].numpy(), flat[k].T)
    np.testing.assert_array_equal(
        sd["vit_model.patch_embed.proj.weight"].numpy(),
        flat["vit_model/patch_embed/proj/kernel"].transpose(3, 2, 0, 1))
    assert sd["text_transformer.encoder.layer.11.alpha_t2i"].shape == (1,)
    assert sd["temp"].shape == ()
