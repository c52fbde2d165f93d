"""From-scratch initialisation: the port's `FiberCoarse` draws every
parameter from the same distribution as `fiber_tpu`'s, each package from its
own seed, at tiny dims on the CPU.  Parameters are paired by
`utils/convert.py`'s names; a distribution is held by its std and mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.utils.convert import params_from_flax
from torch_parity import LOSSES, flatten

torch.set_num_threads(1)
# a wider patch embed than tiny_test's 16, so that its conv has 3072
# weights and its std is measured to a few percent
EMBED = 64
MIN_SIZE = 1024
STD_RTOL = 0.10
PATCH = "vit_model.patch_embed.proj.weight"


@pytest.fixture(scope="module")
def both():
    """{name: (JAX's draw, the port's draw)} as numpy, port names."""
    kw = dict(loss_names=LOSSES, swin_embed_dim=EMBED)
    jcfg = JaxFiberConfig.tiny_test(**kw)
    S, L = jcfg.image_size, jcfg.max_text_len
    variables = JaxFiberCoarse(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, S, S, 3)),
        jnp.full((1, L), 3, jnp.int32), jnp.ones((1, L), jnp.int32),
        method=JaxFiberCoarse.init_full)
    model = FiberCoarse(FiberConfig.tiny_test(**kw), device="cpu", seed=0)
    jax_sd = params_from_flax(flatten(variables["params"]), model)
    port_sd = model.state_dict()
    assert set(jax_sd) == set(port_sd)
    return {k: (np.asarray(jax_sd[k], np.float64),
                port_sd[k].double().numpy()) for k in port_sd}


def test_patch_embed_std_is_lecun_normal(both):
    """flax's `nn.Conv` default, lecun_normal: std 1/sqrt(fan_in), fan_in
    = 3 * 4 * 4."""
    want = 1.0 / np.sqrt(48.0)
    j, t = both[PATCH]
    assert t.size >= MIN_SIZE
    assert abs(j.std() - want) <= STD_RTOL * want, j.std()
    assert abs(t.std() - want) <= STD_RTOL * want, t.std()
    # cut at two of the untruncated std, as flax's truncated normal is
    assert np.abs(t).max() <= 2 * want / 0.87962566103423978 + 1e-7


def test_large_parameters_share_std_and_mean(both):
    checked = []
    for name, (j, t) in sorted(both.items()):
        if t.size < MIN_SIZE:
            continue
        checked.append(name)
        if j.std() == 0:
            np.testing.assert_array_equal(t, j, err_msg=name)
            continue
        assert abs(t.std() - j.std()) <= STD_RTOL * j.std(), \
            (name, j.std(), t.std())
        # four standard errors of the difference of two sample means
        sem = np.sqrt((j.var() + t.var()) / t.size)
        assert abs(t.mean() - j.mean()) <= 4 * sem, (name, j.mean(),
                                                     t.mean())
    assert PATCH in checked and len(checked) > 20


def test_constant_parameters_are_equal(both):
    """Zero biases, unit LayerNorm scales, zero gates: the same constants."""
    constant = [n for n, (j, _) in both.items() if j.size and j.std() == 0]
    assert any(n.endswith(".bias") for n in constant)
    assert any("norm" in n and n.endswith(".weight") for n in constant)
    for name in constant:
        np.testing.assert_array_equal(both[name][1], both[name][0],
                                      err_msg=name)
