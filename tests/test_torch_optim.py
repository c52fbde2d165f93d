"""Optimizer groups, learning-rate schedule and AdamW update: the port
against `fiber_tpu.train.optim` (optax) at tiny dims on the CPU."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_tpu.train import optim as joptim
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.train import optim as toptim
from fiber_torch.utils.convert import _port_key, params_from_flax
from torch_parity import LOSSES, flatten, unflatten

torch.set_num_threads(1)


def _flax_shapes(cfg_kw):
    """flax path -> shape of every parameter of the tiny JAX model with
    every head (traced, not computed)."""
    jcfg = JaxFiberConfig.tiny_test(loss_names=LOSSES, **cfg_kw)
    S, L = jcfg.image_size, jcfg.max_text_len
    shapes = jax.eval_shape(lambda: JaxFiberCoarse(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, S, S, 3)),
        jnp.ones((1, L), jnp.int32), jnp.ones((1, L), jnp.int32),
        method=JaxFiberCoarse.init_full))
    flat = flax.traverse_util.flatten_dict(shapes["params"], sep="/")
    return jcfg, {k: v.shape for k, v in flat.items()}


def _keys(path: str):
    return tuple(type("K", (), {"key": p})() for p in path.split("/"))


def test_param_groups_match_jax():
    """Every parameter lands in the group JAX gives its flax path, and
    every port parameter is covered."""
    _, shapes = _flax_shapes({})
    model = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES),
                        device="cpu", for_training=True)
    names = {n for n, _ in model.named_parameters()}
    seen = set()
    for path in shapes:
        name = _port_key(path, np.zeros(shapes[path]))[0]
        assert toptim.param_group(name) == joptim.param_group(
            _keys(path), None), (path, name)
        seen.add(name)
    assert seen == names
    counts = toptim.summarize_groups(model)
    assert set(counts) == set(toptim.GROUPS)
    assert sum(counts.values()) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("decay_power", [1, 2, "cosine"])
@pytest.mark.parametrize("warmup", [0, 7, 0.25])
def test_lr_schedule_matches_optax(decay_power, warmup):
    kw = dict(warmup_steps=warmup, decay_power=decay_power, max_steps=40,
              end_lr=1e-6)
    jcfg = JaxFiberConfig.tiny_test(**kw)
    cfg = FiberConfig.tiny_test(**kw)
    base = 3e-4
    sched = joptim.make_lr_schedule(jcfg, base)
    # optax evaluates in float32: agree to float32 rounding at lr's scale
    for count in range(45):
        np.testing.assert_allclose(toptim.lr_at(cfg, base, count),
                                   float(sched(count)), rtol=1e-6,
                                   atol=1e-6 * base, err_msg=f"step {count}")


def test_adamw_steps_match_optax():
    """Two updates on seeded parameters and seeded grads: the six groups'
    lr multipliers, weight decay, moments and bias corrections."""
    kw = dict(warmup_steps=0, learning_rate=1e-2, max_steps=4, end_lr=1e-3)
    jcfg, shapes = _flax_shapes(kw)
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(shapes.items())}
    params = unflatten(flat)
    tx = joptim.make_optimizer(jcfg, params)
    opt_state = tx.init(params)

    model = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES, **kw),
                        device="cpu", for_training=True)
    model.load_state_dict(params_from_flax(flat, model))
    opt = toptim.make_optimizer(model.cfg, model)
    named = dict(model.named_parameters())
    for count in range(2):
        gflat = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in sorted(shapes.items())}
        updates, opt_state = tx.update(unflatten(gflat), opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, g in params_from_flax(gflat).items():
            named[k].grad = g
        toptim.set_lr(opt, model.cfg, count)
        opt.step()
        want = params_from_flax(flatten(params))
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-6, err_msg=f"{k} step {count}")
