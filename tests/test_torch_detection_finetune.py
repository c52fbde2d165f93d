"""Detection finetuning against `fiber_tpu` at tiny dims on the CPU: the
four optimizer groups' and every tuning mode's element counts equal to
JAX's (the names paired through `utils/convert.py`'s key map), one
frozen-mode update equal to JAX's masked optax chain on the same
gradients, `x_shot_subset` and `EarlyStopper` equal on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.detection.detector import GroundingDetector as JaxDetector
from fiber_tpu.train import detection_trainer as jtrain
from fiber_tpu.train import finetune as jft
from fiber_torch.detection.detector import GroundingDetector
from fiber_torch.train import detection_trainer as ttrain
from fiber_torch.train import finetune as tft
from fiber_torch.utils.convert import detection_params_from_flax
from torch_detection_parity import (configs, fill, flatten, to_flax_all,
                                    unflatten)

torch.set_num_threads(1)
HEADS = dict(mlm_loss=True, use_token_loss=True, use_contrastive_align=True,
             use_shallow_contrastive=True, add_linear_layer=True)


@pytest.fixture(scope="module")
def trees():
    """Per config: the JAX detector's abstract parameter tree (traced by
    `jax.eval_shape`, not compiled) and the port detector."""
    out = {}
    for name, kw in (("all_heads", HEADS), ("deform", dict(use_deform=True))):
        jcfg, tcfg = configs(**kw)
        H, W = jcfg.image_size
        T = jcfg.max_query_len
        abstract = jax.eval_shape(
            JaxDetector(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, H, W, 3)), jnp.ones((1, T), jnp.int32),
            jnp.ones((1, T), jnp.int32))["params"]
        out[name] = (abstract, GroundingDetector(tcfg, device="cpu",
                                                 for_training=True))
    return out


def jax_counts(labels, abstract):
    counts = {}
    for lab, leaf in zip(jax.tree_util.tree_leaves(labels),
                         jax.tree_util.tree_leaves(abstract)):
        counts[lab] = counts.get(lab, 0) + int(np.prod(leaf.shape))
    return counts


@pytest.mark.parametrize("config", ["all_heads", "deform"])
def test_optimizer_groups_match_jax(trees, config):
    abstract, model = trees[config]
    want = jax_counts(jax.tree_util.tree_map_with_path(
        jtrain._det_param_group, abstract), abstract)
    opt = ttrain.make_detection_optimizer(model, 1e-4, 2e-5, 1e-4)
    got = {g["name"]: sum(p.numel() for p in g["params"])
           for g in opt.param_groups}
    assert got == want
    assert set(got) == set(ttrain.DET_GROUPS)
    for g in opt.param_groups:
        assert g["base_lr"] == (2e-5 if g["name"].startswith("lang")
                                else 1e-4)
        assert g["weight_decay"] == (0.0 if g["name"].endswith("nodecay")
                                     else 1e-4)


@pytest.mark.parametrize("mode", tft.TUNING_MODES)
@pytest.mark.parametrize("config", ["all_heads", "deform"])
def test_tuning_mode_counts_match_jax(trees, config, mode):
    abstract, model = trees[config]
    want = jax_counts(jft.trainable_mask(abstract, mode), abstract)
    mask = tft.trainable_mask(model, mode)
    got = {}
    for name, p in model.named_parameters():
        got[mask[name]] = got.get(mask[name], 0) + p.numel()
    assert got == want
    assert tft.tuning_highlevel_override(mode) == \
        jft.tuning_highlevel_override(mode)


@pytest.mark.parametrize("mode", ["language_prompt_v2", "linear_prob"])
def test_frozen_update_matches_jax(mode, monkeypatch):
    """One step on seeded gradients (a loss whose gradient is them): the
    frozen parameters move by the decay only, the rest by AdamW after the
    global-norm clip, as JAX's `apply_tuning_mode` chain moves them."""
    _, tcfg = configs(add_linear_layer=True)
    # the first update runs at the warmup factor 0.001: lr 1e-3, wd 1e-1 a
    # step, as optax's schedule gives
    lr, wd = 1.0, 0.1
    tr = ttrain.DetectionTrainer(tcfg, device="cpu", base_lr=lr, lang_lr=lr,
                                 weight_decay=wd, ema_decay=None,
                                 clip_norm=1.0, warmup_iters=0)
    sd = fill(tr.model, 1)
    tr.model.load_state_dict(sd, strict=True)
    tft.apply_tuning_mode(tr, mode)
    rng = np.random.default_rng(2)
    g = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                             .astype(np.float32)) for k, v in sd.items()}
    named = dict(tr.model.named_parameters())

    def seeded_loss(model, batch, **kw):
        total = sum((named[k] * g[k]).sum() for k in g)
        return {"total_loss": total}

    monkeypatch.setattr(ttrain, "detection_loss", seeded_loss)
    tr.train_step({})
    params = unflatten(to_flax_all(sd, tcfg))
    grads = unflatten(to_flax_all(g, tcfg))
    tx = jft.apply_tuning_mode(jtrain.make_detection_optimizer(
        lr, lr, wd, 100, params, warmup_iters=0, clip_norm=1.0), params, mode)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = detection_params_from_flax(
        flatten(optax.apply_updates(params, updates)), tcfg)
    mask = tft.trainable_mask(tr.model, mode)
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
        if not mask[name]:
            d = (p.detach() - sd[name]).abs()
            assert bool((d <= 1e-3 * lr * wd * sd[name].abs() * 1.001
                         + 1e-9).all()), name
    assert any(mask.values()) and not all(mask.values())


def test_x_shot_subset_and_early_stopper_match_jax():
    rng = np.random.default_rng(3)
    labels = [list(rng.integers(1, 6, rng.integers(0, 4))) for _ in range(40)]
    for shots, seed in ((1, 0), (3, 1), (10, 2)):
        assert tft.x_shot_subset(labels, shots, np.random.default_rng(seed)) \
            == jft.x_shot_subset(labels, shots, np.random.default_rng(seed))
    values = [3.0, 2.5, 2.7, 2.6, 2.4, 2.9, 3.1, 2.8, 2.45, 2.5]
    for kw in (dict(patience=2, minimize=True), dict(patience=3)):
        a, b = tft.EarlyStopper(**kw), jft.EarlyStopper(**kw)
        for v in values:
            assert a.update(v) == b.update(v)
            assert a.best == b.best
