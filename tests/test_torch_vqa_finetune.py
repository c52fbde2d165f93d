"""The VQA finetuning step (`task_finetune_vqa`'s loss and optimizer
groups) of the port against `fiber_tpu`'s, at tiny dims on the CPU in
fp32: one `CoarseTrainer.train_step` on the same parameters and batch
against the JAX trainer's `loss_fn` grads (`pretrain_losses` with the VQA
loss alone) and its optax update.  At 576^2 the same step runs every Swin
block at FIBER's 18 x 18 windows (N = 324) through K1 and K2 on the card
(`chip_smoke.py`'s vqa_576_train, and the `cuda` case of
tests/test_torch_kernels.py at window 18)."""

import jax
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.train.trainer import CoarseTrainer as JaxCoarseTrainer
from fiber_torch.config import FiberConfig
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.convert import params_from_flax
from torch_parity import (flatten, jax_batch, load_params, perturb,
                          pretrain_batch, to_np, unflatten)

torch.set_num_threads(1)
ATOL = 1e-4
# the VQA preset's optimizer groups; warmup 0 so that the first update moves
# the parameters
KW = dict(loss_names=("vqa",), warmup_steps=0, learning_rate=1e-4,
          lr_mult_head=50.0, lr_mult_cross_modal=5.0)


def _vqa_batch(cfg, B, seed):
    batch = pretrain_batch(cfg, B, seed)
    rng = np.random.default_rng(seed + 7)
    batch["vqa_targets"] = np.where(
        rng.random((B, cfg.vqav2_label_size)) < 0.3,
        rng.random((B, cfg.vqav2_label_size)), 0.0).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def parity():
    jtr = JaxCoarseTrainer(JaxFiberConfig.tiny_test(**KW))
    state = jtr.init_state(jax.random.PRNGKey(0))
    assert state.queue is None                    # no ITC, no queue
    flat = perturb(flatten(state.params), 0)
    params = unflatten(flat)
    state = state.replace(params=params, opt_state=jtr._tx.init(params))
    ttr = CoarseTrainer(FiberConfig.tiny_test(**KW), device="cpu", seed=0)
    load_params(ttr, flat)
    batch = _vqa_batch(ttr.cfg, 3, seed=1)
    grad_fn = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                      static_argnums=4)
    (loss, (metrics, _)), grads = grad_fn(state.params, jax_batch(batch),
                                          None, jax.random.PRNGKey(2), True)
    updates, _ = jtr._tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    tmetrics = ttr.train_step(batch)
    return dict(loss=loss, metrics=metrics, grads=grads, params=new_params,
                ttr=ttr, tmetrics=tmetrics)


def test_vqa_step_losses_match_jax(parity):
    assert set(parity["metrics"]) == {"vqa_loss", "vqa_score"}
    np.testing.assert_allclose(to_np(parity["tmetrics"]["total_loss"]),
                               to_np(parity["loss"]), atol=ATOL)
    for k, v in parity["metrics"].items():
        np.testing.assert_allclose(to_np(parity["tmetrics"][k]), to_np(v),
                                   atol=ATOL, err_msg=k)


def test_vqa_step_grads_match_jax(parity):
    """Every parameter's gradient, the Swin blocks' window attention (qkv
    and the relative position bias tables, through the op's backward)
    among them; zero where the VQA loss does not reach, as in JAX."""
    want = params_from_flax(flatten(parity["grads"]))
    got = {n: p.grad for n, p in parity["ttr"].model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(), atol=ATOL,
                                   err_msg=k)
    rpb = [k for k in want if k.endswith("relative_position_bias_table")]
    assert rpb and all(np.abs(want[k].numpy()).max() > 0 for k in rpb)


def test_vqa_step_params_match_jax(parity):
    want = params_from_flax(flatten(parity["params"]))
    for k, p in parity["ttr"].model.named_parameters():
        np.testing.assert_allclose(to_np(p), want[k].numpy(), atol=ATOL,
                                   err_msg=k)
    assert parity["ttr"].step == 1 and parity["ttr"].queue is None
