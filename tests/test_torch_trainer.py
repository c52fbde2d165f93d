"""CoarseTrainer: one train step of the port against `fiber_tpu`'s on the
same parameters, queue, batch and negatives, and the trainer's own
contracts (NaN guard, accumulation, chained steps, remat with dropout,
EMA, state round trip), at tiny dims on the CPU, fp32."""

import jax
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.objectives import coarse as jobj
from fiber_torch.config import FiberConfig
from fiber_torch.objectives import coarse as tobj
from fiber_torch.train.optim import lr_at
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.convert import params_from_flax
from torch_parity import (PRETRAIN, build_trainers, flatten, jax_batch,
                          match_rows, pretrain_batch, to_np)

torch.set_num_threads(1)
ATOL = 1e-4
# warmup 0 so that the first update moves the parameters (optax's lr at
# count 0 is 0 during warmup)
KW = dict(warmup_steps=0, learning_rate=1e-4)


def _cfg(**kw):
    return FiberConfig.tiny_test(loss_names=PRETRAIN, **{**KW, **kw})


def _params(trainer):
    return {n: p.detach().clone() for n, p in
            trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def parity():
    """One JAX step (grads of its loss_fn, then its optax update) and one
    port train_step, with the port's mining handed JAX's negatives."""
    jtr, state, ttr, _ = build_trainers(seed=0, **KW)
    batch = pretrain_batch(ttr.cfg, 3, seed=1)
    jb = jax_batch(batch)
    rng = jax.random.PRNGKey(2)
    grad_fn = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                      static_argnums=4)
    (loss, (metrics, _)), grads = grad_fn(state.params, jb, state.queue, rng,
                                          True)
    updates, _ = jtr._tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    # the draws of loss_fn -> pretrain_losses -> compute_itc
    rest, drop = jax.random.split(rng)
    _, sub = jax.random.split(rest)
    _, _, neg = jobj.compute_itc(jtr.model, {"params": state.params}, jb,
                                 state.queue, sub, rngs={"dropout": drop})
    drawn = iter([match_rows(np.asarray(neg["image_neg"]), batch["image"]),
                  match_rows(np.asarray(neg["text_neg"]), batch["text_ids"])])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tobj, "mine_hard_negatives",
                   lambda sim, valid, gen: torch.from_numpy(next(drawn)))
        tmetrics = ttr.train_step(batch)
    return dict(loss=loss, metrics=metrics, grads=grads, params=new_params,
                ttr=ttr, tmetrics=tmetrics)


def test_train_step_losses_match_jax(parity):
    np.testing.assert_allclose(to_np(parity["tmetrics"]["total_loss"]),
                               to_np(parity["loss"]), atol=ATOL)
    for k, v in parity["metrics"].items():
        np.testing.assert_allclose(to_np(parity["tmetrics"][k]), to_np(v),
                                   atol=ATOL, err_msg=k)


def test_train_step_grads_match_jax(parity):
    want = params_from_flax(flatten(parity["grads"]))
    got = {n: p.grad for n, p in parity["ttr"].model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(), atol=ATOL,
                                   err_msg=k)


def test_train_step_params_match_jax(parity):
    want = params_from_flax(flatten(parity["params"]))
    for k, p in parity["ttr"].model.named_parameters():
        np.testing.assert_allclose(to_np(p), want[k].numpy(), atol=ATOL,
                                   err_msg=k)
    assert parity["ttr"].step == 1
    assert int(parity["ttr"].queue.total) == 3


def test_nan_guard_zeroes_grads_and_still_steps():
    """A non-finite loss: every grad zeroed, and AdamW still applies its
    weight decay (the moments are zero, so nothing else moves)."""
    tr = CoarseTrainer(_cfg(), device="cpu", seed=0)
    before = _params(tr)
    batch = pretrain_batch(tr.cfg, 2, seed=3)
    batch["image"][0, 0, 0, 0] = np.nan
    m = tr.train_step(batch)
    assert not torch.isfinite(m["total_loss"])
    for p in tr.params:
        assert torch.count_nonzero(p.grad) == 0
    for group in tr.optimizer.param_groups:
        shrink = 1.0 - lr_at(tr.cfg, group["base_lr"], 0) * group["weight_decay"]
        for p in group["params"]:
            name = next(n for n, q in tr.model.named_parameters() if q is p)
            torch.testing.assert_close(p.detach(), before[name] * shrink,
                                       rtol=1e-6, atol=0)


def test_train_step_accum_equals_mean_of_microbatches():
    micros = [pretrain_batch(_cfg(), 2, seed=s) for s in (10, 11, 12)]
    a = CoarseTrainer(_cfg(), device="cpu", seed=0)
    ma = a.train_step_accum(micros, torch.Generator().manual_seed(5))

    b = CoarseTrainer(_cfg(), device="cpu", seed=0)
    gen = torch.Generator().manual_seed(5)
    gsum, losses = None, []
    for m in micros:
        losses.append(b._grads(m, gen)["total_loss"])
        g = [p.grad.clone() for p in b.params]
        gsum = g if gsum is None else [x + y for x, y in zip(gsum, g)]
    for p, g in zip(b.params, gsum):
        p.grad.copy_(g / len(micros))
    b._update()
    torch.testing.assert_close(ma["total_loss"], torch.stack(losses).mean(),
                               rtol=1e-6, atol=0)
    pb = _params(b)
    for k, v in _params(a).items():
        torch.testing.assert_close(v, pb[k], rtol=0, atol=1e-6)
    assert int(a.queue.total) == 6 and a.step == 1


def test_train_steps_equals_sequential_steps():
    batches = [pretrain_batch(_cfg(), 2, seed=s) for s in (20, 21, 22)]
    a = CoarseTrainer(_cfg(), device="cpu", seed=0)
    la = a.train_steps(batches, torch.Generator().manual_seed(7))
    b = CoarseTrainer(_cfg(), device="cpu", seed=0)
    gen = torch.Generator().manual_seed(7)
    lb = torch.stack([b.train_step(x, gen)["total_loss"] for x in batches])
    assert la.shape == (3,) and torch.isfinite(la).all()
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    pb = _params(b)
    for k, v in _params(a).items():
        torch.testing.assert_close(v, pb[k], rtol=0, atol=0)
    assert a.step == b.step == 3


def test_remat_equals_no_remat_with_dropout():
    """Checkpointed Swin blocks replay the forward's dropout and drop-path
    masks in the recompute: the same loss and grads as without remat."""
    kw = dict(drop_rate=0.1, swin_drop_path_rate=0.1)
    batch = pretrain_batch(_cfg(), 2, seed=30)
    plain = CoarseTrainer(_cfg(remat=False, **kw), device="cpu", seed=0)
    remat = CoarseTrainer(_cfg(remat=True, **kw), device="cpu", seed=0)
    eval_loss = plain.eval_step(batch, torch.Generator())["total_loss"]
    mp, mr = plain.train_step(batch), remat.train_step(batch)
    assert not torch.equal(mp["total_loss"], eval_loss)   # dropout is on
    torch.testing.assert_close(mr["total_loss"], mp["total_loss"],
                               rtol=0, atol=1e-6)
    named = dict(remat.model.named_parameters())
    for n, p in plain.model.named_parameters():
        torch.testing.assert_close(named[n].grad, p.grad, rtol=0, atol=1e-6)


def test_three_steps_on_one_batch_descend():
    """As tests/test_trainer.py::test_train_step_runs_and_descends."""
    tr = CoarseTrainer(_cfg(), device="cpu", seed=0)
    batch = pretrain_batch(tr.cfg, 8, seed=40)
    losses = [float(tr.train_step(batch)["total_loss"]) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert tr.step == 3
    assert int(tr.queue.total) == 24


def test_ema_follows_the_parameters():
    tr = CoarseTrainer(_cfg(), device="cpu", seed=0, ema_decay=0.9)
    before = [p.detach().clone() for p in tr.params]
    tr.train_step(pretrain_batch(tr.cfg, 2, seed=50))
    for e, b, p in zip(tr.ema, before, tr.params):
        torch.testing.assert_close(e, 0.9 * b + 0.1 * p.detach(),
                                   rtol=1e-6, atol=1e-7)


def test_state_dict_round_trip_resumes_the_run():
    batches = [pretrain_batch(_cfg(), 2, seed=s) for s in (60, 61)]
    a = CoarseTrainer(_cfg(), device="cpu", seed=0, ema_decay=0.99)
    a.train_step(batches[0])
    b = CoarseTrainer(_cfg(), device="cpu", seed=1, ema_decay=0.99)
    b.load_state_dict(a.state_dict())
    ma, mb = a.train_step(batches[1]), b.train_step(batches[1])
    torch.testing.assert_close(ma["total_loss"], mb["total_loss"],
                               rtol=0, atol=0)
    pb = _params(b)
    for k, v in _params(a).items():
        torch.testing.assert_close(v, pb[k], rtol=0, atol=0)
    assert a.step == b.step == 2
    assert int(b.queue.total) == 4
