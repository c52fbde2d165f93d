"""Data-parallel detection training on two gloo ranks on the CPU against
the JAX package's global-batch step, at tiny dims in fp32.

Two ranks of `DetectionTrainer` (every optional head on: MLM, soft token,
contrastive alignment, shallow contrastive; clip 1, EMA), one image each
of a two-image batch whose images hold 3 and 4 boxes, take one
`train_step`.  JAX takes its detection loss's gradients on both images
and its optax update.  Both packages get the same MLM draws (the port's
ranks the rows of the global draws) and no dropout.  The ranks' ATSS
positives and MLM tokens differ; the losses, the clipped gradients, the
parameters and the EMA match JAX's, and the ranks end bit-equal."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.detection import detector as jdet
from fiber_tpu.detection import mlm as jmlm
from fiber_tpu.train import detection_trainer as jtrain
from fiber_torch.detection import detector as tdet
from fiber_torch.utils.convert import detection_params_from_flax
from test_torch_detection_train import HEADS, det_batch, mlm_draws
from torch_ddp import run_scenario
from torch_detection_parity import configs, fill, flatten, to_flax_all, \
    unflatten

torch.set_num_threads(1)
ATOL = 1e-4                     # as test_torch_detection_train.py
LOSS_ATOL = 1e-5
LR, WD, EMA, CLIP = 1e-4, 1e-4, 0.999, 1.0


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    jcfg, tcfg = configs(**HEADS)
    sd = fill(tdet.GroundingDetector(tcfg, device="cpu", for_training=True),
              0)
    params = unflatten(to_flax_all(sd, tcfg))
    jmodel = jdet.GroundingDetector(jcfg)
    batch = det_batch(tcfg, 2, seed=1)
    probs, rand = mlm_draws(tcfg, 2, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jmlm, "random_word_mask", functools.partial(
            jmlm.random_word_mask, probs=jnp.asarray(probs),
            rand_tokens=jnp.asarray(rand)))

        def loss_fn(p):
            losses = jdet.detection_loss(
                jmodel, {"params": p}, jb,
                rngs={"dropout": jax.random.PRNGKey(0)}, train=True)
            return losses["total_loss"], losses

        (_, jlosses), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jtrain.make_detection_optimizer(LR, LR, WD, 100, params,
                                         warmup_iters=0, clip_norm=CLIP)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    ema = jax.tree_util.tree_map(lambda e, q: EMA * e + (1 - EMA) * q,
                                 params, new_params)
    outs = run_scenario("detection_step", {
        "heads": HEADS, "model": sd, "batch": batch,
        "mlm_draws": (probs, rand),
        "trainer": dict(base_lr=LR, lang_lr=LR, weight_decay=WD,
                        max_iter=100, ema_decay=EMA, clip_norm=CLIP,
                        warmup_iters=0)},
        tmp_path_factory.mktemp("det"), timeout=300)
    return dict(jlosses=jlosses, jgrads=jgrads, params=new_params, ema=ema,
                tcfg=tcfg, outs=outs)


def _port(tree, cfg):
    return detection_params_from_flax(flatten(tree), cfg)


def test_ranks_count_differently(ddp):
    outs = ddp["outs"]
    assert [o["boxes"] for o in outs] == [3, 4]
    assert outs[0]["num_pos"] != outs[1]["num_pos"]
    assert outs[0]["mlm_tokens"] != outs[1]["mlm_tokens"]


def test_losses_match_jax_global_batch(ddp):
    want = ddp["jlosses"]
    for out in ddp["outs"]:
        got = out["metrics"]
        assert set(want) <= set(got)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=LOSS_ATOL, err_msg=k)
        assert float(got["finite"]) == 1.0


def test_clipped_grads_match_jax(ddp):
    """The all-reduced gradients after the global-norm clip, against JAX's
    global-batch gradients clipped as optax clips them."""
    leaves = jax.tree_util.tree_leaves(ddp["jgrads"])
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in leaves)))
    factor = min(1.0, CLIP / norm)
    want = _port(ddp["jgrads"], ddp["tcfg"])
    for out in ddp["outs"]:
        assert set(out["grads"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(out["grads"][k].numpy(),
                                       v.numpy() * factor, atol=ATOL,
                                       err_msg=k)


def test_params_and_ema_match_jax_and_agree_across_ranks(ddp):
    want = _port(ddp["params"], ddp["tcfg"])
    want_ema = _port(ddp["ema"], ddp["tcfg"])
    a, b = ddp["outs"]
    for i, (name, p) in enumerate(a["params"].items()):
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(a["ema"][i].numpy(),
                                   want_ema[name].numpy(), atol=ATOL,
                                   err_msg=name)
        assert torch.equal(p, b["params"][name]), name
        assert torch.equal(a["ema"][i], b["ema"][i]), name
