"""Detection training against `fiber_tpu` at tiny dims on the CPU, fp32:
`detection_loss` with every optional head on (MLM, soft token,
contrastive alignment, shallow contrastive; deform off) and its gradients,
one `DetectionTrainer.train_step` against JAX's grads and optax update
(lr 1e-4, warmup 0, clip 1.0, EMA; two steps, the first at optax's
warmup factor), the schedules, the NaN guard,
`train_steps`, remat, and the multi-scale trainer on two bucket shapes.

Both packages see the same MLM draws (`random_word_mask` handed the same
`probs` / `rand_tokens`) and no dropout (the text dropout draws from
generators the two packages do not share)."""

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
from fiber_torch.detection import mlm as tmlm
from fiber_torch.models.layers import Dropout
from fiber_torch.train import detection_trainer as ttrain
from fiber_torch.utils.convert import detection_params_from_flax
from torch_detection_parity import (configs, fill, flatten, to_flax_all,
                                    unflatten)

torch.set_num_threads(1)
ATOL = 1e-4
# the tiny vocabulary (99 ids) holds the <mask> id
HEADS = dict(mlm_loss=True, use_token_loss=True, use_contrastive_align=True,
             use_shallow_contrastive=True, shallow_max_positive_anchors=16,
             mask_token_id=4)
LR, WD, EMA, CLIP = 1e-4, 1e-4, 0.999, 1.0


def det_batch(cfg, B: int, seed: int, size=None):
    """Seeded grounding batch with every field the optional losses read."""
    rng = np.random.default_rng(seed)
    H, W = size or cfg.image_size
    T, G = cfg.max_query_len, 4
    ids = rng.integers(5, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[-1, T - 4:] = 0
    ids[mask == 0] = 1
    xy = rng.uniform(0, min(H, W) - 30, (B, G, 2))
    wh = rng.uniform(12, 28, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[0, 3] = False
    pm = np.zeros((B, G, T), np.float32)
    for b in range(B):
        for g in range(G):
            pm[b, g, rng.integers(1, T - 5, 2)] = 1.0
    od = rng.integers(0, 3, (B, G)).astype(np.int32)
    od_tok = np.where(pm.any(1), rng.integers(0, 3, (B, T)), -1).astype(
        np.int32)
    green = np.where(rng.uniform(0, 1, (B, T)) < 0.8, 1, 0).astype(np.int32)
    green[0, 2] = -1
    return {"images": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask, "gt_boxes": boxes,
            "gt_valid": valid, "positive_map": pm, "greenlight_map": green,
            "gt_od_labels": od, "od_label_of_tokens": od_tok}


def mlm_draws(cfg, B: int, seed: int):
    rng = np.random.default_rng(seed)
    T = cfg.max_query_len
    return (rng.uniform(0, 0.4, (B, T)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))


def no_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def t_grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def parity():
    """JAX: the losses and grads of detection_loss (train=True) and the
    optax update of its detection optimizer; the port: the same losses,
    grads and one train_step on the same parameters and draws."""
    jcfg, tcfg = configs(**HEADS)
    tmodel = tdet.GroundingDetector(tcfg, device="cpu", for_training=True)
    sd = fill(tmodel, 0)
    params = unflatten(to_flax_all(sd, tcfg))
    jmodel = jdet.GroundingDetector(jcfg)
    batch = det_batch(tcfg, 2, seed=1)
    probs, rand = mlm_draws(tcfg, 2, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        mp.setattr(jmlm, "random_word_mask", functools.partial(
            jmlm.random_word_mask, probs=jnp.asarray(probs),
            rand_tokens=jnp.asarray(rand)))
        mp.setattr(tmlm, "random_word_mask", functools.partial(
            tmlm.random_word_mask, probs=torch.from_numpy(probs),
            rand_tokens=torch.from_numpy(rand).long()))

        def loss_fn(p):
            losses = jdet.detection_loss(jmodel, {"params": p}, jb,
                                         rngs={"dropout":
                                               jax.random.PRNGKey(0)},
                                         train=True)
            return losses["total_loss"], losses

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, jlosses), jgrads = grad_fn(params)
        # the first update runs at warmup_factor x lr (optax's schedule at
        # count 0), the second at lr: two steps, both against JAX's
        tx = jtrain.make_detection_optimizer(LR, LR, WD, 100, params,
                                             warmup_iters=0, clip_norm=CLIP)
        ema, p, opt = params, params, tx.init(params)
        for step in range(2):
            (_, step_losses), g = ((None, jlosses), jgrads) if step == 0 \
                else grad_fn(p)
            updates, opt = tx.update(g, opt, p)
            p = optax.apply_updates(p, updates)
            ema = jax.tree_util.tree_map(
                lambda e, q: EMA * e + (1 - EMA) * q, ema, p)
        # the port: detection_loss and its grads, then one train step
        tmodel.load_state_dict(sd, strict=True)
        no_dropout(tmodel)
        tlosses = tdet.detection_loss(tmodel, batch, train=True)
        tlosses["total_loss"].backward()
        tgrads = t_grads(tmodel)
        trainer = ttrain.DetectionTrainer(
            tcfg, device="cpu", base_lr=LR, lang_lr=LR, weight_decay=WD,
            max_iter=100, ema_decay=EMA, clip_norm=CLIP, warmup_iters=0)
        trainer.model.load_state_dict(sd, strict=True)
        for e, q in zip(trainer.ema, trainer.params):
            e.copy_(q.detach())
        no_dropout(trainer.model)
        trainer.train_step(batch)
        before = {n: q.detach().clone()
                  for n, q in trainer.model.named_parameters()}
        step_metrics = trainer.train_step(batch)
    return dict(jlosses=jlosses, jgrads=jgrads, tlosses=tlosses,
                tgrads=tgrads, trainer=trainer, step_metrics=step_metrics,
                step_losses=step_losses, new_params=p, ema=ema,
                before=before, tcfg=tcfg)


def to_port(tree, cfg):
    return detection_params_from_flax(flatten(tree), cfg)


def test_detection_loss_matches_jax(parity):
    want, got = parity["jlosses"], parity["tlosses"]
    assert set(got) == set(want)
    assert {"mlm_loss", "loss_token", "loss_contrastive_align",
            "loss_shallow_contrastive"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_detection_loss_grads_match_jax(parity):
    want = to_port(parity["jgrads"], parity["tcfg"])
    got = parity["tgrads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, err_msg=k)
    # the gradients are not all zero where a loss reaches
    assert float(got["rpn.head.mlm_head.bias"].abs().max()) > 0
    assert float(got["rpn.loss_evaluator.shallow_log_scale"].abs().max()) > 0


def test_train_step_matches_jax(parity):
    """The second step's losses, and the parameters and EMA after it."""
    m = parity["step_metrics"]
    for k, v in parity["step_losses"].items():
        np.testing.assert_allclose(m[k].numpy(), np.asarray(v), atol=ATOL,
                                   err_msg=k)
    assert float(m["finite"]) == 1.0
    tr = parity["trainer"]
    want = to_port(parity["new_params"], parity["tcfg"])
    want_ema = to_port(parity["ema"], parity["tcfg"])
    moved = 0.0
    for (name, p), e in zip(tr.model.named_parameters(), tr.ema):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(),
                                   atol=ATOL, err_msg=name)
        moved = max(moved, float((p.detach() - parity["before"][name])
                                 .abs().max()))
    assert moved > 0.5 * LR
    assert tr.step == 2


def test_schedule_matches_jax():
    for kw in (dict(warmup_iters=0), dict(warmup_iters=10),
               dict(warmup_iters=5, warmup_factor=0.1, gamma=0.5,
                    milestones=(0.3, 70))):
        s = ttrain.warmup_multistep_schedule(2e-4, 100, **kw)
        js = jtrain.warmup_multistep_schedule(2e-4, 100, **kw)
        for step in (0, 1, 4, 5, 9, 10, 29, 30, 66, 67, 69, 70, 88, 89, 99):
            assert s(step) == pytest.approx(float(js(step)), rel=1e-6), \
                (kw, step)


def test_plateau_scheduler_matches_jax():
    metrics = [0.3, 0.35, 0.34, 0.33, 0.36, 0.2, 0.2, 0.1, 0.5, 0.4, 0.4,
               0.4, 0.4, 0.4, 0.4, 0.4]
    for kw in (dict(), dict(patience=1, gamma=0.5, minimize=True,
                            max_decays=2)):
        a = ttrain.WarmupReduceLROnPlateau(**kw)
        b = jtrain.WarmupReduceLROnPlateau(**kw)
        for v in metrics:
            assert a.step(v) == b.step(v)
            assert a.exhausted == b.exhausted


def test_nan_guard_is_optax_zero_grad_update():
    """A non-finite loss: `finite` 0, and the parameters move as optax's
    update of all-zero gradients moves them (the decay only; lr 0.1 at the
    first update's warmup factor 0.001, wd 0.5: 5e-5 of each value)."""
    _, tcfg = configs()
    lr, wd = 0.1, 0.5
    tr = ttrain.DetectionTrainer(tcfg, device="cpu", base_lr=lr, lang_lr=lr,
                                 weight_decay=wd, ema_decay=None,
                                 clip_norm=CLIP, warmup_iters=0)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    batch = det_batch(tcfg, 2, seed=3)
    batch["images"][0, 0, 0, 0] = np.nan
    m = tr.train_step(batch)
    assert float(m["finite"]) == 0.0
    params = unflatten(to_flax_all(before, tcfg))
    tx = jtrain.make_detection_optimizer(lr, lr, wd, 100000, params,
                                         warmup_iters=0, clip_norm=CLIP)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    updates, _ = tx.update(zeros, tx.init(params), params)
    want = to_port(optax.apply_updates(params, updates), tcfg)
    decayed = 0
    for name, p in tr.model.named_parameters():
        # within two fp32 roundings of each value
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-9, rtol=3e-7, err_msg=name)
        decayed += int(not torch.equal(p.detach(), before[name]))
    assert decayed > 0


def test_train_steps_equal_sequential_steps():
    _, tcfg = configs()
    kw = dict(device="cpu", base_lr=LR, lang_lr=LR, warmup_iters=0,
              clip_norm=CLIP)
    a = ttrain.DetectionTrainer(tcfg, **kw)
    b = ttrain.DetectionTrainer(tcfg, **kw)
    batches = [det_batch(tcfg, 2, seed=s) for s in (4, 5)]
    losses = a.train_steps(batches)
    seq = torch.stack([b.train_step(x)["total_loss"] for x in batches])
    assert losses.shape == (2,)
    assert torch.equal(losses, seq)
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
    for e, f in zip(a.ema, b.ema):
        assert torch.equal(e, f)


def test_remat_matches_no_remat():
    """remat checkpoints the Swin blocks and DyConvs: the same losses and
    gradients, the dropouts' draws replayed."""
    _, plain_cfg = configs(mlm_loss=True, mask_token_id=4)
    _, remat_cfg = configs(mlm_loss=True, mask_token_id=4, remat=True)
    out = []
    for cfg in (plain_cfg, remat_cfg):
        tr = ttrain.DetectionTrainer(cfg, device="cpu", seed=3, base_lr=LR,
                                     lang_lr=LR, warmup_iters=0)
        m = tr.train_step(det_batch(cfg, 2, seed=6))
        out.append((m, [p.detach().clone() for p in tr.params]))
    (m0, p0), (m1, p1) = out
    for k in m0:
        assert float(m0[k]) == pytest.approx(float(m1[k]), abs=1e-6), k
    for a, b in zip(p0, p1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_multiscale_trainer_two_buckets_one_state_dict():
    """Landscape and portrait buckets through one parameter set: the model
    built at 64 x 64 gives, at 64 x 96, the outputs of a model built at
    64 x 96 with the same weights; the state_dict gains no key and the JAX
    converter (strict) still takes it."""
    _, tcfg = configs()
    tr = ttrain.MultiScaleDetectionTrainer(tcfg, device="cpu", base_lr=LR,
                                           lang_lr=LR, warmup_iters=0)
    keys = set(tr.model.state_dict())
    for size in ((64, 96), (96, 64), (64, 96)):
        assert tr.trainer_for(size) is tr
        m = tr.train_step(det_batch(tcfg, 2, seed=7, size=size))
        assert float(m["finite"]) == 1.0
        assert all(np.isfinite(float(v)) for v in m.values())
    assert set(tr.model.state_dict()) == keys
    to_flax_all(tr.model.state_dict(), tcfg)      # strict conversion
    other = tdet.GroundingDetector(configs(image_size=(96, 64))[1],
                                   device="cpu")
    other.load_state_dict(tr.model.state_dict(), strict=True)
    tr.model.eval()
    batch = det_batch(tcfg, 1, seed=8, size=(96, 64))
    args = (torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["input_ids"]).long(),
            torch.from_numpy(batch["attention_mask"]).long())
    with torch.no_grad():
        a, b = tr.model(*args)["head_out"], other(*args)["head_out"]
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert torch.equal(x, y), k


def test_detector_builds():
    """The serving build keeps eval mode and the compute dtype; the training
    build keeps fp32 masters in train mode."""
    _, tcfg = configs(compute_dtype=torch.bfloat16, **HEADS)
    serve = tdet.GroundingDetector(tcfg, device="cpu")
    train = tdet.GroundingDetector(tcfg, device="cpu", for_training=True)
    assert not serve.training and train.training
    assert serve.rpn["head"].cls_logits.weight.dtype == torch.bfloat16
    assert serve.rpn["head"].log_scale.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in train.parameters())
    assert set(serve.state_dict()) == set(train.state_dict())
    with train.autocast():
        x = torch.ones(2, 2) @ torch.ones(2, 2)
    assert x.dtype == torch.bfloat16
