"""Caption finetuning losses: the port's caption MLE (through
`pretrain_losses` and one `CoarseTrainer.train_step`), gold
self-distillation, SCST sampling and loss, and the whole SCST step,
against `fiber_tpu` at tiny dims on the CPU, in fp32, on the same flax
parameters (fusion gates in [0.3, 0.7], biases and LayerNorm scales moved
off their init) carried into the port by `params_from_flax`.  Sampling is
held token for token: the port's sampler is fed the Gumbel noise
`jax.random.categorical` draws from the same keys.  The JAX side is built,
jitted and run once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu import native as jnative
from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.objectives import caption as jcap
from fiber_tpu.objectives import coarse as jobj
from fiber_tpu.train.trainer import CoarseTrainer as JaxCoarseTrainer
from fiber_torch import native as tnative
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives import caption as tcap
from fiber_torch.objectives import coarse as tobj
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.convert import params_from_flax
from torch_parity import (flatten, jax_batch, load_params, perturb, to_np,
                          unflatten)

torch.set_num_threads(1)
ATOL = 1e-5          # losses and metrics
GRAD_ATOL = 1e-4     # a train step's grads and update
# the caption-MLE preset's optimizer groups; warmup 0 so that the first
# update moves the parameters
KW = dict(loss_names=("caption_mle",), warmup_steps=0, learning_rate=1e-4)
BOS, EOS, PAD, MASK = 0, 2, 1, 4
B, K, MAX_LEN, ALPHA = 2, 3, 8, 0.3
GOLD_CASES = [(True, 0.1), (True, 1e-6), (False, 0.1)]   # (train, min_prob)


def _model(cfg, flat):
    m = FiberCoarse(cfg, device="cpu").eval()
    m.load_state_dict(params_from_flax(flat, m), strict=True)
    return m


def _noise(key, n, steps, vocab):
    """The Gumbel noise of each step of JAX's `sample_decode` from `key`:
    `rng, sub = split(rng)` per step, `categorical` = argmax(gumbel(sub) +
    logits)."""
    out, rng = {}, key
    for t in range(1, steps):
        rng, sub = jax.random.split(rng)
        out[t] = np.array(jax.random.gumbel(sub, (n, vocab), jnp.float32))
    return out


def _detok(row):
    return [int(t) for t in row if t not in (BOS, PAD, EOS)]


@pytest.fixture(scope="module")
def s():
    jtr = JaxCoarseTrainer(JaxFiberConfig.tiny_test(**KW))
    state = jtr.init_state(jax.random.PRNGKey(0))
    flat = perturb(flatten(state.params), 0)
    gold_flat = perturb(flatten(state.params), 1)     # not the student's
    params = unflatten(flat)
    state = state.replace(params=params, opt_state=jtr._tx.init(params))
    jm, jv = jtr.model, {"params": params}
    jgold = {"params": unflatten(gold_flat)}
    cfg = FiberConfig.tiny_test(**KW)
    V, L, S = cfg.vocab_size, cfg.max_text_len, cfg.image_size

    rng = np.random.default_rng(5)
    img = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    ids = rng.integers(5, V, (B, L)).astype(np.int64)
    ids[:, 0] = BOS
    masks = np.ones((B, L), np.int64)
    masks[1, L // 2:] = 0
    ids[masks == 0] = PAD
    ids[0, L - 3] = EOS
    batch = {"image": img, "text_ids": ids, "text_masks": masks}
    jb = jax_batch(batch)

    # caption MLE: pretrain_losses, and one train step's grads and update
    j_mle = jax.jit(lambda v, b: jobj.pretrain_losses(
        jm, v, b, None, jax.random.PRNGKey(1), ("caption_mle",),
        train=False)[:2])(jv, jb)
    grad_fn = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                      static_argnums=4)
    (loss, (metrics, _)), grads = grad_fn(state.params, jb, None,
                                          jax.random.PRNGKey(2), True)
    updates, _ = jtr._tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)

    # gold: the tiny model's token probabilities are about 1 / V, so at the
    # default min_prob of 0.1 every weight is min_prob; 1e-6 lets the gold
    # copy's probabilities through
    j_gold = {case: jcap.compute_caption_gold(
        jm, jv, jgold, jb, pad_id=PAD, min_prob=case[1], train=case[0])
        for case in GOLD_CASES}

    # sampling: JAX's tokens and the noise it drew
    key = jax.random.PRNGKey(7)
    j_emb = jax.jit(lambda v, x: jm.apply(
        v, x, method=type(jm).encode_image_caption))(jv, jb["image"])
    j_sampled = np.array(jcap.sample_decode(jm, jv, j_emb, key, BOS, EOS,
                                            PAD, MAX_LEN, K, MASK))
    noise = _noise(key, B * K, MAX_LEN, V)

    # SCST loss and grads on JAX's samples
    rewards = rng.uniform(0.0, 10.0, B * K).astype(np.float32)

    def scst(p):
        return jcap.scst_loss(jm, {"params": p}, jb["image"],
                              jnp.asarray(j_sampled, jnp.int32),
                              jnp.asarray(rewards), jb["text_ids"],
                              jb["text_masks"], PAD, ALPHA)

    j_scst, j_scst_grads = jax.jit(jax.value_and_grad(scst))(params)

    # the whole SCST step, on the native scorer, references per sampled row
    refs = {i: [list(rng.integers(5, V, 5)), list(rng.integers(5, V, 4))]
            for i in range(B * K)}
    j_cider = jcap.compute_caption_cider(
        jm, jv, jb, jnative.CiderD(refs), _detok, key, bos_id=BOS,
        eos_id=EOS, pad_id=PAD, max_len=MAX_LEN, num_samples=K, alpha=ALPHA,
        mask_token_id=MASK)

    return dict(cfg=cfg, flat=flat, gold_flat=gold_flat, batch=batch,
                tb={k: torch.from_numpy(v) for k, v in batch.items()},
                j_mle=j_mle, loss=loss, metrics=metrics, grads=grads,
                new_params=new_params, j_gold=j_gold,
                j_emb=np.array(j_emb), j_sampled=j_sampled, noise=noise,
                rewards=rewards, j_scst=j_scst, j_scst_grads=j_scst_grads,
                refs=refs, j_cider=j_cider)


def _close(got, want, what=""):
    """Within ATOL of the reference's magnitude (at least 1)."""
    got, want = to_np(got), to_np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


# --------------------------------------------------------------------------
# caption MLE
# --------------------------------------------------------------------------
def test_pretrain_losses_caption_mle_matches_jax(s):
    tm = _model(s["cfg"], s["flat"])
    with torch.no_grad():
        total, out = tobj.pretrain_losses(tm, s["tb"], None, None,
                                          ("caption_mle",))
    jtotal, jout = s["j_mle"]
    assert set(out) == set(jout) == {"caption_mle_loss",
                                     "caption_mle_accuracy"}
    _close(total, jtotal)
    for k in jout:
        _close(out[k], jout[k], k)
    # the labels: ids shifted left, PAD last, PAD ignored
    labels = tobj.shift_labels(s["tb"]["text_ids"], PAD)
    assert torch.equal(labels[:, :-1], s["tb"]["text_ids"][:, 1:])
    assert (labels[:, -1] == PAD).all()


@pytest.fixture(scope="module")
def stepped(s):
    ttr = CoarseTrainer(s["cfg"], device="cpu", seed=0)
    load_params(ttr, s["flat"])
    return ttr, ttr.train_step(s["batch"])


def test_caption_mle_step_losses_match_jax(s, stepped):
    ttr, tmetrics = stepped
    assert set(s["metrics"]) == {"caption_mle_loss", "caption_mle_accuracy"}
    np.testing.assert_allclose(to_np(tmetrics["total_loss"]), to_np(s["loss"]),
                               atol=GRAD_ATOL)
    for k, v in s["metrics"].items():
        np.testing.assert_allclose(to_np(tmetrics[k]), to_np(v),
                                   atol=GRAD_ATOL, err_msg=k)


def test_caption_mle_step_grads_and_update_match_jax(s, stepped):
    """Every parameter's gradient (zero where the caption loss does not
    reach, as in JAX) and the AdamW update after it."""
    ttr, _ = stepped
    want = params_from_flax(flatten(s["grads"]))
    got = {n: p.grad for n, p in ttr.model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(),
                                   atol=GRAD_ATOL, err_msg=k)
    rpb = [k for k in want if k.endswith("relative_position_bias_table")]
    assert rpb and all(np.abs(want[k].numpy()).max() > 0 for k in rpb)
    new = params_from_flax(flatten(s["new_params"]))
    for k, p in ttr.model.named_parameters():
        np.testing.assert_allclose(to_np(p), new[k].numpy(), atol=GRAD_ATOL,
                                   err_msg=k)
    assert ttr.step == 1 and ttr.queue is None


# --------------------------------------------------------------------------
# gold
# --------------------------------------------------------------------------
@pytest.mark.parametrize("train,min_prob", GOLD_CASES)
def test_caption_gold_matches_jax(s, train, min_prob):
    tm = _model(s["cfg"], s["flat"])
    gold = _model(s["cfg"], s["gold_flat"]).requires_grad_(False)
    out = tcap.compute_caption_gold(tm, gold, s["tb"], pad_id=PAD,
                                    min_prob=min_prob, train=train)
    ref = s["j_gold"][(train, min_prob)]
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k], k)
    assert not tm.training and not gold.training       # modes restored
    if train:
        out["caption_gold_loss"].backward()
        assert all(p.grad is None for p in gold.parameters())
        assert any(p.grad is not None and p.grad.abs().max() > 0
                   for p in tm.parameters())


def test_caption_gold_weights_differ_from_mle(s):
    """Below min_prob the gold copy sets the weights: another gold copy
    gives another loss, and neither is the MLE."""
    tm = _model(s["cfg"], s["flat"])
    with torch.no_grad():
        a = tcap.compute_caption_gold(tm, _model(s["cfg"], s["gold_flat"]),
                                      s["tb"], pad_id=PAD, min_prob=1e-6)
        b = tcap.compute_caption_gold(tm, tm, s["tb"], pad_id=PAD,
                                      min_prob=1e-6)
        mle = tobj.compute_caption_mle(tm, s["tb"], PAD)
    assert abs(float(a["caption_gold_loss"]) - float(b["caption_gold_loss"])
               ) > 1e-6
    assert abs(float(a["caption_gold_loss"])
               - float(mle["caption_mle_loss"])) > 1e-6


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------
def test_sample_decode_matches_jax_under_its_noise(s):
    tm = _model(s["cfg"], s["flat"])
    with torch.no_grad():
        emb = tm.encode_image_caption(s["tb"]["image"])
    np.testing.assert_allclose(emb.numpy(), s["j_emb"], atol=1e-4)
    noise = s["noise"]
    ids = tcap.sample_decode(tm, emb, None, BOS, EOS, PAD, MAX_LEN, K, MASK,
                             noise=lambda t: torch.from_numpy(noise[t]))
    assert ids.shape == (B * K, MAX_LEN) and ids.dtype == torch.long
    np.testing.assert_array_equal(ids.numpy(), s["j_sampled"])
    assert not (ids == MASK).any()
    assert (ids[:, 0] == BOS).all()


def test_sample_decode_from_a_generator_is_seeded(s):
    """The main path's draws: the same seed, the same samples; the mask
    token never drawn; after EOS or PAD only PAD."""
    tm = _model(s["cfg"], s["flat"])
    with torch.no_grad():
        emb = tm.encode_image_caption(s["tb"]["image"])
    draw = lambda seed: tcap.sample_decode(
        tm, emb, torch.Generator().manual_seed(seed), BOS, EOS, PAD, MAX_LEN,
        K, MASK)
    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and not torch.equal(a, draw(4))
    for row in a.tolist():
        assert MASK not in row
        ends = [i for i, t in enumerate(row[1:], 1) if t in (EOS, PAD)]
        if ends:
            assert all(t == PAD for t in row[ends[0] + 1:])


def test_sample_step_pads_after_eos_and_suppresses_mask():
    """One step on set logits: the mask token loses though its logit is the
    largest, a row that draws EOS is done, a done row takes PAD."""
    V, n = 10, 3
    logits = torch.zeros(n, V)
    logits[:, MASK] = 1e3
    logits[0, EOS] = 50.0
    logits[1, 7] = 50.0
    logits[2, 7] = 50.0
    ids = torch.full((n, 4), PAD, dtype=torch.long)
    ids[:, 0] = BOS
    done = torch.tensor([False, False, True])
    new_ids, new_done = tcap._sample_step(logits, torch.zeros(n, V), ids,
                                          done, 1, EOS, PAD, MASK)
    assert new_ids[:, 1].tolist() == [EOS, 7, PAD]
    assert new_done.tolist() == [True, False, True]
    assert (ids[:, 1] == PAD).all() and not done[0]     # inputs untouched
    new_ids, new_done = tcap._sample_step(logits, torch.zeros(n, V), new_ids,
                                          new_done, 2, EOS, PAD, MASK)
    assert new_ids[:, 2].tolist() == [PAD, 7, PAD]


def test_gumbel_noise_is_standard_gumbel():
    g = tcap.gumbel_noise((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01          # Euler's constant
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03


# --------------------------------------------------------------------------
# SCST
# --------------------------------------------------------------------------
def test_scst_loss_matches_jax(s):
    """The loss on JAX's samples and rewards, and the gradients of a few
    tensors (the image path through the Swin bias tables, the fusion gates,
    the decoder's head)."""
    tm = _model(s["cfg"], s["flat"])
    tb = s["tb"]
    loss = tcap.scst_loss(tm, tb["image"], torch.from_numpy(s["j_sampled"]),
                          torch.from_numpy(s["rewards"]), tb["text_ids"],
                          tb["text_masks"], PAD, ALPHA)
    _close(loss, s["j_scst"])
    loss.backward()
    assert not tm.training
    want = params_from_flax(flatten(s["j_scst_grads"]))
    got = dict(tm.named_parameters())
    picked = [k for k in want if k.endswith(
        ("relative_position_bias_table", "alpha_t2i", "mlm_score.bias",
         "cross_modal_att_layers.8.weight"))]
    assert len(picked) > 8
    for k in picked:
        g = want[k].numpy()
        np.testing.assert_allclose(
            to_np(got[k].grad), g, rtol=0,
            atol=GRAD_ATOL * max(1.0, float(np.abs(g).max())), err_msg=k)
    assert any(np.abs(want[k].numpy()).max() > 0 for k in picked)


def test_compute_caption_cider_matches_jax(s):
    """The whole step on the port's scorer and JAX's noise: the same
    samples, so the same rewards and loss; the loss trains the model."""
    tm = _model(s["cfg"], s["flat"])
    noise = s["noise"]
    out = tcap.compute_caption_cider(
        tm, s["tb"], tnative.CiderD(s["refs"]), _detok, None, bos_id=BOS,
        eos_id=EOS, pad_id=PAD, max_len=MAX_LEN, num_samples=K, alpha=ALPHA,
        mask_token_id=MASK, noise=lambda t: torch.from_numpy(noise[t]))
    ref = s["j_cider"]
    assert set(out) == set(ref) == {"caption_cider_loss", "mean_reward"}
    assert isinstance(out["mean_reward"], float)
    assert 0.0 <= out["mean_reward"] <= 10.0
    np.testing.assert_allclose(out["mean_reward"], ref["mean_reward"],
                               atol=ATOL)
    _close(out["caption_cider_loss"], ref["caption_cider_loss"])
    out["caption_cider_loss"].backward()
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for p in tm.parameters())
