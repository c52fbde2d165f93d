"""Training objectives and the ITC queue: the port against
`fiber_tpu.objectives.coarse` and `fiber_tpu.parallel.itc_queue` at tiny
dims on the CPU, fp32, every head built, fusion gates non-zero, on the
same parameters and inputs.  Random draws differ between the packages, so
the tests hand both the same negatives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.objectives import coarse as jobj
from fiber_tpu.parallel.itc_queue import ItcQueue as JaxItcQueue
from fiber_torch.objectives import coarse as tobj
from fiber_torch.parallel.itc_queue import ItcQueue
from torch_parity import (PRETRAIN, build_models, copy_queue, jax_batch,
                          match_rows, pretrain_batch, to_np)

torch.set_num_threads(1)
ATOL = 1e-5
B = 3


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _queues(cfg, filled: int, seed: int):
    """A JAX queue with `filled` of its slots written, and the port's copy
    of it."""
    jq = JaxItcQueue.create(jax.random.PRNGKey(seed), cfg.itc_queue_size,
                            cfg.hidden_size, cfg.image_size, cfg.max_text_len,
                            input_dtype=jnp.float32)
    if filled:
        rng = np.random.default_rng(seed)
        f = rng.standard_normal((filled, cfg.hidden_size)).astype(np.float32)
        img = rng.standard_normal((filled, cfg.image_size, cfg.image_size, 3)
                                  ).astype(np.float32)
        ids = rng.integers(4, cfg.vocab_size, (filled, cfg.max_text_len))
        jq = jq.enqueue(jnp.asarray(f), jnp.asarray(-f), jnp.asarray(img),
                        jnp.asarray(ids, jnp.int32),
                        jnp.ones((filled, cfg.max_text_len), jnp.int32))
    tq = ItcQueue(cfg.itc_queue_size, cfg.hidden_size, cfg.image_size,
                  cfg.max_text_len, input_dtype=torch.float32, device="cpu")
    copy_queue(jq, tq)
    return jq, tq


@pytest.fixture(scope="module")
def setup():
    jm, jv, tm, flat = build_models(seed=0)
    batch = pretrain_batch(tm.cfg, B, seed=4)
    rng = np.random.default_rng(9)
    batch["vqa_targets"] = np.where(
        rng.random((B, tm.cfg.vqav2_label_size)) < 0.3,
        rng.random((B, tm.cfg.vqav2_label_size)), 0.0).astype(np.float32)
    batch["image_0"] = batch["image"]
    batch["image_1"] = rng.standard_normal(batch["image"].shape
                                           ).astype(np.float32)
    batch["answers"] = np.array([1, 0, 1])
    return dict(jm=jm, jv=jv, tm=tm, cfg=tm.cfg, batch=batch,
                jb=jax_batch(batch), tb=_tensors(batch))


def test_cross_entropy_ignore_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (4, 5))
    labels[rng.random((4, 5)) < 0.4] = -100
    ref = jobj.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels))
    out = tobj.cross_entropy_ignore(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_np(o), to_np(r), atol=ATOL)


def test_mlm_matches_jax(setup):
    s = setup
    ref = jobj.compute_mlm(s["jm"], s["jv"], s["jb"], train=False)
    with torch.no_grad():
        out = tobj.compute_mlm(s["tm"], s["tb"])
    for k in ref:
        np.testing.assert_allclose(to_np(out[k]), to_np(ref[k]), atol=ATOL)


@pytest.mark.parametrize("filled", [0, 5, 20])
def test_itc_loss_and_queue_match_jax(setup, filled):
    """Queue empty, partly filled, wrapped: the loss, and the queue after
    the batch is enqueued."""
    s = setup
    jq, tq = _queues(s["cfg"], filled, seed=filled)
    ref, jq_new, _ = jobj.compute_itc(s["jm"], s["jv"], s["jb"], jq,
                                      jax.random.PRNGKey(3), train=True)
    with torch.no_grad():
        out, _ = tobj.compute_itc(s["tm"], s["tb"], tq,
                                  torch.Generator().manual_seed(3))
    np.testing.assert_allclose(to_np(out["itc_loss"]),
                               to_np(ref["itc_loss"]), atol=ATOL)
    for k, v in tq.state_dict().items():
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(getattr(jq_new, k), np.float32),
                                   atol=ATOL, err_msg=k)
    assert int(tq.total) == filled + B
    assert int(tq.valid_count()) == min(filled + B, s["cfg"].itc_queue_size)


def test_mined_negatives_skip_diagonal_and_unfilled_slots():
    """Many draws over a (B, B + Q) similarity with 5 filled queue slots:
    never the row's own column, never an unfilled slot, and every other
    valid column drawn."""
    Bq, Q, filled = 4, 16, 5
    sim = torch.zeros(Bq, Bq + Q)
    gen = torch.Generator().manual_seed(0)
    valid = torch.tensor(Bq + filled)
    draws = torch.stack([tobj.mine_hard_negatives(sim, valid, gen)
                         for _ in range(400)])            # (400, B)
    rows = torch.arange(Bq)
    assert (draws != rows).all()
    assert (draws < Bq + filled).all()
    for i in range(Bq):
        assert set(draws[:, i].tolist()) == set(range(Bq + filled)) - {i}


def test_itc_negatives_not_self_with_empty_queue(setup):
    """B = 2 and an empty queue: each row's negative is the other row (as
    tests/test_objectives.py::test_itc_negatives_not_self)."""
    s = setup
    _, tq = _queues(s["cfg"], 0, seed=1)
    batch = {k: v[:2] for k, v in s["tb"].items()}
    with torch.no_grad():
        _, neg = tobj.compute_itc(s["tm"], batch, tq,
                                  torch.Generator().manual_seed(4),
                                  train=False)
    torch.testing.assert_close(neg["image_neg"], batch["image"].flip(0))
    torch.testing.assert_close(neg["text_neg"], batch["text_ids"].flip(0))
    assert int(tq.total) == 0


def test_dual_gather_reads_batch_and_queue():
    batch = torch.arange(3 * 2).reshape(3, 2).float()
    queue = 100 + torch.arange(4 * 2).reshape(4, 2)
    idx = torch.tensor([2, 3, 6, 0])
    out = tobj._dual_gather(batch, queue, idx)
    assert out.dtype == batch.dtype
    torch.testing.assert_close(out, torch.cat([batch, queue.float()])[idx])


@pytest.fixture(scope="module")
def jax_negatives(setup):
    """Negatives the JAX package mined from a partly filled queue."""
    s = setup
    jq, _ = _queues(s["cfg"], 5, seed=2)
    _, _, neg = jobj.compute_itc(s["jm"], s["jv"], s["jb"], jq,
                                 jax.random.PRNGKey(6), train=False)
    return neg


def test_itm_hardneg_matches_jax(setup, jax_negatives):
    s = setup
    ref = jobj.compute_itm_hardneg(s["jm"], s["jv"], s["jb"], jax_negatives,
                                   train=False)
    tneg = {k: torch.from_numpy(np.array(v)) for k, v in jax_negatives.items()}
    tneg = {k: v if k == "image_neg" else v.long() for k, v in tneg.items()}
    with torch.no_grad():
        mono = tobj.compute_itm_hardneg(s["tm"], s["tb"], tneg)
        chunked = tobj.compute_itm_hardneg(s["tm"], s["tb"], tneg, chunk=True)
    for k in ref:
        np.testing.assert_allclose(to_np(mono[k]), to_np(ref[k]), atol=ATOL)
    torch.testing.assert_close(chunked["itm_loss"], mono["itm_loss"],
                               rtol=0, atol=1e-6)
    assert chunked["itm_accuracy"] == mono["itm_accuracy"]


def test_itm_random_matches_jax_on_the_same_draws(setup):
    """The port's draws (roll offset, coin per pair) replayed on a second
    generator; the JAX model scores the same mixed batch."""
    s = setup
    with torch.no_grad():
        out = tobj.compute_itm_random(s["tm"], s["tb"],
                                      torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(8)
    offset = int(torch.randint(1, B, (), generator=g))
    labels = (torch.rand(B, generator=g) < 0.5).long().numpy()
    assert 1 <= offset < B
    img = s["batch"]["image"]
    mixed = np.where(labels[:, None, None, None] == 1, img,
                     np.roll(img, offset, axis=0))
    jm, jv = s["jm"], s["jv"]
    o = jm.apply(jv, jnp.asarray(mixed), s["jb"]["text_ids"],
                 s["jb"]["text_masks"], method=type(jm).infer)
    logits = jm.apply(jv, o["cls_feats"], method=type(jm).itm_logits)
    ref = jobj.cross_entropy_ignore(logits, jnp.asarray(labels))
    np.testing.assert_allclose(to_np(out["itm_loss"]), to_np(ref[0]),
                               atol=ATOL)
    np.testing.assert_allclose(to_np(out["itm_accuracy"]), to_np(ref[1]),
                               atol=ATOL)


@pytest.mark.parametrize("task", ["vqa", "nlvr2"])
def test_finetune_losses_match_jax(setup, task):
    s = setup
    jfn, tfn = {"vqa": (jobj.compute_vqa, tobj.compute_vqa),
                "nlvr2": (jobj.compute_nlvr2, tobj.compute_nlvr2)}[task]
    ref = jfn(s["jm"], s["jv"], s["jb"], train=False)
    with torch.no_grad():
        out = tfn(s["tm"], s["tb"])
    for k in ref:
        np.testing.assert_allclose(to_np(out[k]), to_np(ref[k]), atol=ATOL)


def test_pretrain_losses_match_jax(setup, monkeypatch):
    """MLM + ITC + hard-negative ITM summed, with the port's mining handed
    the indices the JAX package drew (empty queue: batch rows only)."""
    s = setup
    jq, tq = _queues(s["cfg"], 0, seed=5)
    rng = jax.random.PRNGKey(10)
    total, ref, _ = jobj.pretrain_losses(s["jm"], s["jv"], s["jb"], jq, rng,
                                         PRETRAIN, train=True)
    _, sub = jax.random.split(rng)       # pretrain_losses' draw for ITC
    _, _, neg = jobj.compute_itc(s["jm"], s["jv"], s["jb"], jq, sub,
                                 train=True)
    drawn = iter([match_rows(np.asarray(neg["image_neg"]),
                             s["batch"]["image"]),
                  match_rows(np.asarray(neg["text_neg"]),
                             s["batch"]["text_ids"])])
    monkeypatch.setattr(tobj, "mine_hard_negatives",
                        lambda sim, valid, gen: torch.from_numpy(next(drawn)))
    with torch.no_grad():
        ttotal, out = tobj.pretrain_losses(s["tm"], s["tb"], tq,
                                           torch.Generator(), PRETRAIN)
    np.testing.assert_allclose(to_np(ttotal), to_np(total), atol=ATOL)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(to_np(out[k]), to_np(ref[k]), atol=ATOL)
    assert int(tq.total) == B

