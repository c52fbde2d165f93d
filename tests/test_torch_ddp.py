"""Data-parallel coarse training on two gloo ranks on the CPU against the
JAX package's global-batch step, at tiny dims in fp32.

Two ranks of `CoarseTrainer`, each given 2 of the 4 rows of a global
batch, take one `train_step` (MLM + ITC with its queue + hard-negative
ITM, no dropout, both packages handed the same fixed negatives, as
`tests/test_torch_trainer.py` hands the port JAX's).  JAX takes the step
on all 4 rows, sharded over a 2-device CPU mesh.  The ranks' MLM label counts differ, so
a mean of per-rank means (DDP's AVG) would miss JAX's loss; the global
counts meet it.  The VQA, caption-MLE and random-ITM trainers on two
ranks match the port's one-process step on the global batch, and a state
saved from two ranks with dropout on resumes bit-equal.  The queue's
input rings split over two ranks (Q = 16, a global batch of 4, six steps,
so the ring wraps) give the negatives and losses of whole rings, bit for
bit, and checkpoints of one process's format."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.parallel.itc_queue import ItcQueue as JaxItcQueue
from fiber_tpu.parallel.mesh import create_mesh as jax_mesh
from fiber_tpu.parallel.mesh import shard_batch as jax_shard
from fiber_tpu.train.optim import make_optimizer as jax_optimizer
from fiber_tpu.train.trainer import CoarseTrainer as JaxCoarseTrainer
from fiber_tpu.utils.checkpoint_convert import convert_fiber_state_dict
from fiber_torch.config import FiberConfig
from fiber_torch.parallel.itc_queue import ItcQueue
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.convert import params_from_flax
from torch_ddp import run_scenario
from torch_parity import (PRETRAIN, copy_queue, flatten, jax_batch,
                          pretrain_batch, to_np)

torch.set_num_threads(1)
ATOL = 1e-4            # grads and parameters, as test_torch_trainer.py
LOSS_ATOL = 1e-5
KW = dict(warmup_steps=0, learning_rate=1e-4)
B = 4                  # the global batch, 2 rows a rank
# the mined negatives both packages take: each row's image negative and
# text negative, global rows of the batch (the queue is still empty)
NEGATIVES = [np.array([1, 2, 3, 0]), np.array([3, 0, 1, 2])]


def _gated_state(model, seed: int):
    """The port model's state_dict with every fusion gate moved off 0."""
    rng = np.random.default_rng(seed)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith(("alpha_i2t", "alpha_t2i")):
            sd[k] = torch.from_numpy(
                rng.uniform(0.3, 0.7, tuple(sd[k].shape)).astype(np.float32))
    return sd


def _categorical(draws):
    """`jax.random.categorical` replaced by the fixed negatives, in the
    order compute_itc mines (images, then texts)."""
    it = iter(draws)
    return lambda key, logits, axis=-1: jnp.asarray(next(it), jnp.int32)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """JAX: the grads of its loss_fn on the global batch, sharded over a
    2-device CPU mesh, and its optax update; the port: one train_step on
    two gloo ranks from the same parameters, queue and negatives.  JAX's
    parameters come from the port's seeded model through the checkpoint
    converter (no flax init)."""
    cfg = FiberConfig.tiny_test(loss_names=PRETRAIN, **KW)
    ttr = CoarseTrainer(cfg, device="cpu", seed=0)
    sd = _gated_state(ttr.model, 0)
    ttr.model.load_state_dict(sd)
    params, unmapped = convert_fiber_state_dict(
        {k: v.numpy() for k, v in sd.items()}, strict=True)
    assert not unmapped
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jcfg = JaxFiberConfig.tiny_test(loss_names=PRETRAIN, **KW)
    jtr = JaxCoarseTrainer(jcfg)
    tx = jax_optimizer(jcfg, params)
    queue = JaxItcQueue.create(jax.random.PRNGKey(1), jcfg.itc_queue_size,
                               jcfg.hidden_size, jcfg.image_size,
                               jcfg.max_text_len, input_dtype=jnp.float32)
    copy_queue(queue, ttr.queue)
    batch = pretrain_batch(cfg, B, seed=1)
    # rank 1's rows hold more MLM labels than rank 0's
    batch["text_labels_mlm"][2:, 2:6] = batch["text_ids"][2:, 2:6]
    batch["text_ids_mlm"][2:, 2:6] = 3
    mesh = jax_mesh(jax.devices()[:2])
    grad_fn = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                      static_argnums=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical", _categorical(NEGATIVES))
        (loss, (metrics, new_queue)), grads = grad_fn(
            params, jax_shard(mesh, jax_batch(batch)), queue,
            jax.random.PRNGKey(2), True)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    outs = run_scenario("coarse_step", {
        "cfg": dict(loss_names=PRETRAIN, **KW), "model": sd,
        "queue": ttr.queue.state_dict(), "batch": batch,
        "negatives": NEGATIVES}, tmp_path_factory.mktemp("coarse"))
    return dict(loss=loss, metrics=metrics, grads=grads, params=new_params,
                queue=new_queue, outs=outs)


def test_losses_match_jax_global_batch(ddp):
    for out in ddp["outs"]:
        m = out["metrics"]
        np.testing.assert_allclose(to_np(m["total_loss"]), to_np(ddp["loss"]),
                                   atol=LOSS_ATOL)
        for k, v in ddp["metrics"].items():
            np.testing.assert_allclose(to_np(m[k]), to_np(v),
                                       atol=LOSS_ATOL, err_msg=k)


def test_global_normalizer_is_not_a_mean_of_means(ddp):
    """The ranks count different MLM labels; their partials sum to JAX's
    MLM loss, and the mean of the ranks' own means does not."""
    outs = ddp["outs"]
    counts = [o["mlm_count"] for o in outs]
    assert counts[0] != counts[1], counts
    partials = [float(o["mlm_partial"]) for o in outs]
    want = float(ddp["metrics"]["mlm_loss"])
    np.testing.assert_allclose(sum(partials), want, atol=LOSS_ATOL)
    total = sum(counts)
    avg_of_means = np.mean([p * total / c for p, c in zip(partials, counts)])
    assert abs(avg_of_means - want) > 100 * LOSS_ATOL, (avg_of_means, want)


def test_grads_match_jax_global_batch(ddp):
    want = params_from_flax(flatten(ddp["grads"]))
    for out in ddp["outs"]:
        assert out["grad_is_view"]
        assert set(out["grads"]) == set(want)
        for k in want:
            np.testing.assert_allclose(to_np(out["grads"][k]),
                                       want[k].numpy(), atol=ATOL,
                                       err_msg=k)


def test_params_match_jax_and_agree_across_ranks(ddp):
    want = params_from_flax(flatten(ddp["params"]))
    a, b = (o["params"] for o in ddp["outs"])
    for k in want:
        np.testing.assert_allclose(to_np(a[k]), want[k].numpy(), atol=ATOL,
                                   err_msg=k)
        assert torch.equal(a[k], b[k]), k


def test_queue_takes_the_global_batch_on_every_rank(ddp):
    """Both ranks' queues are bit-equal and hold the global batch in rank
    order, as JAX's queue does after the step."""
    qa, qb = (o["queue"] for o in ddp["outs"])
    for k in qa:
        assert torch.equal(qa[k], qb[k]), k
    assert int(qa["total"]) == B and int(qa["ptr"]) == B
    for k in ("text_inputs", "text_masks", "image_inputs"):
        np.testing.assert_array_equal(
            to_np(qa[k][:B]), np.asarray(getattr(ddp["queue"], k)[:B],
                                         np.float32), err_msg=k)
    for k in ("image_feats", "text_feats"):
        np.testing.assert_allclose(to_np(qa[k]),
                                   np.asarray(getattr(ddp["queue"], k)),
                                   atol=ATOL, err_msg=k)
    # the mining drew for the global batch on every rank
    assert all(o["mine_rows"] == [B, B, B, B] for o in ddp["outs"])


def _task_batches(cfg_kw):
    vqa_cfg = FiberConfig.tiny_test(loss_names=("vqa",), **cfg_kw)
    vqa = pretrain_batch(vqa_cfg, B, seed=11)
    rng = np.random.default_rng(12)
    vqa["vqa_targets"] = np.where(
        rng.random((B, vqa_cfg.vqav2_label_size)) < 0.3,
        rng.random((B, vqa_cfg.vqav2_label_size)), 0.0).astype(np.float32)
    cap = pretrain_batch(vqa_cfg, B, seed=13)
    cap["text_masks"][:2, 5:] = 0           # rank 0 has fewer tokens
    cap["text_ids"][cap["text_masks"] == 0] = vqa_cfg.pad_token_id
    itm = pretrain_batch(vqa_cfg, B, seed=14)
    return {"vqa": (dict(loss_names=("vqa",), **cfg_kw), vqa),
            "caption_mle": (dict(loss_names=("caption_mle",), **cfg_kw),
                            cap),
            "itm_random": (dict(loss_names=("itm",), **cfg_kw), itm)}


def test_vqa_caption_mle_and_random_itm_match_one_process(tmp_path):
    """Two ranks against the port's one-process step on the global batch
    (itself held against JAX by test_torch_vqa_finetune.py and
    test_torch_caption_losses.py); the random ITM pairs are drawn for the
    global batch, so both take the same."""
    tasks = _task_batches(KW)
    outs = run_scenario("coarse_tasks", {"tasks": tasks}, tmp_path)
    for name, (kw, batch) in tasks.items():
        tr = CoarseTrainer(FiberConfig.tiny_test(**kw), device="cpu", seed=0)
        want = tr.train_step(batch)
        params = {n: p.detach() for n, p in tr.model.named_parameters()}
        a, b = (o[name] for o in outs)
        for k, v in want.items():
            np.testing.assert_allclose(to_np(a["metrics"][k]), to_np(v),
                                       atol=LOSS_ATOL, err_msg=f"{name} {k}")
        for k, v in params.items():
            np.testing.assert_allclose(to_np(a["params"][k]), to_np(v),
                                       atol=ATOL, err_msg=f"{name} {k}")
            assert torch.equal(a["params"][k], b["params"][k]), k


def test_two_rank_state_resumes_bit_equal(tmp_path):
    """Dropout and drop-path on: a trainer restored from a two-rank state
    (each rank's dropout generator among it) takes the next step as the
    uninterrupted trainer does, to the bit."""
    cfg = dict(loss_names=("itm", "mlm", "itc"), drop_rate=0.1,
               swin_drop_path_rate=0.1, **KW)
    tiny = FiberConfig.tiny_test(**cfg)
    batches = [pretrain_batch(tiny, B, seed=s) for s in (20, 21)]
    outs = run_scenario("coarse_resume", {"cfg": cfg, "batches": batches},
                        tmp_path)
    for out in outs:
        assert out["dropout_states"] == 2
        for k, v in out["a"].items():
            assert torch.equal(v, out["b"][k]), k
        for k, v in out["pa"].items():
            assert torch.equal(v, out["pb"][k]), k
    for k, v in outs[0]["pa"].items():
        assert torch.equal(v, outs[1]["pa"][k]), k


# ---------------------------------------------------------------------------
# The queue's input rings split over the data ranks
# ---------------------------------------------------------------------------
QUEUE_STEPS = 6        # 24 rows through a 16-slot ring: it wraps


@pytest.fixture(scope="module")
def sharded_queue(tmp_path_factory):
    """Two ranks step QUEUE_STEPS global batches with the input rings
    split over them and again with whole rings (the same start, the mining
    drawing from the trainer's generator)."""
    cfg = dict(loss_names=PRETRAIN, **KW)
    tiny = FiberConfig.tiny_test(**cfg)
    batches = [pretrain_batch(tiny, B, seed=40 + i)
               for i in range(QUEUE_STEPS)]
    outs = run_scenario("sharded_queue", {"cfg": cfg, "batches": batches},
                        tmp_path_factory.mktemp("queue"))
    return dict(cfg=tiny, outs=outs)


def test_sharded_rings_give_whole_ring_negatives(sharded_queue):
    """Each rank holds Q / 2 slots; every step's negatives and metrics are
    bit-equal to the whole rings'; some negatives came from the other
    rank's slots after the ring wrapped."""
    Q = sharded_queue["cfg"].itc_queue_size
    cross = 0
    for rank, out in enumerate(sharded_queue["outs"]):
        a, b = out["sharded"], out["whole"]
        assert a["sharded"] and not b["sharded"]
        assert a["lo"] == rank * Q // 2
        assert 2 * a["input_bytes"] == b["input_bytes"]
        assert len(a["negatives"]) == QUEUE_STEPS
        for x, y in zip(a["negatives"], b["negatives"]):
            for k in x:
                assert torch.equal(x[k], y[k]), k
        for x, y in zip(a["metrics"], b["metrics"]):
            for k in x:
                assert torch.equal(x[k], y[k]), k
        for x, y in zip(a["mined"], b["mined"]):
            assert torch.equal(x, y)
        other = (1 - rank) * Q // 2
        slots = torch.cat(a["mined"][2:]) - B
        cross += int(((slots >= other) & (slots < other + Q // 2)).sum())
    assert cross > 0


def test_sharded_rings_hold_the_whole_rings_slots(sharded_queue):
    """Each rank's block equals the same slots of the whole rings, and the
    gathered state equals the whole queue's, bit for bit."""
    for out in sharded_queue["outs"]:
        a, b = out["sharded"], out["whole"]
        n = a["block"]["image_inputs"].shape[0]
        assert int(b["state"]["total"]) == QUEUE_STEPS * B
        for k, v in a["block"].items():
            assert torch.equal(v, b["state"][k][a["lo"]:a["lo"] + n]), k
        for k in b["state"]:
            assert torch.equal(a["state"][k], b["state"][k]), k


def test_sharded_queue_checkpoints_both_ways(sharded_queue):
    """A sharded queue's state restores in one process, and one process's
    state restores into a sharded queue, which holds its slots and saves
    it back bit for bit."""
    c = sharded_queue["cfg"]
    for out in sharded_queue["outs"]:
        saved = out["sharded"]["state"]
        one = ItcQueue(c.itc_queue_size, c.hidden_size, c.image_size,
                       c.max_text_len, input_dtype=c.compute_dtype,
                       device="cpu")
        one.load_state_dict(saved)
        for k, v in one.state_dict().items():
            assert torch.equal(v, saved[k]), k
        lo = out["sharded"]["lo"]
        for k, v in out["restored_block"].items():
            assert torch.equal(v, saved[k][lo:lo + v.shape[0]]), k
        for k, v in out["restored"].items():
            assert torch.equal(v, saved[k]), k


def test_rings_stay_whole_when_slots_do_not_divide(sharded_queue):
    for out in sharded_queue["outs"]:
        assert out["odd"] == (False, 15, 15)
