"""The port's training support: `fiber_torch.train.metrics` against the
JAX package's copy (`fiber_tpu.train.metrics`), and
`fiber_torch.train.checkpoint.CheckpointManager` (round trip of a
`CoarseTrainer`, `max_to_keep`, `best.json`, latest-step resume)."""

import json
import os

import numpy as np
import pytest
import torch

from fiber_tpu.train import metrics as jmetrics
from fiber_torch.config import FiberConfig
from fiber_torch.train import metrics as tmetrics
from fiber_torch.train.checkpoint import CheckpointManager
from fiber_torch.train.trainer import CoarseTrainer

torch.set_num_threads(1)

LOSS_SETS = [("caption_mle",), ("caption_gold",), ("vqa",),
             ("itm", "mlm", "itc"), ("nlvr2", "caption_cider")]


def _steps(seed):
    """Per-step metric dicts with every task's statistic, some non-finite."""
    rng = np.random.default_rng(seed)
    keys = ["caption_mle_accuracy", "caption_mle_loss", "caption_gold_accuracy",
            "caption_cider_accuracy", "vqa_score", "itm_accuracy",
            "mlm_accuracy", "nlvr2_accuracy", "total_loss"]
    steps = [{k: float(rng.random()) for k in keys} for _ in range(7)]
    steps[3]["caption_mle_accuracy"] = float("nan")
    steps[5]["vqa_score"] = float("inf")
    return steps, [float(w) for w in rng.integers(1, 9, len(steps))]


@pytest.mark.parametrize("loss_names", LOSS_SETS)
@pytest.mark.parametrize("recall", [None, {"itc_ir_r1": 0.25,
                                           "itc_tr_r1": 0.5}])
def test_epoch_metrics_match_jax(loss_names, recall):
    steps, weights = _steps(len(loss_names))
    mine, theirs = (tmetrics.EpochMetrics(loss_names),
                    jmetrics.EpochMetrics(loss_names))
    for m, w in zip(steps, weights):
        # the port's trainer returns 0-dim tensors
        mine.update({k: torch.tensor(v) for k, v in m.items()}, w)
        theirs.update(m, w)
    got, want = mine.compute(recall), theirs.compute(recall)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["the_metric"] > 0
    mine.reset()
    assert np.isnan(mine.compute()["caption_mle_accuracy"])


def test_mean_accumulator_matches_jax():
    a, b = tmetrics.MeanAccumulator(), jmetrics.MeanAccumulator()
    for v, w in ((1.0, 2.0), (float("nan"), 1.0), (4.0, 1.0)):
        a.update(v, w)
        b.update(v, w)
    assert a.compute() == b.compute() == 2.0
    a.reset()
    assert np.isnan(a.compute())


def _trainer(seed=0):
    cfg = FiberConfig.tiny_test(loss_names=("caption_mle",), warmup_steps=0,
                                learning_rate=1e-3)
    return CoarseTrainer(cfg, device="cpu", seed=seed)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    S, L = cfg.image_size, cfg.max_text_len
    ids = rng.integers(5, cfg.vocab_size, (2, L))
    ids[:, 0] = 0
    masks = np.ones_like(ids)
    masks[1, L // 2:] = 0
    ids[masks == 0] = cfg.pad_token_id
    return {"image": rng.standard_normal((2, S, S, 3)).astype(np.float32),
            "text_ids": ids, "text_masks": masks}


def test_checkpoint_round_trip_resumes_the_same_step(tmp_path):
    """A trainer restored from step 1's checkpoint takes step 2 exactly as
    the one that saved it."""
    tr = _trainer()
    batch = _batch(tr.cfg, 1)
    tr.train_step(batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tr.step, tr.state_dict())
    fresh = _trainer(seed=5)
    fresh.load_state_dict(mgr.restore())
    assert fresh.step == tr.step == 1
    a, b = tr.train_step(batch), fresh.train_step(batch)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for (n, p), q in zip(tr.model.named_parameters(), fresh.params):
        assert torch.equal(p, q), n


def test_checkpoint_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 3, 7):
        mgr.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert mgr.steps() == [5, 7] and mgr.latest_step() == 7
    assert mgr.restore()["step"] == 7
    assert torch.equal(mgr.restore(5)["w"], torch.full((2,), 5.0))
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_best_json_higher_is_better(tmp_path):
    mgr = CheckpointManager(str(tmp_path), best_metric_name="the_metric")
    assert mgr.best_value() is None
    mgr.save(1, {}, {"the_metric": 0.5})
    mgr.save(2, {}, {"the_metric": 0.25})
    mgr.save(3, {}, {"other": 9.0})
    assert mgr.best_value() == 0.5
    mgr.save(4, {}, {"the_metric": torch.tensor(0.75)})
    with open(tmp_path / "best.json") as f:
        assert json.load(f) == {"step": 4, "value": 0.75}


def test_checkpoint_latest_step_resumes_across_managers(tmp_path):
    CheckpointManager(str(tmp_path)).save(3, {"step": 3})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3 and mgr.restore()["step"] == 3


def test_checkpoint_raises_on_an_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
