"""End-to-end quality loop of the port: train, then evaluate.

The coarse half of `tests/test_quality_loop.py` on `fiber_torch`, with its
corpus, config, steps and threshold unchanged: overfit a tiny synthetic
corpus with `CoarseTrainer` for 150 steps on the CPU, then assert that ITC
retrieval and the ITM rerank clear a fixed recall threshold through the
port's `check_expected_results`."""

import numpy as np
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import init_rank_from_itm
from fiber_torch.objectives.retrieval import evaluate_retrieval
from fiber_torch.train.metrics import check_expected_results
from fiber_torch.train.trainer import CoarseTrainer

torch.set_num_threads(1)


def _coarse_corpus(cfg, n=6, seed=0):
    """n distinct (image, caption) pairs: block-pattern images + disjoint
    token captions so ITC can separate them."""
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    images = np.zeros((n, S, S, 3), np.float32)
    # distinct global color signature per image: the ITC image embedding
    # mean-pools over tokens, so position-only patterns with shared
    # colors collapse under pooling — separate in color space instead
    colors = np.array([[2, 0, 0], [0, 2, 0], [0, 0, 2],
                       [2, 2, -2], [2, -2, 2], [-2, 2, 2]], np.float32)
    for i in range(n):
        images[i] += colors[i % len(colors)][None, None, :]
        images[i, (i * 7) % S:(i * 7) % S + 16, :, i % 3] += 1.0
        images[i] += rng.standard_normal((S, S, 3)) * 0.05
    L = cfg.max_text_len
    ids = np.full((n, L), 1, np.int32)
    ids[:, 0] = 0
    for i in range(n):
        # caption = distinct token block
        ids[i, 1:6] = 10 + i * 8 + np.arange(5)
    masks = (ids != 1).astype(np.int32)
    masks[:, :6] = 1
    return images, ids, masks


def test_coarse_overfit_retrieval_beats_chance():
    # itc_pooler=False: at tiny width the tanh ITC pooler saturates and
    # collapses image embeddings to a near-rank-1 code; the reference flag
    # exists for exactly this ablation
    cfg = FiberConfig.tiny_test(loss_names=("itm", "itc"),
                                itc_queue_size=8, itc_pooler=False)
    n = 6
    images, ids, masks = _coarse_corpus(cfg, n)
    trainer = CoarseTrainer(cfg.replace(learning_rate=5e-4, warmup_steps=0,
                                        max_steps=200),
                            device="cpu", seed=0)
    batch = trainer.to_device({"image": images, "text_ids": ids,
                               "text_masks": masks})
    first = last = None
    for step in range(150):
        metrics = trainer.train_step(batch)
        if step == 0:
            first = float(metrics["itc_loss"])
        last = float(metrics["itc_loss"])
    assert last < first, (first, last)

    # the rerank head starts as the ITM match logit, exactly like the
    # reference's irtr conversion (fiber_module.py:112-114)
    model = init_rank_from_itm(trainer.model).eval()
    metrics = evaluate_retrieval(
        model, images, ids, masks, img2txt=[[i] for i in range(n)],
        txt2img=list(range(n)), rerank_topk=None, batch_size=n)
    # chance recall@1 = 1/6 ~= 0.17; demand clear separation, not
    # perfection
    errs = check_expected_results(metrics, [
        ("itc_tr_r1", 1.0, 0.5), ("itc_ir_r1", 1.0, 0.5),
        ("itm_tr_r1", 1.0, 0.5), ("itm_ir_r1", 1.0, 0.5),
    ])
    assert not errs, (errs, metrics)


def test_check_expected_results_equals_jax():
    from fiber_tpu.detection.evaluation import \
        check_expected_results as jax_check
    metrics = {"a": 0.9, "b": 0.2}
    expected = [("a", 1.0, 0.5), ("b", 1.0, 0.5), ("c", 0.0, 1.0)]
    got = check_expected_results(metrics, expected)
    assert got == jax_check(metrics, expected) and len(got) == 2
