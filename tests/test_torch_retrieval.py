"""Retrieval, the serving entry point: the port against
`fiber_tpu.objectives.retrieval` at tiny dims on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.objectives import retrieval as jret
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives import retrieval as tret
from torch_parity import LOSSES, build_models, model_inputs

torch.set_num_threads(1)

N_IMG, N_TXT = 3, 6
IMG2TXT = [[0, 1], [2, 3], [4, 5]]
TXT2IMG = [0, 0, 1, 1, 2, 2]


@pytest.fixture(scope="module")
def setup():
    jm, jv, tm, _ = build_models(seed=0)
    img, ids, masks = model_inputs(tm.cfg, N_TXT, seed=3)
    itc = np.random.default_rng(4).standard_normal((N_IMG, N_TXT)
                                                   ).astype(np.float32)
    return jm, jv, tm, img[:N_IMG], ids, masks, itc


@pytest.mark.parametrize("on_device", [True, False])
def test_itm_rerank_matrix_matches_jax(setup, on_device):
    """Both port paths (cached pipeline, host-staged full forward) against
    the JAX cached pipeline: top-4 of 6 texts per image, pair batch 4."""
    jm, jv, tm, img, ids, masks, itc = setup
    ref = jret.itm_rerank_matrix(jm, jv, img, ids, masks, itc, rerank_topk=4,
                                 pair_batch=4)
    out = tret.itm_rerank_matrix(tm, img, ids, masks, itc, rerank_topk=4,
                                 pair_batch=4, on_device=on_device)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    assert np.isinf(out).sum() == N_IMG * (N_TXT - 4)
    np.testing.assert_allclose(out[~np.isinf(out)], ref[~np.isinf(ref)],
                               atol=1e-4)


def test_rank_pairs_pipeline_matches_jax(setup):
    jm, jv, tm, img, ids, masks, _ = setup
    pair_img = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    pair_txt = np.array([0, 1, 2, 3, 4, 5, 5, 4])
    ref = jret.rank_pairs_pipeline(
        jm, jv, jnp.asarray(img), jnp.asarray(ids, jnp.int32),
        jnp.asarray(masks, jnp.int32), pair_img, pair_txt, 4, trunk_batch=1)
    out = tret.rank_pairs_pipeline(tm, img, ids, masks, pair_img, pair_txt, 4,
                                   trunk_batch=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_cached_pipeline_equals_full_forward_oracle(setup):
    _, _, tm, img, ids, masks, _ = setup
    pair_img = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    pair_txt = np.array([0, 1, 2, 3, 4, 5, 5, 4])
    cached = tret.rank_pairs_pipeline(tm, img, ids, masks, pair_img, pair_txt,
                                      4, trunk_batch=3)
    full = tret._rank_pairs_full(tm, img, ids, masks, pair_img, pair_txt, 4)
    torch.testing.assert_close(cached, full, atol=1e-5, rtol=1e-5)


def test_encode_corpus_matches_jax(setup):
    jm, jv, tm, img, ids, masks, _ = setup
    ref_i, ref_t = jret.encode_corpus(jm, jv, img, ids, masks, batch_size=2)
    out_i, out_t = tret.encode_corpus(tm, img, ids, masks, batch_size=2)
    np.testing.assert_allclose(out_i, ref_i, atol=1e-4)
    np.testing.assert_allclose(out_t, ref_t, atol=1e-4)


def test_evaluate_retrieval_matches_jax(setup):
    jm, jv, tm, img, ids, masks, _ = setup
    ref = jret.evaluate_retrieval(jm, jv, img, ids, masks, IMG2TXT, TXT2IMG,
                                  rerank_topk=3, batch_size=4)
    out = tret.evaluate_retrieval(tm, img, ids, masks, IMG2TXT, TXT2IMG,
                                  rerank_topk=3, batch_size=4)
    assert out == ref


def test_recall_at_k_matches_jax():
    score = np.random.default_rng(6).standard_normal((5, 10))
    img2txt = [[2 * i, 2 * i + 1] for i in range(5)]
    txt2img = [t // 2 for t in range(10)]
    assert (tret.recall_at_k(score, img2txt, txt2img, ks=(1, 3, 5))
            == jret.recall_at_k(score, img2txt, txt2img, ks=(1, 3, 5)))


def test_serving_needs_eval_mode():
    tm = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES), device="cpu")
    img, ids, masks = model_inputs(tm.cfg, 2, seed=5)
    with pytest.raises(ValueError, match="eval"):
        tret.rank_pairs_pipeline(tm, img, ids, masks, [0, 1], [0, 1], 2,
                                 trunk_batch=1)


def test_pairs_must_fill_whole_batches(setup):
    _, _, tm, img, ids, masks, _ = setup
    with pytest.raises(ValueError, match="pair_batch"):
        tret.rank_pairs_pipeline(tm, img, ids, masks, [0, 1, 2], [0, 1, 2], 2,
                                 trunk_batch=1)
