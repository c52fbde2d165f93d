"""Captioning: the port's decoder modules and `fiber_torch.objectives.caption`
against `fiber_tpu` at tiny dims on the CPU, in fp32, both on the same
flax parameters (fusion gates in [0.3, 0.7], biases and LayerNorm scales
moved off their init) carried into the port by `params_from_flax(strict)`.
The JAX side is built and run once per module, each of its programs
jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_tpu.objectives import caption as jcap
from fiber_torch.config import FiberConfig, task_finetune_caption_mle
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives import caption as tcap
from fiber_torch.utils.convert import _port_key, flax_path, params_from_flax
from torch_parity import flatten, perturb, to_np, unflatten

torch.set_num_threads(1)

LOSSES = ("caption_mle",)
BOS, EOS, PAD = 0, 2, 1
MAX_LEN = 8
B = 2


def _rel_err(got, ref) -> float:
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxFiberConfig.tiny_test(loss_names=LOSSES)
    jm = JaxFiberCoarse(jcfg)
    S, L = jcfg.image_size, jcfg.max_text_len
    variables = jm.init(jax.random.PRNGKey(0), jnp.ones((1, S, S, 3)),
                        jnp.full((1, L), 3, jnp.int32),
                        jnp.ones((1, L), jnp.int32),
                        method=JaxFiberCoarse.init_full)
    flat = perturb(flatten(variables["params"]), 0)
    jv = {"params": unflatten(flat)}
    tm = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES),
                     device="cpu").eval()
    tm.load_state_dict(params_from_flax(flat, tm), strict=True)

    rng = np.random.default_rng(3)
    img = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    ids = rng.integers(4, jcfg.vocab_size, (B, L)).astype(np.int64)
    ids[:, 0] = BOS
    masks = np.ones((B, L), np.int64)
    masks[1, L // 2:] = 0
    ids[masks == 0] = PAD
    steps = rng.integers(4, jcfg.vocab_size, (B, MAX_LEN)).astype(np.int64)

    j_emb = jax.jit(lambda v, x: jm.apply(
        v, x, method=JaxFiberCoarse.encode_image_caption))(jv, jnp.asarray(img))
    j_inf = jax.jit(lambda v, i, m, e: jm.apply(
        v, i, m, e, method=JaxFiberCoarse.infer_caption))(
        jv, jnp.asarray(ids, jnp.int32), jnp.asarray(masks, jnp.int32), j_emb)
    # one decode step at a time, pos traced, on a seeded token stream
    j_step = jax.jit(lambda v, tok, pos, c: jm.apply(
        v, tok, pos, c, method=JaxFiberCoarse.decode_caption_step))
    caches = jm.apply(jv, j_emb, MAX_LEN,
                      method=JaxFiberCoarse.init_caption_cache)
    j_logits = []
    for t in range(MAX_LEN):
        lg, caches = j_step(jv, jnp.asarray(steps[:, t:t + 1], jnp.int32),
                            t, caches)
        j_logits.append(np.asarray(lg))
    j_greedy = jcap.greedy_decode_cached(jm, jv, j_emb, BOS, EOS, PAD, MAX_LEN)
    j_beam = jcap.beam_search_decode_cached(jm, jv, j_emb, BOS, EOS, PAD,
                                            MAX_LEN, beam_size=3)
    with torch.inference_mode():
        t_emb = tm.encode_image_caption(torch.from_numpy(img))
    return dict(tm=tm, flat=flat, img=img, ids=ids, masks=masks, steps=steps,
                j_emb=np.array(j_emb), j_inf=j_inf, j_logits=j_logits,
                j_greedy=np.asarray(j_greedy),
                j_beam=tuple(np.asarray(x) for x in j_beam), t_emb=t_emb)


def test_caption_model_takes_the_flax_tree(setup):
    """The caption model's parameters are the flax tree's, one to one
    (`params_from_flax` is strict in the fixture): the MLM head and the
    projections of the fused layers below the last two."""
    tm, flat = setup["tm"], setup["flat"]
    assert sorted(tm.cross_modal_att_layers) == ["8", "9"]
    assert hasattr(tm, "mlm_score")
    assert {k for k in flat if k.startswith("caption_image_proj_")} == {
        f"caption_image_proj_{i}/{leaf}" for i in (8, 9)
        for leaf in ("kernel", "bias")}


def test_caption_preset_builds_with_reference_names():
    """FIBER-Base at 576^2 with the caption loss builds on the host; its
    projections are the reference's `cross_modal_att_layers.{6..9}`, from
    the stage-4 width (1024) to the stage-3 width, and every key maps to
    a flax path and back."""
    cfg = task_finetune_caption_mle()
    model = FiberCoarse(cfg, device="cpu")
    assert (cfg.image_size, cfg.derived_window_size) == (576, 18)
    assert sorted(model.cross_modal_att_layers, key=int) == ["6", "7", "8",
                                                             "9"]
    sd = model.state_dict()
    assert tuple(sd["cross_modal_att_layers.6.weight"].shape) == (512, 1024)
    for key, value in sd.items():
        shape = np.empty(tuple(value.shape), np.float32)
        assert _port_key(flax_path(key), shape)[0] == key, key


def test_encode_image_caption_matches_jax(setup):
    assert tuple(setup["t_emb"].shape) == setup["j_emb"].shape
    assert _rel_err(setup["t_emb"], setup["j_emb"]) <= 1e-3


@pytest.mark.parametrize("key", ["text_feats", "cls_feats"])
def test_infer_caption_matches_jax(setup, key):
    tm = setup["tm"]
    with torch.inference_mode():
        out = tm.infer_caption(torch.from_numpy(setup["ids"]),
                               torch.from_numpy(setup["masks"]),
                               torch.from_numpy(setup["j_emb"]))
    assert _rel_err(out[key], setup["j_inf"][key]) <= 1e-3


def test_decode_caption_step_logits_match_jax(setup):
    """The cached step's logits at every position of a seeded token
    stream, on the same image features."""
    tm, steps = setup["tm"], setup["steps"]
    with torch.inference_mode():
        caches = tm.init_caption_cache(torch.from_numpy(setup["j_emb"]),
                                       MAX_LEN)
        for t in range(MAX_LEN):
            logits, caches = tm.decode_caption_step(
                torch.from_numpy(steps[:, t:t + 1]), t, caches)
            np.testing.assert_allclose(to_np(logits), setup["j_logits"][t],
                                       atol=1e-4, rtol=0)


def test_decode_caption_step_matches_the_full_prefix(setup):
    """The cached step's logits equal the full causal re-encode's at the
    same position (the port against itself)."""
    tm, steps = setup["tm"], setup["steps"]
    emb = torch.from_numpy(setup["j_emb"])
    ids = torch.from_numpy(steps)
    with torch.inference_mode():
        caches = tm.init_caption_cache(emb, MAX_LEN)
        for t in range(MAX_LEN):
            logits, caches = tm.decode_caption_step(ids[:, t:t + 1], t, caches)
            full = tcap._step_logits(tm, ids[:, :t + 1], emb, PAD, t)
            np.testing.assert_allclose(to_np(logits), to_np(full), atol=1e-5,
                                       rtol=0)


def test_greedy_cached_tokens_match_jax_and_the_oracle(setup):
    tm, emb = setup["tm"], torch.from_numpy(setup["j_emb"])
    got = tcap.greedy_decode_cached(tm, emb, BOS, EOS, PAD, MAX_LEN)
    oracle = tcap.greedy_decode(tm, emb, BOS, EOS, PAD, MAX_LEN)
    assert got.shape == (B, MAX_LEN) and (got[:, 0] == BOS).all()
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    np.testing.assert_array_equal(got.numpy(), setup["j_greedy"])


def test_beam_cached_tokens_match_jax_and_the_oracle(setup):
    tm, emb = setup["tm"], torch.from_numpy(setup["j_emb"])
    ids, scores = tcap.beam_search_decode_cached(tm, emb, BOS, EOS, PAD,
                                                 MAX_LEN, beam_size=3)
    o_ids, o_scores = tcap.beam_search_decode(tm, emb, BOS, EOS, PAD,
                                              MAX_LEN, beam_size=3)
    j_ids, j_scores = setup["j_beam"]
    np.testing.assert_array_equal(ids.numpy(), o_ids.numpy())
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_allclose(scores.numpy(), o_scores.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(scores.numpy(), j_scores, atol=1e-5, rtol=0)


def test_beam_of_one_is_greedy(setup):
    tm, emb = setup["tm"], torch.from_numpy(setup["j_emb"])
    ids, _ = tcap.beam_search_decode_cached(tm, emb, BOS, EOS, PAD, MAX_LEN,
                                            beam_size=1)
    np.testing.assert_array_equal(
        ids.numpy(),
        tcap.greedy_decode_cached(tm, emb, BOS, EOS, PAD, MAX_LEN).numpy())


@pytest.mark.parametrize("use_cache", [True, False])
def test_caption_images_end_to_end(setup, use_cache):
    """Images in, captions out: encoded once, beam-decoded, the same as
    the decoders on the encoded features, with or without the cache."""
    tm = setup["tm"]
    ids, scores = tcap.caption_images(tm, setup["img"], BOS, EOS, PAD,
                                      max_len=MAX_LEN, beam_size=3,
                                      use_cache=use_cache)
    ref_ids, ref_scores = tcap.beam_search_decode_cached(
        tm, setup["t_emb"], BOS, EOS, PAD, MAX_LEN, beam_size=3)
    assert ids.shape == (B, MAX_LEN) and (ids[:, 0] == BOS).all()
    assert torch.isfinite(scores).all()
    np.testing.assert_array_equal(ids.numpy(), ref_ids.numpy())
    np.testing.assert_allclose(scores.numpy(), ref_scores.numpy(), atol=1e-5,
                               rtol=0)


def test_captioning_needs_eval_mode(setup):
    tm = setup["tm"]
    tm.train()
    try:
        with pytest.raises(ValueError):
            tcap.caption_images(tm, setup["img"], BOS, EOS, PAD, max_len=3,
                                beam_size=2)
    finally:
        tm.eval()
