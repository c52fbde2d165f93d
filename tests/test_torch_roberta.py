"""RoBERTa text encoder: the port against `fiber_tpu.models.roberta` at
tiny dims on the CPU, with non-zero fusion gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models import roberta as jrob
from fiber_torch.models import roberta as trob
from torch_parity import flatten, load_into, perturb, unflatten

torch.set_num_threads(1)

D, HEADS, INTER, L, IMG_DIM = 32, 2, 128, 7, 48


def _ids_and_mask(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 99, (3, L)).astype(np.int64)
    mask = np.ones((3, L), np.int64)
    mask[1, 4:] = 0
    ids[mask == 0] = 1
    return ids, mask


def test_position_ids():
    ids, _ = _ids_and_mask(0)
    np.testing.assert_array_equal(
        trob.create_position_ids(torch.from_numpy(ids), 1).numpy(),
        np.asarray(jrob.create_position_ids(jnp.asarray(ids), 1)))


def test_extended_and_causal_masks():
    _, mask = _ids_and_mask(1)
    np.testing.assert_array_equal(
        trob.extended_attention_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jrob.extended_attention_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        trob.causal_attention_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jrob.causal_attention_mask(jnp.asarray(mask))))


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, L, D)).astype(np.float32)
    img = rng.standard_normal((3, 9, IMG_DIM)).astype(np.float32)
    _, mask = _ids_and_mask(seed)
    return x, img, np.array(jrob.extended_attention_mask(jnp.asarray(mask)))


@pytest.mark.parametrize("last_norm", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_roberta_layer_matches_jax(fused, last_norm):
    x, img, ext = _layer_inputs(2)
    jm = jrob.RobertaLayer(hidden_size=D, num_heads=HEADS,
                           intermediate_size=INTER, fuse_t2i=fused,
                           attn_drop=0.0, hidden_drop=0.0)
    img_j = jnp.asarray(img) if fused else None
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                        jnp.asarray(ext), img_j)
    flat = perturb(flatten(variables["params"]), 3)
    tm = trob.RobertaLayer(D, HEADS, INTER, fuse_t2i=fused,
                           image_kv_dim=IMG_DIM if fused else None,
                           attn_drop=0.0, hidden_drop=0.0).eval()
    load_into(tm, flat, "text_transformer/layer_0/",
              "text_transformer.encoder.layer.0.")
    ref = jm.apply({"params": unflatten(flat)}, jnp.asarray(x),
                   jnp.asarray(ext), img_j, last_norm=last_norm)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), torch.from_numpy(ext),
                 torch.from_numpy(img) if fused else None,
                 last_norm=last_norm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def encoder():
    """4 layers, the last 2 t2i-fused: layer 2 reads 48-wide image
    features, layer 3 64-wide."""
    jm = jrob.RobertaEncoderModel(
        vocab_size=99, hidden_size=D, num_layers=4, num_heads=HEADS,
        intermediate_size=INTER, max_position_embeddings=64,
        num_fuse_block=2, attn_drop=0.0, hidden_drop=0.0)
    ids, mask = _ids_and_mask(4)
    rng = np.random.default_rng(5)
    small = rng.standard_normal((3, 9, IMG_DIM)).astype(np.float32)
    large = rng.standard_normal((3, 4, 64)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(small),
                        jnp.asarray(large), 3,
                        method=jrob.RobertaEncoderModel.init_full)
    flat = perturb(flatten(variables["params"]), 4)
    tm = trob.RobertaEncoderModel(99, D, 4, HEADS, INTER, 64,
                                  image_kv_dims=(IMG_DIM, 64),
                                  attn_drop=0.0, hidden_drop=0.0).eval()
    load_into(tm, flat, "text_transformer/", "text_transformer.")
    return jm, {"params": unflatten(flat)}, tm, ids, mask, small, large


def test_encoder_text_only_matches_jax(encoder):
    jm, jv, tm, ids, mask, _, _ = encoder
    ref = jm.apply(jv, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_encoder_fused_stack_matches_jax(encoder):
    """Layers driven one by one with image features into the fused ones,
    as the fusion interleave does (JAX: init_full's forward)."""
    jm, jv, tm, ids, mask, small, large = encoder
    ref = jm.apply(jv, jnp.asarray(ids), jnp.asarray(mask),
                   jnp.asarray(small), jnp.asarray(large), 3,
                   method=jrob.RobertaEncoderModel.init_full)
    with torch.inference_mode():
        x = tm.embeddings(torch.from_numpy(ids))
        ext = trob.extended_attention_mask(torch.from_numpy(mask))
        for i, layer in enumerate(tm.layers):
            feats = (None if i < 2 else
                     torch.from_numpy(small if i < 3 else large))
            x = layer(x, attn_mask=ext, image_feats=feats)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-4)
