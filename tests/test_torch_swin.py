"""Swin backbone: the port against `fiber_tpu.models.swin` at tiny dims on
the CPU (plain window-attention path), with non-zero fusion gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models import swin as jswin
from fiber_torch.models import swin as tswin
from torch_parity import flatten, load_into, perturb, unflatten

torch.set_num_threads(1)

TEXT_DIM, LT = 32, 5


@pytest.mark.parametrize("window", [2, 7, 12])
def test_relative_position_index(window):
    np.testing.assert_array_equal(tswin.relative_position_index(window),
                                  jswin.relative_position_index(window))


@pytest.mark.parametrize("H,W,window,shift", [(8, 8, 4, 2), (24, 24, 12, 6),
                                              (7, 21, 7, 3), (12, 16, 4, 2)])
def test_shifted_window_mask(H, W, window, shift):
    np.testing.assert_array_equal(
        tswin.shifted_window_mask(H, W, window, shift),
        jswin.shifted_window_mask(H, W, window, shift))


def test_window_partition_and_reverse():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)
                                                 ).astype(np.float32)
    pj = jswin.window_partition(jnp.asarray(x), 4)
    pt = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        tswin.window_reverse(pt, 4, 8, 12).numpy(), x)


def _text(B, seed):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((B, LT, TEXT_DIM)).astype(np.float32)
    text_bias = np.zeros((B, LT), np.float32)
    text_bias[0, 3:] = -10000.0
    return text, text_bias


@pytest.fixture(scope="module")
def tiny_swin():
    kw = dict(image_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 3, 2),
              num_heads=(2, 2, 2, 2), window_size=2, drop_path_rate=0.0,
              num_fuse_block=4)
    jm = jswin.SwinTransformer(**kw)
    img = np.random.default_rng(1).standard_normal((2, 64, 64, 3)
                                                   ).astype(np.float32)
    text, text_bias = _text(2, 2)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(img),
                        jnp.asarray(text), jnp.asarray(text_bias))
    flat = perturb(flatten(variables["params"]), 0)
    tm = tswin.SwinTransformer(text_dim=TEXT_DIM, **kw).eval()
    load_into(tm, flat, "vit_model/", "vit_model.")
    return jm, {"params": unflatten(flat)}, tm, img, text, text_bias


@pytest.mark.parametrize("with_text", [False, True])
def test_swin_transformer_matches_jax(tiny_swin, with_text):
    jm, jv, tm, img, text, text_bias = tiny_swin
    if with_text:
        ref = jm.apply(jv, jnp.asarray(img), jnp.asarray(text),
                       jnp.asarray(text_bias))
        with torch.inference_mode():
            out = tm(torch.from_numpy(img), torch.from_numpy(text),
                     torch.from_numpy(text_bias))
    else:
        ref = jm.apply(jv, jnp.asarray(img))
        with torch.inference_mode():
            out = tm(torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_fusion_gates_change_the_output(tiny_swin):
    """With non-zero gates the text must reach the image features."""
    _, _, tm, img, text, text_bias = tiny_swin
    with torch.inference_mode():
        a = tm(torch.from_numpy(img))
        b = tm(torch.from_numpy(img), torch.from_numpy(text),
               torch.from_numpy(text_bias))
    assert (a - b).abs().max() > 1e-3


@pytest.mark.parametrize("fuse_text", [False, True])
def test_swin_block_pad_to_window_matches_jax(fuse_text):
    """Detection-flavor block: a 6x6 map padded to two 4-windows, shifted,
    with the region mask over the padding."""
    kw = dict(dim=16, input_resolution=(6, 6), num_heads=2, window_size=4,
              shift_size=2, fuse_text=fuse_text, pad_to_window=True)
    jm = jswin.SwinBlock(**kw)
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 16)
                                                 ).astype(np.float32)
    text, text_bias = _text(2, 4)
    targs = (jnp.asarray(text), jnp.asarray(text_bias)) if fuse_text else ()
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), *targs)
    flat = perturb(flatten(variables["params"]), 1)
    tm = tswin.SwinBlock(text_dim=TEXT_DIM, **kw).eval()
    assert (tm.window, tm.shift, tm.Hp, tm.Wp) == (4, 2, 8, 8)
    load_into(tm, flat, "vit_model/layers_0/blocks_0/",
              "vit_model.layers.0.blocks.0.")
    ref = jm.apply({"params": unflatten(flat)}, jnp.asarray(x), *targs)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x),
                 *(torch.from_numpy(a) for a in ((text, text_bias)
                                                 if fuse_text else ())))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_coarse_block_clamps_window():
    """A coarse block whose map is no larger than the window becomes one
    global window with no shift."""
    blk = tswin.SwinBlock(16, (2, 2), 2, window_size=4, shift_size=2)
    assert (blk.window, blk.shift, blk.attn_mask) == (2, 0, None)


def test_patch_merging_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 4, 6, 8)
                                                 ).astype(np.float32)
    jm = jswin.PatchMerging(dim=8)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    flat = perturb(flatten(variables["params"]), 2)
    tm = tswin.PatchMerging(8)
    load_into(tm, flat, "vit_model/layers_0/downsample/",
              "vit_model.layers.0.downsample.")
    ref = jm.apply({"params": unflatten(flat)}, jnp.asarray(x))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
