"""The Swin-T trunks against `fiber_tpu` on the CPU, fp32:
`JointWindowAttention`, `SwinBlockVL` unshifted and shifted on a map that
needs padding, `SwinV2Block` with layer scale, `SwinVLBackbone` v1 and v2
with the language on and off, `SwinV2Backbone`, and the gradients of the
image and the text.  Blocks at 1e-5, trunks at 1e-4 (of each output's
max-abs, at least 1).  The JAX modules' parameters are seeded numpy
values carried to the port by `utils/convert.py::zoo_params_from_flax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models import swin as jswin
from fiber_tpu.models import swin_v2 as jv2
from fiber_tpu.models import swin_vl as jvl
from fiber_torch.models import swin_v2 as tv2
from fiber_torch.models import swin_vl as tvl
from fiber_torch.utils.convert import zoo_params_from_flax
from torch_zoo_parity import (abstract_params, assert_close, jax_apply,
                              random_params, text, unflatten)

torch.set_num_threads(1)
B, C, HEADS, WIN, NTEXT, LT, DT = 2, 32, 2, 7, 8, 6, 24
TRUNK = dict(embed_dim=16, depths=(1, 1, 2, 2), num_heads=(2, 2, 2, 2),
             window_size=7)


def _text_inputs(seed):
    t, mask = text(B, LT, DT, seed)
    add = np.where(mask.astype(bool), 0.0, jvl.NEG_INF).astype(np.float32)
    return t, mask, add


def test_joint_window_attention_matches_jax():
    rng = np.random.default_rng(0)
    nW, N = 4, WIN * WIN
    x = rng.standard_normal((B, nW, N, C)).astype(np.float32)
    shift = jswin.shifted_window_mask(14, 14, WIN, 3)
    t, _, add = _text_inputs(1)
    jm = jvl.JointWindowAttention(dim=C, window=WIN, num_heads=HEADS,
                                  ntext=NTEXT, dim_text=DT)
    args = (jnp.asarray(x), jnp.asarray(shift), jnp.asarray(t),
            jnp.asarray(add))
    flat = random_params(abstract_params(jm, *args), seed=2)
    tm = tvl.JointWindowAttention(C, WIN, HEADS, NTEXT, DT)
    tm.load_state_dict(zoo_params_from_flax("swin", flat, tm))
    jx, jt = jax_apply(jm, flat, *args)
    with torch.no_grad():
        tx, tt = tm(torch.from_numpy(x), torch.from_numpy(shift),
                    torch.from_numpy(t), torch.from_numpy(add))
    assert_close(tx, jx, 1e-5, "windows")
    assert_close(tt, jt, 1e-5, "text")


@pytest.mark.parametrize("res,shift", [((14, 14), 0), ((10, 12), 3)])
def test_swin_block_vl_matches_jax(res, shift):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, *res, C)).astype(np.float32)
    t, _, add = _text_inputs(4)
    kw = dict(dim=C, input_resolution=res, num_heads=HEADS, window_size=WIN,
              shift_size=shift, ntext=NTEXT, dim_text=DT)
    jm = jvl.SwinBlockVL(**kw)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(add))
    flat = random_params(abstract_params(jm, *args), seed=5)
    tm = tvl.SwinBlockVL(C, res, HEADS, WIN, shift, NTEXT, DT)
    tm.load_state_dict(zoo_params_from_flax("swin", flat, tm))
    tm.eval()
    jx, jt = jax_apply(jm, flat, *args)
    with torch.no_grad():
        tx, tt = tm(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(add))
    assert_close(tx, jx, 1e-5, "image")
    assert_close(tt, jt, 1e-5, "text")


@pytest.mark.parametrize("res,shift", [((10, 12), 3), ((5, 6), 3)])
def test_swin_v2_block_layer_scale_matches_jax(res, shift):
    """With layer scale; a map within one window takes no shift."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, *res, C)).astype(np.float32)
    jm = jv2.SwinV2Block(dim=C, input_resolution=res, num_heads=HEADS,
                         window_size=WIN, shift_size=shift, layer_scale=True)
    flat = random_params(abstract_params(jm, jnp.asarray(x)), seed=7)
    tm = tv2.SwinV2Block(C, res, HEADS, WIN, shift, layer_scale=True)
    tm.load_state_dict(zoo_params_from_flax("swin", flat, tm))
    tm.eval()
    assert tm.shift == (0 if max(res) <= WIN else shift)
    want = jax_apply(jm, flat, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got, want, 1e-5, "block")


def _images(seed, size=(64, 96)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, *size, 3)).astype(np.float32)


def _trunk_pair(version, vl, seed):
    kw = dict(TRUNK, max_query_len=NTEXT, lang_dim=DT, version=version,
              vl=vl, layer_scale=version == "v2")
    jm = jvl.SwinVLBackbone(image_size=(64, 96), **kw)
    images = _images(seed)
    t, mask, _ = _text_inputs(seed + 1)
    args = (jnp.asarray(images), jnp.asarray(t), jnp.asarray(mask))
    flat = random_params(abstract_params(jm, *args), seed=seed + 2)
    tm = tvl.SwinVLBackbone((64, 96), **kw)
    tm.load_state_dict(zoo_params_from_flax("swin", flat, tm))
    tm.eval()
    return jm, flat, tm, images, t, mask


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("vl", [True, False])
def test_swin_vl_backbone_matches_jax(version, vl):
    jm, flat, tm, images, t, mask = _trunk_pair(version, vl, seed=10)
    jouts, jlang = jax_apply(jm, flat, jnp.asarray(images), jnp.asarray(t),
                             jnp.asarray(mask))
    with torch.no_grad():
        touts, tlang = tm(torch.from_numpy(images), torch.from_numpy(t),
                          torch.from_numpy(mask))
    assert len(touts) == 3
    for i, (g, w) in enumerate(zip(touts, jouts)):
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4, f"tap {i}")
    if vl:
        for key in ("hidden", "embedded", "aggregate"):
            assert_close(tlang[key], jlang[key], 1e-4, key)
    else:
        assert tlang is None and jlang is None


def test_swin_v2_backbone_matches_jax():
    kw = dict(TRUNK, layer_scale=True)
    jm = jv2.SwinV2Backbone(image_size=(64, 96), **kw)
    images = _images(20)
    flat = random_params(abstract_params(jm, jnp.asarray(images)), seed=21)
    tm = tv2.SwinV2Backbone((64, 96), **kw)
    tm.load_state_dict(zoo_params_from_flax("swin", flat, tm))
    tm.eval()
    jouts = jax_apply(jm, flat, jnp.asarray(images))
    with torch.no_grad():
        touts = tm(torch.from_numpy(images))
    assert len(touts) == 4
    for i, (g, w) in enumerate(zip(touts, jouts)):
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4, f"tap {i}")


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_swin_vl_backbone_input_grads_match_jax(version):
    """The gradients of a weighted sum of every tap and the text with
    respect to the image and the text."""
    jm, flat, tm, images, t, mask = _trunk_pair(version, True, seed=30)
    rng = np.random.default_rng(31)
    tm_out, _ = tm(torch.zeros(1, 64, 96, 3), torch.zeros(1, LT, DT),
                   torch.ones(1, LT, dtype=torch.long))
    weights = [rng.standard_normal(o.shape[1:]).astype(np.float32)
               for o in tm_out]
    wt = rng.standard_normal((LT, DT)).astype(np.float32)

    def jloss(img, txt):
        outs, lang = jm.apply({"params": unflatten(flat)}, img, txt,
                              jnp.asarray(mask))
        s = sum((o * jnp.asarray(w).transpose(1, 2, 0)).sum()
                for o, w in zip(outs, weights))
        return s + (lang["hidden"] * wt).sum()

    with jax.ensure_compile_time_eval():
        gi, gt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(images), jnp.asarray(t))
    ti = torch.from_numpy(images).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    outs, lang = tm(ti, tt, torch.from_numpy(mask))
    s = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    (s + (lang["hidden"] * torch.from_numpy(wt)).sum()).backward()
    assert_close(ti.grad, gi, 1e-4, "image grad")
    assert_close(tt.grad, gt, 1e-4, "text grad")
