"""FiberCoarse: the port against `fiber_tpu.models.fiber` at tiny dims on
the CPU, every head built, fusion gates non-zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_tpu.models.fiber import init_rank_from_itm as jax_init_rank
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse, init_rank_from_itm
from torch_parity import LOSSES, build_models, flatten, model_inputs, to_np

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jm, jv, tm, flat = build_models(seed=0)
    img, ids, masks = model_inputs(tm.cfg, 3, seed=1)
    jin = (jnp.asarray(img), jnp.asarray(ids, jnp.int32),
           jnp.asarray(masks, jnp.int32))
    tin = tuple(torch.from_numpy(a) for a in (img, ids, masks))
    jout = jax.jit(lambda v, *a: jm.apply(v, *a, method=JaxFiberCoarse.infer)
                   )(jv, *jin)
    with torch.inference_mode():
        tout = tm.infer(*tin)
    return dict(jm=jm, jv=jv, tm=tm, flat=flat, jin=jin, tin=tin, jout=jout,
                tout=tout)


@pytest.mark.parametrize("key", ["text_feats", "image_feats", "cls_feats"])
def test_infer_matches_jax(models, key):
    np.testing.assert_allclose(to_np(models["tout"][key]),
                               to_np(models["jout"][key]), atol=1e-4)


HEADS = {  # head -> (method of both models, the infer output it reads)
    "itm": ("itm_logits", "cls_feats"),
    "rank": ("rank_scores", "cls_feats"),
    "mlm": ("mlm_logits", "text_feats"),
    "vqa": ("vqa_logits", "cls_feats"),
    "nlvr2": ("nlvr2_logits", "cls_pair"),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_matches_jax(models, head):
    """Each head on its own model's infer output."""
    method, src = HEADS[head]

    def feats(out, cat):
        if src == "cls_pair":
            return cat([out["cls_feats"], out["cls_feats"]], -1)
        return out[src]

    ref = models["jm"].apply(models["jv"],
                             feats(models["jout"], jnp.concatenate),
                             method=getattr(JaxFiberCoarse, method))
    with torch.inference_mode():
        out = getattr(models["tm"], method)(feats(models["tout"], torch.cat))
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=1e-4)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_itc_tower_matches_jax(models, tower):
    jm, jv, tm = models["jm"], models["jv"], models["tm"]
    if tower == "image":
        ref = jm.apply(jv, models["jin"][0],
                       method=JaxFiberCoarse.encode_image_itc)
        with torch.inference_mode():
            out = tm.encode_image_itc(models["tin"][0])
    else:
        ref = jm.apply(jv, *models["jin"][1:],
                       method=JaxFiberCoarse.encode_text_itc)
        with torch.inference_mode():
            out = tm.encode_text_itc(*models["tin"][1:])
    for k in ref:
        np.testing.assert_allclose(to_np(out[k]), to_np(ref[k]), atol=1e-4)


def test_trunk_prefix_tail_equals_infer(models):
    tm, (img, ids, masks) = models["tm"], models["tin"]
    with torch.inference_mode():
        trunk = tm.encode_image_trunk(img)
        pre = tm.encode_text_pre(ids, masks)
        tail = tm.infer_fused_tail(trunk, pre, masks)
    for k, v in models["tout"].items():
        torch.testing.assert_close(tail[k], v, rtol=0, atol=0)


def test_init_rank_from_itm_matches_jax(models):
    params = jax_init_rank(jax.tree_util.tree_map(jnp.asarray,
                                                  models["jv"]["params"]))
    flat = flatten(params)
    cfg = models["tm"].cfg
    tm = FiberCoarse(cfg, device="cpu", seed=3)
    init_rank_from_itm(tm)
    torch.testing.assert_close(tm.rank_output.weight,
                               tm.itm_score.fc.weight[1:2], rtol=0, atol=0)
    tm.load_state_dict(models["tm"].state_dict())
    init_rank_from_itm(tm)
    np.testing.assert_array_equal(tm.rank_output.weight.detach().numpy(),
                                  flat["rank_output/kernel"].T)
    np.testing.assert_array_equal(tm.rank_output.bias.detach().numpy(),
                                  flat["rank_output/bias"])


def test_default_device_is_cuda():
    """The default device is the card; without CUDA, building raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the raise is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES))


def test_compute_dtype_cast_keeps_bias_tables_fp32():
    cfg = FiberConfig.tiny_test(loss_names=LOSSES,
                                compute_dtype=torch.bfloat16)
    tm = FiberCoarse(cfg, device="cpu").eval()
    for name, p in tm.named_parameters():
        want = (torch.float32 if name.endswith(
            ("relative_position_bias_table", "temp")) else torch.bfloat16)
        assert p.dtype == want, name
    img, ids, masks = model_inputs(cfg, 2, seed=2)
    with torch.inference_mode():
        out = tm.infer(*(torch.from_numpy(a) for a in (img, ids, masks)))
    assert out["cls_feats"].dtype == torch.bfloat16
    assert out["cls_feats"].shape == (2, 2 * cfg.hidden_size)
    assert torch.isfinite(out["cls_feats"].float()).all()


def test_same_seed_same_weights():
    cfg = FiberConfig.tiny_test(loss_names=LOSSES)
    a = FiberCoarse(cfg, device="cpu", seed=7).state_dict()
    b = FiberCoarse(cfg, device="cpu", seed=7).state_dict()
    c = FiberCoarse(cfg, device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
