"""GLIP-style early fusion against `fiber_tpu` on the CPU, fp32: VLFuse
of every fuse type, `BiAttentionBlock` with and without a text mask,
`make_coord_features`, the clamped BERT layer, `VLDyHead` with early
fusion (BERT and CLIP language layers, `clamp_bertattn` and
`use_fused_features_dot_product` on and off), and a `tiny_test` detector
with `early_fuse="mha-b"`: `detection_inference`, `detection_loss` and
its gradients, one `DetectionTrainer` step against JAX's optax update,
and the optimizer groups against JAX's `_det_param_group`.

The JAX modules' parameters are seeded numpy values
(`torch_zoo_parity.random_params`) carried to the port by
`fiber_torch.utils.convert`; the detector's come from the port's seeded
fill, carried to JAX by the JAX package's converter and, for the
early-fusion tower, the port's `detection_flax_path`."""

import types

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiber_tpu.detection import detector as jdet
from fiber_tpu.detection import dyhead as jdyhead
from fiber_tpu.detection import vlfuse as jvl
from fiber_tpu.detection.postprocess import atss_postprocess as jax_pp
from fiber_tpu.models import roberta as jroberta
from fiber_tpu.train import detection_trainer as jtrain
from fiber_torch.detection import detector as tdet
from fiber_torch.detection import dyhead as tdyhead
from fiber_torch.detection import vlfuse as tvl
from fiber_torch.detection.postprocess import label_to_token_matrix
from fiber_torch.models import roberta as troberta
from fiber_torch.models.layers import Dropout
from fiber_torch.train import detection_trainer as ttrain
from fiber_torch.utils import convert
from torch_detection_parity import (HEAD_KEYS, configs, fill, flatten,
                                    inputs, rel_err, to_flax_all, unflatten)
from torch_zoo_parity import (abstract_params, assert_close, feats_nhwc,
                              jax_apply, nchw, nhwc, random_params, text)

torch.set_num_threads(1)
B, C, L, T = 2, 16, 32, 8
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
# the head's levels: GroupNorm takes 16 groups, so 32 channels and maps
# down to 1 x 2 give each group 4 or more values (a group of two values
# normalises them to +-1, which lifts fp32 rounding past 1e-5)
HEAD_C = 32
HEAD_SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


def _lang(hidden, mask, torch_side):
    if torch_side:
        return {"hidden": torch.from_numpy(hidden),
                "masks": None if mask is None else torch.from_numpy(mask)}
    return {"hidden": jnp.asarray(hidden),
            "masks": None if mask is None else jnp.asarray(mask)}


@pytest.mark.parametrize("fuse_type", tvl.FUSE_TYPES)
def test_vlfuse_matches_jax(fuse_type):
    feats = feats_nhwc(B, C, SIZES, seed=0)
    hidden, mask = text(B, T, L, seed=1)
    jm = jvl.VLFuse(v_dim=C, l_dim=L, embed_dim=64, num_heads=4,
                    fuse_type=fuse_type)
    jfeats = [jnp.asarray(f) for f in feats]
    tm = tvl.VLFuse(v_dim=C, l_dim=L, embed_dim=64, num_heads=4,
                    fuse_type=fuse_type)
    if fuse_type == "NONE":
        flat = {}
    else:
        flat = random_params(abstract_params(
            jm, jfeats, _lang(hidden, mask, False)), seed=2)
    tm.load_state_dict(convert.vlfuse_params_from_flax(flat, tm))
    jout, jlang = jax_apply(jm, flat, jfeats, _lang(hidden, mask, False))
    with torch.no_grad():
        tout, tlang = tm([nchw(f) for f in feats], _lang(hidden, mask, True))
    for lvl, (t, j) in enumerate(zip(tout, jout)):
        assert_close(nhwc(t), j, 1e-5, f"{fuse_type} level {lvl}")
    assert_close(tlang["hidden"], jlang["hidden"], 1e-5, "hidden")
    if fuse_type == "MHA-B":      # the text is updated
        assert float(np.abs(np.asarray(jlang["hidden"]) - hidden).max()) > 0


@pytest.mark.parametrize("masked", [True, False])
def test_bi_attention_block_matches_jax(masked):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((B, 40, C)).astype(np.float32)
    hidden, mask = text(B, T, L, seed=4)
    mask = mask if masked else None
    jm = jvl.BiAttentionBlock(v_dim=C, l_dim=L, embed_dim=64, num_heads=4)
    args = (jnp.asarray(v), jnp.asarray(hidden),
            None if mask is None else jnp.asarray(mask))
    flat = random_params(abstract_params(jm, *args), seed=5)
    tm = tvl.BiAttentionBlock(C, L, 64, 4)
    tm.load_state_dict(convert.vlfuse_params_from_flax(flat, tm))
    jv, jl = jax_apply(jm, flat, *args)
    with torch.no_grad():
        tv, tl = tm(torch.from_numpy(v), torch.from_numpy(hidden),
                    None if mask is None else torch.from_numpy(mask))
    assert_close(tv, jv, 1e-5, "v")
    assert_close(tl, jl, 1e-5, "l")


def test_make_coord_features_matches_jax():
    for (H, W) in ((5, 7), (1, 1), (4, 4)):
        want = np.asarray(jvl.make_coord_features(2, H, W))
        got = nhwc(tvl.make_coord_features(2, H, W))
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("clamp", [None, 50000.0])
def test_roberta_layer_score_clamp_matches_jax(clamp):
    """Scores beyond the clamp (query weights scaled up): the clamped layer
    agrees with JAX's and differs from the unclamped one."""
    x, mask = text(B, T, L, seed=6)
    ext = np.asarray(jroberta.extended_attention_mask(jnp.asarray(mask)))
    jm = jroberta.RobertaLayer(hidden_size=L, num_heads=2,
                               intermediate_size=4 * L, score_clamp=clamp)
    flat = random_params(abstract_params(jm, jnp.asarray(x)), seed=7)
    for k in list(flat):
        if "/query/" in k or "/key/" in k:
            flat[k] = flat[k] * 2000.0
    tm = troberta.RobertaLayer(L, 2, 4 * L, attn_drop=0.0, hidden_drop=0.0,
                               score_clamp=clamp)
    tm.load_state_dict(convert.lang_layer_params_from_flax(flat, tm))
    want = jax_apply(jm, flat, jnp.asarray(x), attn_mask=jnp.asarray(ext))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(ext))
    assert_close(got, want, 1e-5, "layer")
    if clamp is not None:
        loose = jroberta.RobertaLayer(hidden_size=L, num_heads=2,
                                      intermediate_size=4 * L)
        other = jax_apply(loose, flat, jnp.asarray(x),
                          attn_mask=jnp.asarray(ext))
        assert float(np.abs(np.asarray(other) - np.asarray(want)).max()) > 1e-3


def _head_cfg(**kw):
    return dict(num_convs=2, in_channels=HEAD_C, channels=HEAD_C, lang_dim=L,
                num_text_heads=2, use_deform=False, early_fuse="mha-b", **kw)


def head_params_to_port(flat, **kw):
    """A JAX VLDyHead's flat parameters -> the port head's state_dict,
    through the detector's mapping under `rpn/`."""
    cfg = types.SimpleNamespace(use_deform=kw.get("use_deform", False),
                                early_fuse="mha-b")
    sd = convert.detection_params_from_flax(
        {f"rpn/{k}": v for k, v in flat.items()}, cfg)
    return {k[len("rpn.head."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("lang_model,clamp,fused_dot", [
    ("bert", False, False), ("bert", True, True), ("clip", False, False),
    ("clip", False, True)])
def test_early_fusion_head_matches_jax(lang_model, clamp, fused_dot):
    opts = dict(lang_model=lang_model, clamp_bertattn=clamp,
                use_fused_features_dot_product=fused_dot)
    feats = feats_nhwc(B, HEAD_C, HEAD_SIZES, seed=8)
    hidden, mask = text(B, T, L, seed=9)
    emb = (hidden * mask[..., None]).astype(np.float32)
    jm = jdyhead.VLDyHead(max_query_len=T, **_head_cfg(**opts))
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(emb))
    flat = random_params(abstract_params(jm, *args,
                                         lang_mask=jnp.asarray(mask)),
                         seed=10)
    tm = tdyhead.VLDyHead(max_query_len=T, **_head_cfg(**opts))
    tm.load_state_dict(head_params_to_port(flat), strict=True)
    tm.eval()
    # the reference's interleaved tower: VLFuse, language layer, DyConv
    kinds = [type(m).__name__ for m in tm.dyhead_tower]
    last_lang = ("CLIPTransformerLayer" if lang_model == "clip"
                 else "RobertaLayer") if fused_dot else "DummyLayer"
    assert kinds[3:] == ["VLFuse", last_lang, "DyConv"]
    assert kinds[0] == "VLFuse" and kinds[2] == "DyConv"
    jout = jax_apply(jm, flat, *args, lang_mask=jnp.asarray(mask))
    with torch.no_grad():
        tout = tm([nchw(f) for f in feats], torch.from_numpy(emb),
                  lang_mask=torch.from_numpy(mask))
    for key in HEAD_KEYS:
        for lvl, (t, j) in enumerate(zip(tout[key], jout[key])):
            assert_close(t, j, 1e-5, f"{key}[{lvl}]")


def test_head_without_early_fusion_keeps_its_names():
    tm = tdyhead.VLDyHead(num_convs=3, in_channels=C, channels=C,
                          lang_dim=L, use_deform=False)
    assert [type(m).__name__ for m in tm.dyhead_tower] == ["DyConv"] * 3
    with pytest.raises(ValueError):
        tdyhead.VLDyHead(early_fuse="mha-s")


# ---------------------------------------------------------------- detector
EARLY = dict(early_fuse="mha-b")
PP = dict(pre_nms_top_n=100, post_nms_top_n=20)


def no_dropout(model) -> None:
    """The backbone's text dropout draws from generators the two packages
    do not share: off in both (JAX's by a patch of flax's Dropout)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
LR, WD, CLIP = 1e-4, 1e-4, 1.0


def to_flax_early(sd, cfg):
    """A port detector's state_dict -> the JAX tree: the early-fusion tower
    through `detection_flax_path` (Linear weights transposed, conv kernels
    OIHW -> HWIO, the level attention's conv -> its (C, 1) Dense), the rest
    through `to_flax_all`."""
    tower = {k: v for k, v in sd.items()
             if k.startswith("rpn.head.dyhead_tower.")}
    flat = to_flax_all({k: v for k, v in sd.items() if k not in tower}, cfg)
    for k, v in tower.items():
        path = convert.detection_flax_path(k, cfg.use_deform, cfg.early_fuse)
        v = v.numpy()
        if path.endswith("attn_conv/kernel"):
            v = v.reshape(1, -1).T
        elif path.endswith("/kernel"):
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        flat[path] = v
    return flat


def det_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = inputs(cfg, 2, seed)
    H, W = cfg.image_size
    G, T = 3, cfg.max_query_len
    xy = rng.uniform(0, min(H, W) - 30, (2, G, 2))
    wh = rng.uniform(12, 28, (2, G, 2))
    b["gt_boxes"] = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b["gt_valid"] = np.ones((2, G), bool)
    pm = np.zeros((2, G, T), np.float32)
    for i in range(2):
        for g in range(G):
            pm[i, g, rng.integers(1, T // 2 - 1, 2)] = 1.0
    b["positive_map"] = pm
    return b


@pytest.fixture(scope="module")
def detector():
    """The JAX and the port's `tiny_test` detectors with early fusion on
    the same parameters; JAX's loss, grads and one optax update."""
    jcfg, tcfg = configs(**EARLY)
    tmodel = tdet.GroundingDetector(tcfg, device="cpu")
    sd = fill(tmodel, 0)
    tmodel.load_state_dict(sd, strict=True)
    flat = to_flax_early(sd, tcfg)
    jmodel = jdet.GroundingDetector(jcfg)
    H, W = jcfg.image_size
    T = jcfg.max_query_len
    abstract = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.ones((1, T), jnp.int32), jnp.ones((1, T), jnp.int32))["params"]
    params = unflatten(flat)
    batch = det_batch(tcfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)

        def loss_fn(p):
            losses = jdet.detection_loss(jmodel, {"params": p}, jb,
                                         train=True)
            return losses["total_loss"], losses

        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    fwd = jax.jit(lambda v, img, ids, mask: jmodel.apply(v, img, ids, mask))
    jout = fwd({"params": params}, jb["images"], jb["input_ids"],
               jb["attention_mask"])
    # the JAX model as `detection_inference` calls it, through the jitted
    # apply
    shim = types.SimpleNamespace(
        cfg=jcfg, apply=lambda v, img, ids, mask, deterministic=True: fwd(
            v, img, ids, mask))
    tx = jtrain.make_detection_optimizer(LR, LR, WD, 100, params,
                                         warmup_iters=0, clip_norm=CLIP)
    update = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))
    new_params = update(jgrads, params)
    return dict(jcfg=jcfg, tcfg=tcfg, tmodel=tmodel, sd=sd, flat=flat,
                abstract=abstract, jmodel=jmodel, shim=shim, params=params,
                batch=batch, jlosses=jlosses, jgrads=jgrads, jout=jout,
                new_params=new_params)


def test_detector_tree_matches_jax(detector):
    """The port's early-fusion detector carried to JAX fills exactly JAX's
    own parameter tree (names and shapes)."""
    want = {k: tuple(v.shape) for k, v in flax.traverse_util.flatten_dict(
        detector["abstract"], sep="/").items()}
    got = {k: tuple(v.shape) for k, v in detector["flat"].items()}
    assert got == want


def test_detector_forward_matches_jax(detector):
    b = detector["batch"]
    with torch.no_grad():
        tout = detector["tmodel"](torch.from_numpy(b["images"]),
                                  torch.from_numpy(b["input_ids"]).long(),
                                  torch.from_numpy(b["attention_mask"]).long())
    jout = detector["jout"]
    for key in HEAD_KEYS:
        for lvl, (j, t) in enumerate(zip(jout["head_out"][key],
                                         tout["head_out"][key])):
            assert_close(t, j, 1e-4, f"{key}[{lvl}]")


def test_detection_inference_matches_jax(detector, monkeypatch):
    """Every slot of boxes, scores, labels and valid."""
    monkeypatch.setattr(jdet, "atss_postprocess", jax.jit(
        jax_pp, static_argnames=("pre_nms_thresh", "pre_nms_top_n",
                                 "nms_thresh", "post_nms_top_n", "min_size")))
    b = detector["batch"]
    agg = label_to_token_matrix({1: [1, 2], 2: [4], 3: [6, 7]}, 3,
                                detector["tcfg"].max_query_len)
    want = jdet.detection_inference(detector["shim"],
                                    {"params": detector["params"]}, b, agg,
                                    **PP)
    got = tdet.detection_inference(detector["tmodel"], b, agg, **PP)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert rel_err(got.boxes, want.boxes) <= 1e-4
    assert rel_err(got.scores, want.scores) <= 1e-4


@pytest.fixture(scope="module")
def port_loss(detector):
    tcfg = detector["tcfg"]
    model = tdet.GroundingDetector(tcfg, device="cpu", for_training=True)
    model.load_state_dict(detector["sd"], strict=True)
    no_dropout(model)
    losses = tdet.detection_loss(model, detector["batch"], train=True)
    losses["total_loss"].backward()
    return losses, {n: p.grad.detach().clone()
                    for n, p in model.named_parameters()}


def test_detection_loss_matches_jax(detector, port_loss):
    losses, _ = port_loss
    want = detector["jlosses"]
    assert set(losses) == set(want)
    for k in want:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, err_msg=k)


def test_detection_loss_grads_match_jax(detector, port_loss):
    _, grads = port_loss
    want = convert.detection_params_from_flax(flatten(detector["jgrads"]),
                                              detector["tcfg"])
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   atol=1e-4, err_msg=k)
    # the early-fusion modules get gradients
    assert float(grads["rpn.head.dyhead_tower.0.b_attn.gamma_v"]
                 .abs().max()) > 0
    assert float(grads["rpn.head.dyhead_tower.1.attention.self.query.weight"]
                 .abs().max()) > 0


def test_train_step_matches_jax(detector):
    tcfg = detector["tcfg"]
    tr = ttrain.DetectionTrainer(tcfg, device="cpu", base_lr=LR, lang_lr=LR,
                                 weight_decay=WD, max_iter=100,
                                 ema_decay=None, clip_norm=CLIP,
                                 warmup_iters=0)
    tr.model.load_state_dict(detector["sd"], strict=True)
    no_dropout(tr.model)
    m = tr.train_step(detector["batch"])
    np.testing.assert_allclose(m["total_loss"].numpy(),
                               np.asarray(detector["jlosses"]["total_loss"]),
                               atol=1e-4)
    want = convert.detection_params_from_flax(
        flatten(detector["new_params"]), tcfg)
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("lang_model", ["bert", "clip"])
def test_param_groups_match_jax(lang_model):
    """Each group's element count equals JAX's `_det_param_group` over its
    own tree, and each early-fusion parameter's group is the one JAX gives
    its flax path."""
    jcfg, tcfg = configs(lang_model=lang_model, **EARLY)
    H, W = jcfg.image_size
    T = jcfg.max_query_len
    abstract = jax.eval_shape(
        jdet.GroundingDetector(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, H, W, 3)), jnp.ones((1, T), jnp.int32),
        jnp.ones((1, T), jnp.int32))["params"]
    labels = jax.tree_util.tree_map_with_path(jtrain._det_param_group,
                                              abstract)
    want = {}
    for lab, leaf in zip(jax.tree_util.tree_leaves(labels),
                         jax.tree_util.tree_leaves(abstract)):
        want[lab] = want.get(lab, 0) + int(np.prod(leaf.shape))
    model = tdet.GroundingDetector(tcfg, device="cpu", for_training=True)
    opt = ttrain.make_detection_optimizer(model, 1e-4, 2e-5, 1e-4)
    got = {g["name"]: sum(p.numel() for p in g["params"])
           for g in opt.param_groups}
    assert got == want
    flat_labels = flax.traverse_util.flatten_dict(labels, sep="/")
    for name, _ in model.named_parameters():
        if ".dyhead_tower." in name:
            path = convert.detection_flax_path(name, tcfg.use_deform,
                                               tcfg.early_fuse)
            if path.endswith("rpn/scales"):
                continue
            assert ttrain.det_param_group(name, tcfg.use_deform,
                                          tcfg.early_fuse) == \
                flat_labels[path], name
