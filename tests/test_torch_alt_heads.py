"""The dense heads (RPN, RetinaNet, FCOS, plain ATSS) and their losses, the
RPN proposals, the FCOS assignment, the DETR set loss and box test-time
augmentation of `fiber_torch.detection` against `fiber_tpu`'s on the CPU in
fp32: heads, losses and parameter gradients within 1e-4, integer outputs
(samples from JAX's draws, FCOS assignments, the Hungarian permutation)
equal; the heads' flax parameters carried across by `utils/convert.py`
under the reference's `rpn.head.` names, and the fresh init drawn as
flax's (the class logits at the focal prior)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import alt_heads as jah
from fiber_tpu.detection import box_aug as jaug
from fiber_tpu.detection import set_loss as jset
from fiber_tpu.detection.anchors import fpn_anchors
from fiber_torch.detection import alt_heads as tah
from fiber_torch.detection import box_aug as taug
from fiber_torch.detection import set_loss as tset
from fiber_torch.detection.dyhead import VLDyHead
from fiber_torch.utils import convert
from torch_zoo_parity import abstract_params, random_params, unflatten

torch.set_num_threads(1)
HEAD_ATOL = 1e-4
FEAT_SIZES = ((8, 8), (4, 4))
STRIDES = (8, 16)
C_IN, B, NUM_CLASSES = 16, 2, 4


def close(got, want, atol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= atol * scale, f"{what}: {err} > {atol} x {scale}"


def t(x):
    return torch.from_numpy(np.array(x))


def flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def features(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, w, C_IN)).astype(np.float32)
            for h, w in FEAT_SIZES]


def gts():
    boxes = np.array([[[4., 4., 30., 30.], [10., 20., 60., 50.],
                       [33., 2., 63., 28.]],
                      [[8., 8., 40., 44.], [0., 0., 0., 0.],
                       [0., 0., 0., 0.]]], np.float32)
    labels = np.array([[1, 2, 4], [3, 0, 0]], np.int32)
    valid = np.array([[True, True, True], [True, False, False]])
    return boxes, labels, valid


def anchors():
    per_level = fpn_anchors(FEAT_SIZES, strides=STRIDES, sizes=(64, 128))
    return per_level, np.concatenate(per_level)


def jax_keys(rng, n):
    k1, k2 = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


HEAD_KW = {"RPN": {}, "RETINA": {}, "RETINA_GN": {"use_gn": True},
           "FCOS": {}, "ATSS": {}}


def build_pair(name, seed):
    """(JAX head, port head, the seeded flax parameters loaded into both)."""
    kind, kw = name.split("_")[0], HEAD_KW[name]
    jmod = jah.build_head(kind, channels=C_IN, num_classes=NUM_CLASSES,
                          num_levels=len(FEAT_SIZES), **kw)
    pmod = tah.build_head(kind, channels=C_IN, num_classes=NUM_CLASSES,
                          num_levels=len(FEAT_SIZES), device="cpu", **kw)
    jf = [jnp.asarray(f) for f in features()]
    params = random_params(abstract_params(jmod, jf), seed)
    pmod.load_state_dict(convert.dense_head_params_from_flax(params, pmod))
    return jmod, pmod, params


def losses(name, out, torch_side, rng):
    """The head's loss dict in either package on the shared inputs."""
    boxes, labels, valid = gts()
    per_level, all_anchors = anchors()
    kind = name.split("_")[0]
    if torch_side:
        A, g = t(all_anchors), (t(boxes), t(labels), t(valid))
        mod = tah
    else:
        A, g = jnp.asarray(all_anchors), tuple(jnp.asarray(a)
                                               for a in (boxes, labels, valid))
        mod = jah
    if kind == "RPN":
        if torch_side:
            keys = t(np.stack([jax_keys(r, len(all_anchors))
                               for r in jax.random.split(rng, B)]))
            return tah.rpn_loss(out, A, g[0], g[2], batch_per_image=32,
                                keys=keys)
        return jah.rpn_loss(out, A, g[0], g[2], rng, batch_per_image=32)
    if kind == "RETINA":
        return mod.retinanet_loss(out, A, *g, NUM_CLASSES)
    if kind == "FCOS":
        return mod.fcos_loss(out, FEAT_SIZES, *g, NUM_CLASSES,
                             strides=STRIDES)
    return mod.plain_atss_loss(out, A, [len(a) for a in per_level], *g,
                               NUM_CLASSES)


@pytest.mark.parametrize("name", sorted(HEAD_KW))
def test_head_outputs_losses_and_grads_match_jax(name):
    jmod, pmod, params = build_pair(name, seed=1)
    jf = [jnp.asarray(f) for f in features()]
    rng = jax.random.PRNGKey(2)

    def jloss(p):
        out = jmod.apply({"params": p}, jf)
        ls = losses(name, out, False, rng)
        return sum(ls.values()), (ls, out)

    (_, (jls, jout)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        unflatten(params))
    out = pmod([t(f.transpose(0, 3, 1, 2)) for f in features()])
    assert set(out) == set(jout)
    for k in out:
        for l, (a, b) in enumerate(zip(out[k], jout[k])):
            close(a, b, HEAD_ATOL, f"{k}[{l}]")
    ls = losses(name, out, True, rng)
    assert set(ls) == set(jls)
    for k in ls:
        close(ls[k], jls[k], HEAD_ATOL, k)
        assert np.isfinite(ls[k].item())
    sum(ls.values()).backward()
    want = convert.dense_head_params_from_flax(flat(jg), pmod)
    got = {k: p.grad for k, p in pmod.named_parameters()}
    assert set(want) == set(got)
    for k in want:
        close(got[k], want[k].numpy(), HEAD_ATOL, f"grad {k}")
    assert sum(float(g.abs().sum()) for g in got.values()) > 0


def test_rpn_proposals_match_jax():
    jmod, pmod, params = build_pair("RPN", seed=3)
    jf = [jnp.asarray(f) for f in features(4)]
    jout = jmod.apply({"params": unflatten(params)}, jf)
    per_level, _ = anchors()
    sizes = np.array([[64., 64.], [60., 50.]], np.float32)
    want = jah.rpn_proposals(jout, [jnp.asarray(a) for a in per_level],
                             jnp.asarray(sizes), pre_nms_top_n=40,
                             post_nms_top_n=12)
    with torch.no_grad():
        out = pmod([t(f.transpose(0, 3, 1, 2)) for f in features(4)])
        got = tah.rpn_proposals(out, [t(a) for a in per_level], t(sizes),
                                pre_nms_top_n=40, post_nms_top_n=12)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], HEAD_ATOL, "proposals")
    close(got[1], want[1], HEAD_ATOL, "scores")
    assert got[2].any() and float(got[0][1, :, 2].max()) <= 49.0


def test_fcos_assignment_equal():
    boxes, labels, valid = gts()
    # overlapping boxes of equal area: the tie goes to the first
    boxes[0, 2] = [4., 4., 30., 30.]
    locs = np.concatenate([np.asarray(l) for l in
                           jah.fcos_locations(FEAT_SIZES, STRIDES)])
    ranges = np.concatenate([np.broadcast_to(
        np.asarray(jah.FCOS_SIZE_RANGES[i], np.float32), (h * w, 2))
        for i, (h, w) in enumerate(FEAT_SIZES)])
    tl = tah.fcos_locations(FEAT_SIZES, STRIDES, device="cpu")
    close(torch.cat(tl), locs, 0.0, "locations")
    for b in range(B):
        want = jah.fcos_assign(jnp.asarray(locs), jnp.asarray(ranges),
                               jnp.asarray(boxes[b]), jnp.asarray(labels[b]),
                               jnp.asarray(valid[b]))
        got = tah.fcos_assign(t(locs), t(ranges), t(boxes[b]), t(labels[b]),
                              t(valid[b]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        close(got[1], want[1], 0.0, "ltrb")
        assert got[2].any()


def test_build_head_registry():
    for kind, cls in (("rpn", tah.RPNHead), ("Retina", tah.RetinaNetHead),
                      ("FCOS", tah.FCOSHead), ("atss", tah.PlainAtssHead)):
        head = tah.build_head(kind, 8, 3, device="cpu", norm_reg_targets=True,
                              unknown_option=1)
        assert isinstance(head, cls)
    # as in the JAX registry, VLDYHEAD takes its arguments from the keywords
    vl = tah.build_head("VLDYHEAD", 8, 3, num_convs=1, in_channels=16,
                        lang_dim=32, use_deform=False)
    assert isinstance(vl, VLDyHead) and len(vl.dyhead_tower) == 1
    with pytest.raises(KeyError):
        tah.build_head("YOLO", 8, 3)


@pytest.mark.parametrize("name", sorted(HEAD_KW))
def test_reference_names_and_fresh_init(name):
    """The reference's `rpn.head.` keys load into the head; a fresh head
    draws as flax's (lecun-normal std, zero biases but the class logits'
    focal prior, unit GroupNorm and scales)."""
    jmod, pmod, params = build_pair(name, seed=5)
    sd = convert.dense_head_params_from_flax(
        params, pmod, prefix=convert.DENSE_HEAD_PREFIX)
    names = {k[len("rpn.head."):] for k in sd}
    if name == "RPN":
        assert {"conv.weight", "cls_logits.bias", "bbox_pred.weight"} <= names
    else:
        step = 3 if name in ("RETINA_GN", "FCOS", "ATSS") else 2
        assert {f"cls_tower.{step * 3}.weight", f"bbox_tower.{step}.bias",
                "cls_logits.weight"} <= names
        if step == 3:
            assert "bbox_tower.4.weight" in names
    if name in ("FCOS", "ATSS"):
        assert {"scales.0.scale", "scales.1.scale", "centerness.bias"} <= names
    pmod.load_state_dict({k[len("rpn.head."):]: v for k, v in sd.items()},
                         strict=True)

    jf = [jnp.asarray(f) for f in features()]
    jp = flat(jmod.init(jax.random.PRNGKey(0), jf)["params"])
    j = convert.dense_head_params_from_flax(jp, pmod)
    fresh = tah.build_head(name.split("_")[0], channels=C_IN,
                           num_classes=NUM_CLASSES, num_levels=2,
                           device="cpu", seed=7, **HEAD_KW[name]).state_dict()
    for k, v in fresh.items():
        a, b = j[k].double().numpy(), v.double().numpy()
        if a.std() == 0:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)
        elif b.size >= 1024:
            assert abs(b.std() - a.std()) <= 0.1 * a.std(), k


# ---------------------------------------------------------------------
# the set loss
# ---------------------------------------------------------------------
def set_inputs(seed=0, Q=10, C=NUM_CLASSES, extra=0):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gts()
    logits = rng.standard_normal((B, Q, C + extra)).astype(np.float32)
    x1 = rng.uniform(0, 40, (B, Q, 1))
    y1 = rng.uniform(0, 40, (B, Q, 1))
    pred = np.concatenate([x1, y1, x1 + rng.uniform(4, 25, (B, Q, 1)),
                           y1 + rng.uniform(4, 25, (B, Q, 1))],
                          -1).astype(np.float32)
    return logits, pred, boxes, np.maximum(labels - 1, 0), valid


def test_hungarian_match_is_jax_permutation():
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 1, (3, 9, 4)).astype(np.float32)
    valid = np.array([[True] * 4, [True, True, False, False], [False] * 4])
    want = jset.hungarian_match(jnp.asarray(cost), jnp.asarray(valid))
    got = tset.hungarian_match(t(cost), t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[0].tolist())) == 4
    close(tset.generalized_box_iou_matrix(t(set_inputs()[1][0]),
                                          t(gts()[0][0])),
          jset.generalized_box_iou_matrix(jnp.asarray(set_inputs()[1][0]),
                                          jnp.asarray(gts()[0][0])),
          1e-5, "giou")


@pytest.mark.parametrize("use_focal", [True, False])
def test_set_criterion_and_grads_match_jax(use_focal):
    logits, pred, boxes, labels, valid = set_inputs(extra=0 if use_focal
                                                    else 1)
    sizes = np.array([[64., 64.], [60., 70.]], np.float32)
    kw = dict(num_classes=NUM_CLASSES, use_focal=use_focal)

    def jloss(lg, bx):
        out = jset.set_criterion(lg, bx, jnp.asarray(boxes),
                                 jnp.asarray(labels), jnp.asarray(valid),
                                 jnp.asarray(sizes), **kw)
        return sum(out.values()), out

    (_, jout), (jgl, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                             jnp.asarray(pred))
    lg, bx = t(logits).requires_grad_(True), t(pred).requires_grad_(True)
    out = tset.set_criterion(lg, bx, t(boxes), t(labels), t(valid), t(sizes),
                             **kw)
    for k in out:
        close(out[k], jout[k], HEAD_ATOL, k)
    sum(out.values()).backward()
    close(lg.grad, jgl, HEAD_ATOL, "logits grad")
    close(bx.grad, jgb, HEAD_ATOL, "boxes grad")


# ---------------------------------------------------------------------
# test-time augmentation
# ---------------------------------------------------------------------
def test_box_voting_and_host_nms_equal():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 60, (30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (30, 2))],
                           1).astype(np.float32)
    boxes[10:20] = boxes[:10] + rng.uniform(-2, 2, (10, 4))
    scores = rng.uniform(0, 1, 30).astype(np.float32)
    labels = rng.integers(1, 3, 30)
    for method in ("avg", "max"):
        for a, b in zip(taug.box_voting(boxes, scores, labels, 0.6, method),
                        jaug.box_voting(boxes, scores, labels, 0.6, method)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(taug._nms_host(boxes, scores, labels, 0.5),
                                  jaug._nms_host(boxes, scores, labels, 0.5))


def test_box_voting_keeps_a_zero_area_box_finite():
    """A zero-area box has IoU 0 with itself: JAX's cluster for it is
    empty and its merged box NaN.  The port puts each box in its own
    cluster, so the box comes back as it was."""
    boxes = np.array([[10., 10., 30., 30.], [59., 5., 59., 40.],
                      [11., 11., 31., 31.]], np.float32)
    scores = np.array([0.9, 0.7, 0.5], np.float32)
    labels = np.array([1, 1, 1])
    b, s, l = taug.box_voting(boxes, scores, labels, 0.6)
    assert np.isfinite(b).all() and len(b) == 2
    np.testing.assert_array_equal(b[1], boxes[1])
    assert s.tolist() == pytest.approx([0.7, 0.7])


def test_im_detect_bbox_aug_matches_jax():
    """The same detections through both: the scaled images within 1e-5 of
    `jax.image.resize`, the merged boxes, scores and labels equal."""
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 255, (40, 60, 3)).astype(np.float32)
    base = rng.uniform(0, 30, (6, 2))
    base = np.concatenate([base, base + rng.uniform(5, 25, (6, 2))], 1)
    seen = {"jax": [], "torch": []}

    def infer(tag):
        def fn(img, flipped):
            seen[tag].append(np.array(img))
            s = img.shape[0] / 40.0
            b = base * s + img.mean() * 1e-3
            if flipped:
                w = img.shape[1]
                b = np.stack([w - b[:, 2] - 1, b[:, 1], w - b[:, 0] - 1,
                              b[:, 3]], 1)
            return {"boxes": b, "scores": np.linspace(0.9, 0.4, 6),
                    "labels": np.array([1, 1, 2, 2, 3, 1])}
        return fn

    kw = dict(scales=(0.5, 0.75, 1.0), hflip=True, vote_thresh=0.6)
    want = jaug.im_detect_bbox_aug(infer("jax"), image, **kw)
    got = taug.im_detect_bbox_aug(infer("torch"), image, **kw)
    assert len(seen["torch"]) == len(seen["jax"]) == 6
    for a, b in zip(seen["torch"], seen["jax"]):
        close(a, b, 1e-5, "scaled image")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4,
                                   err_msg=k)


def test_detector_infer_fn_on_the_tiny_detector():
    """`detector_infer_fn` over the port's `detection_inference` (a tiny
    detector on the CPU): four passes at two scales with the flip, boxes
    finite and in the image's frame."""
    from fiber_torch.detection.detector import (DetectorConfig,
                                                GroundingDetector)
    cfg = DetectorConfig.tiny_test()
    model = GroundingDetector(cfg, device="cpu", seed=0)
    T = cfg.max_query_len
    ids = np.zeros((1, T), np.int64)
    ids[0, :5] = [0, 11, 12, 13, 2]
    mask = (ids != 0).astype(np.int64)
    mask[0, 0] = 1
    agg = np.zeros((2, T), np.float32)
    agg[0, 1], agg[1, 2:4] = 1.0, 0.5
    calls = []
    fn = taug.detector_infer_fn(model, ids, mask, agg, pre_nms_thresh=0.0)

    def counted(img, flipped):
        calls.append(img.shape)
        return fn(img, flipped)

    image = np.random.default_rng(4).uniform(0, 1, (64, 80, 3)).astype(
        np.float32)
    out = taug.im_detect_bbox_aug(counted, image, scales=(0.75, 1.0),
                                  max_detections=20)
    assert calls == [(48, 60, 3)] * 2 + [(64, 80, 3)] * 2
    assert 0 < len(out["boxes"]) <= 20
    assert np.isfinite(out["boxes"]).all()
    assert (out["boxes"][:, [0, 2]] >= -1).all()
    assert (out["boxes"][:, [0, 2]] <= 80).all()
    assert set(out["labels"].tolist()) <= {1, 2}
