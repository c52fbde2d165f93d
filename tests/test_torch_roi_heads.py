"""The ROI heads of `fiber_torch.detection.roi_heads` against `fiber_tpu`'s
on the CPU in fp32: FPN level assignment, multi-level ROIAlign (the
detector's strides 8 ... 128 and the default 4 ... 32), proposal sampling
on JAX's draws, the box, mask and keypoint heads with their losses and
parameter gradients (within 1e-4), box inference, the heatmap decode;
every head's flax parameters carried across by `utils/convert.py` under
the reference's key names, and the fresh init drawn as flax draws it.

The JAX heads' parameters are seeded numpy values
(`torch_zoo_parity.random_params` over `jax.eval_shape`)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import roi_heads as jrh
from fiber_tpu.detection.structures import Keypoints as JaxKeypoints
from fiber_torch.detection import roi_heads as trh
from fiber_torch.detection.structures import Keypoints
from fiber_torch.utils import convert
from torch_zoo_parity import abstract_params, random_params, unflatten

torch.set_num_threads(1)
OP_ATOL, HEAD_ATOL = 1e-5, 1e-4
C_IN, IMG = 16, 96


def close(got, want, atol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= atol * scale, f"{what}: {err} > {atol} x {scale}"


def t(x):
    return torch.from_numpy(np.array(x))


def features(strides, seed=0, C=C_IN):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((-(-IMG // s), -(-IMG // s), C))
            .astype(np.float32) for s in strides]


def random_boxes(rng, R, lo=1.0, hi=90.0):
    x1 = rng.uniform(-4, IMG - 8, R)
    y1 = rng.uniform(-4, IMG - 8, R)
    w = np.exp(rng.uniform(np.log(lo), np.log(hi), R))
    h = np.exp(rng.uniform(np.log(lo), np.log(hi), R))
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


def jax_keys(rng, n):
    k1, k2 = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


def port_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


def flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def head_pair(jmod, pmod, args, seed):
    """Seeded numpy parameters for the JAX head, loaded into the port's."""
    p = random_params(abstract_params(jmod, *args), seed)
    pmod.load_state_dict(convert.roi_head_params_from_flax(p, pmod))
    return p


def check_grads(jgrads, pmod, atol=HEAD_ATOL):
    want = convert.roi_head_params_from_flax(flat(jgrads), pmod)
    got = port_grads(pmod)
    assert set(want) == set(got)
    for k in want:
        close(got[k], want[k].numpy(), atol, k)


# ---------------------------------------------------------------------
# level assignment and multi-level pooling
# ---------------------------------------------------------------------
def test_assign_fpn_level_matches_jax():
    boxes = random_boxes(np.random.default_rng(0), 200, 0.5, 900.0)
    for k_min, k_max in ((2, 5), (3, 7)):
        want = jrh.assign_fpn_level(jnp.asarray(boxes), k_min, k_max)
        got = trh.assign_fpn_level(t(boxes), k_min, k_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(np.unique(got.numpy())) >= 3


@pytest.mark.parametrize("strides", [(4, 8, 16, 32), (8, 16, 32, 64, 128)])
def test_multilevel_roi_align_and_grads_match_jax(strides):
    feats = features(strides)
    boxes = random_boxes(np.random.default_rng(1), 40, 4.0, 600.0)
    g = np.random.default_rng(2).standard_normal((40, 7, 7, C_IN)).astype(
        np.float32)
    fn = lambda fs: (jrh.multilevel_roi_align(fs, jnp.asarray(boxes), 7,
                                              strides=strides) * g).sum()
    jf = [jnp.asarray(f) for f in feats]
    want = jrh.multilevel_roi_align(jf, jnp.asarray(boxes), 7, strides=strides)
    want_g = jax.grad(fn)(jf)
    tf = [t(f.transpose(2, 0, 1)).requires_grad_(True) for f in feats]
    got = trh.multilevel_roi_align(tf, t(boxes), 7, strides=strides)
    close(got.permute(0, 2, 3, 1), want, OP_ATOL, "pooled")
    (got * t(g.transpose(0, 3, 1, 2))).sum().backward()
    for l, (a, b) in enumerate(zip(tf, want_g)):
        close(a.grad.permute(1, 2, 0), b, OP_ATOL, f"level {l} grad")


# ---------------------------------------------------------------------
# the box head
# ---------------------------------------------------------------------
def proposals_and_gt(seed=3, R=30):
    rng = np.random.default_rng(seed)
    props = random_boxes(rng, R, 6.0, 60.0)
    prop_valid = np.ones(R, bool)
    prop_valid[-3:] = False
    gt = np.array([[4., 4., 30., 30.], [20., 10., 50., 44.],
                   [60., 50., 90., 80.], [0., 0., 0., 0.]], np.float32)
    labels = np.array([1, 3, 2, 0], np.int32)
    valid = np.array([True, True, True, False])
    return props, prop_valid, gt, labels, valid


def test_sample_proposals_on_jax_draws():
    props, pv, gt, lab, gv = proposals_and_gt()
    rng = jax.random.PRNGKey(2)
    want = jrh.sample_proposals(*(jnp.asarray(a) for a in
                                  (props, pv, gt, lab, gv)), rng,
                                batch_size=16)
    got = trh.sample_proposals(t(props), t(pv), t(gt), t(lab), t(gv),
                               batch_size=16,
                               keys=t(jax_keys(rng, len(props) + len(gt))))
    for k in ("selected", "pos", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    close(got["boxes"], want["boxes"], 0.0, "boxes")
    close(got["reg_targets"], want["reg_targets"], OP_ATOL, "reg_targets")
    assert bool(got["pos"].any()) and int(got["selected"].sum()) == 16
    pos = got["pos"]
    assert torch.equal(t(lab).long()[got["matched_gt"]][pos],
                       got["labels"][pos])


@pytest.mark.parametrize("agnostic", [False, True])
def test_box_head_loss_grads_and_inference_match_jax(agnostic):
    props, pv, gt, lab, gv = proposals_and_gt()
    rng = jax.random.PRNGKey(4)
    s = jrh.sample_proposals(*(jnp.asarray(a) for a in
                               (props, pv, gt, lab, gv)), rng, batch_size=16)
    strides = (4, 8, 16, 32)
    feats = features(strides, seed=5)
    pooled = jrh.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                      s["boxes"], 7, strides=strides)
    num_classes = 5
    jmod = jrh.BoxHead(num_classes=num_classes, representation_size=64,
                       class_agnostic_reg=agnostic)
    pmod = trh.BoxHead(C_IN, num_classes, representation_size=64,
                       class_agnostic_reg=agnostic, device="cpu")
    params = head_pair(jmod, pmod, (pooled,), seed=6)

    def jloss(p):
        cls, reg = jmod.apply({"params": p}, pooled)
        out = jrh.box_head_loss(cls, reg, s["labels"], s["reg_targets"],
                                s["selected"], s["pos"], agnostic)
        return out["loss_classifier"] + out["loss_box_reg"], (out, cls, reg)

    (_, (jout, jcls, jreg)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(unflatten(params))
    tpooled = t(np.asarray(pooled).transpose(0, 3, 1, 2))
    cls, reg = pmod(tpooled)
    close(cls, jcls, HEAD_ATOL, "cls")
    close(reg, jreg, HEAD_ATOL, "reg")
    ts = {k: t(np.asarray(v)) for k, v in s.items()}
    out = trh.box_head_loss(cls, reg, ts["labels"].long(), ts["reg_targets"],
                            ts["selected"], ts["pos"], agnostic)
    for k in out:
        close(out[k], jout[k], HEAD_ATOL, k)
    sum(out.values()).backward()
    check_grads(jg, pmod)

    size = np.array([IMG, IMG - 10], np.float32)
    want = jrh.box_head_inference(jcls, jreg, s["boxes"],
                                  jnp.asarray(np.arange(len(cls)) % 7 > 0),
                                  jnp.asarray(size), num_classes,
                                  score_thresh=0.1, max_detections=12,
                                  class_agnostic_reg=agnostic)
    with torch.no_grad():
        got = trh.box_head_inference(cls, reg, ts["boxes"],
                                     t(np.arange(len(cls)) % 7 > 0), t(size),
                                     num_classes, score_thresh=0.1,
                                     max_detections=12,
                                     class_agnostic_reg=agnostic)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ok = got[3].numpy()
    assert ok.any()
    np.testing.assert_array_equal(got[2].numpy()[ok], np.asarray(want[2])[ok])
    close(got[0][ok], np.asarray(want[0])[ok], HEAD_ATOL, "boxes")
    close(got[1], want[1], HEAD_ATOL, "scores")


# ---------------------------------------------------------------------
# the mask and keypoint heads
# ---------------------------------------------------------------------
@pytest.mark.parametrize("P", [7, 6])
def test_mask_head_loss_and_grads_match_jax(P):
    """Odd and even pools through the 2x2 stride-2 transposed conv."""
    rng = np.random.default_rng(7)
    R, K = 6, 3
    pooled = rng.standard_normal((R, P, P, C_IN)).astype(np.float32)
    targets = (rng.uniform(0, 1, (R, 2 * P, 2 * P)) > 0.5).astype(np.float32)
    labels = np.array([1, 2, 3, 0, 2, 1], np.int32)
    pos = np.array([True, True, True, False, True, False])
    jmod = jrh.MaskHead(num_classes=K, channels=8, n_convs=2)
    pmod = trh.MaskHead(C_IN, K, channels=8, n_convs=2, device="cpu")
    params = head_pair(jmod, pmod, (jnp.asarray(pooled),), seed=8)

    def jloss(p):
        lg = jmod.apply({"params": p}, jnp.asarray(pooled))
        return jrh.mask_head_loss(lg, jnp.asarray(targets),
                                  jnp.asarray(labels), jnp.asarray(pos)), lg

    (jl, jlg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        unflatten(params))
    lg = pmod(t(pooled.transpose(0, 3, 1, 2)))
    close(lg.permute(0, 2, 3, 1), jlg, HEAD_ATOL, "mask logits")
    loss = trh.mask_head_loss(lg, t(targets), t(labels), t(pos))
    close(loss, jl, HEAD_ATOL, "mask loss")
    loss.backward()
    check_grads(jg, pmod)


@pytest.mark.parametrize("P", [7, 5])
def test_keypoint_head_loss_grads_and_decode_match_jax(P):
    """Odd pools through the 4x4 stride-2 "SAME" transposed conv and the
    2x upsample."""
    rng = np.random.default_rng(9)
    R, K = 4, 5
    pooled = rng.standard_normal((R, P, P, C_IN)).astype(np.float32)
    boxes = np.array([[0., 0., 60., 40.], [10., 5., 30., 45.],
                      [5., 5., 50., 30.], [20., 10., 80., 90.]], np.float32)
    kps = np.zeros((R, K, 3), np.float32)
    kps[..., 0] = rng.uniform(-5, 85, (R, K))
    kps[..., 1] = rng.uniform(-5, 95, (R, K))
    kps[..., 2] = rng.integers(0, 3, (R, K))
    valid = np.array([True, True, False, True])
    pos = np.array([True, False, True, True])
    HM = 4 * P
    jb, jv = JaxKeypoints(jnp.asarray(kps), jnp.asarray(valid)) \
        .to_heatmap_targets(jnp.asarray(boxes), HM)
    tb, tv = Keypoints(t(kps), t(valid)).to_heatmap_targets(t(boxes), HM)
    jmod = jrh.KeypointHead(num_keypoints=K, channels=8, n_convs=2)
    pmod = trh.KeypointHead(C_IN, K, channels=8, n_convs=2, device="cpu")
    params = head_pair(jmod, pmod, (jnp.asarray(pooled),), seed=10)

    def jloss(p):
        lg = jmod.apply({"params": p}, jnp.asarray(pooled))
        return jrh.keypoint_head_loss(lg, jb, jv, jnp.asarray(pos)), lg

    (jl, jlg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        unflatten(params))
    lg = pmod(t(pooled.transpose(0, 3, 1, 2)))
    assert lg.shape == (R, K, HM, HM)
    close(lg.permute(0, 2, 3, 1), jlg, HEAD_ATOL, "heatmaps")
    loss = trh.keypoint_head_loss(lg, tb, tv, t(pos))
    close(loss, jl, HEAD_ATOL, "keypoint loss")
    loss.backward()
    check_grads(jg, pmod)

    jk, js = jrh.heatmaps_to_keypoints(jlg, jnp.asarray(boxes))
    tk, ts = trh.heatmaps_to_keypoints(lg.detach(), t(boxes))
    close(tk, jk, HEAD_ATOL, "keypoints")
    close(ts, js, HEAD_ATOL, "scores")


def test_heatmap_decode_ties_take_the_first_peak():
    lg = np.full((2, 3, 8, 8), -1.0, np.float32)
    lg[:, :, 2, 5] = lg[:, :, 6, 1] = 4.0
    boxes = np.array([[0., 0., 16., 16.], [8., 8., 8.5, 40.]], np.float32)
    jk, _ = jrh.heatmaps_to_keypoints(jnp.asarray(lg.transpose(0, 2, 3, 1)),
                                      jnp.asarray(boxes))
    tk, _ = trh.heatmaps_to_keypoints(t(lg), t(boxes))
    close(tk, jk, 0.0, "tied peaks")


# ---------------------------------------------------------------------
# the reference's key names and the fresh init
# ---------------------------------------------------------------------
ROI_HEADS = {
    "box": (lambda: jrh.BoxHead(num_classes=81, representation_size=32),
            lambda: trh.BoxHead(C_IN, 81, representation_size=32,
                                device="cpu"), 7,
            ["feature_extractor.fc6.weight", "predictor.cls_score.bias",
             "predictor.bbox_pred.weight"]),
    "mask": (lambda: jrh.MaskHead(num_classes=80, channels=16),
             lambda: trh.MaskHead(C_IN, 80, channels=16, device="cpu"), 14,
             [f"feature_extractor.mask_fcn{i}.weight" for i in range(1, 5)]
             + ["predictor.conv5_mask.weight",
                "predictor.mask_fcn_logits.bias"]),
    "keypoint": (lambda: jrh.KeypointHead(channels=16),
                 lambda: trh.KeypointHead(C_IN, channels=16, device="cpu"),
                 14, [f"feature_extractor.conv_fcn{i}.weight"
                      for i in range(1, 9)]
                 + ["predictor.kps_score_lowres.weight"]),
}


@pytest.mark.parametrize("kind", sorted(ROI_HEADS))
def test_reference_names_load_into_each_head(kind):
    jmake, pmake, P, names = ROI_HEADS[kind]
    pooled = jnp.zeros((2, P, P, C_IN))
    params = random_params(abstract_params(jmake(), pooled), 11)
    prefix = convert.ROI_HEAD_PREFIX[kind]
    sd = convert.roi_head_params_from_flax(params, pmake(), prefix=prefix)
    assert all(k.startswith(prefix) for k in sd)
    for n in names:
        assert prefix + n in sd, n
    head = pmake()
    head.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    with pytest.raises(ValueError, match="mismatch"):
        convert.roi_head_params_from_flax(
            {k: v for k, v in params.items() if "fc6" not in k
             and "fcn1" not in k}, pmake())


@pytest.mark.parametrize("kind", sorted(ROI_HEADS))
def test_fresh_init_draws_as_flax(kind):
    """Every weight of 1024 or more values shares flax's init std (within
    10%) and a zero-centred mean; biases zero."""
    jmake, pmake, P, _ = ROI_HEADS[kind]
    pooled = jnp.zeros((1, P, P, C_IN))
    jp = jmake().init(jax.random.PRNGKey(0), pooled)["params"]
    j = convert.roi_head_params_from_flax(flat(jp), pmake())
    p = pmake().state_dict()
    checked = 0
    for k, v in p.items():
        a, b = j[k].double().numpy(), v.double().numpy()
        if k.endswith("bias"):
            assert not a.any() and not b.any(), k
        elif b.size >= 1024:
            assert abs(b.std() - a.std()) <= 0.1 * a.std(), (k, a.std(),
                                                             b.std())
            assert abs(b.mean()) <= 4 * b.std() / np.sqrt(b.size), k
            checked += 1
    assert checked >= 2
