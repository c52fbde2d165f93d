"""The detection training slice's components against `fiber_tpu` at small
shapes on the CPU, fp32 within 1e-5: the training half of the box ops,
the focal / centerness / smooth-L1 losses, ATSS assignment (with an
equidistant gt, where the nearest anchors tie), the ATSS grounding loss
with its optional entries, the contrastive losses and projections, the
MLM masking on the same draws, and the deformable conv's gradients
against `jax.grad` of the JAX op."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import atss as jatss
from fiber_tpu.detection import atss_loss as jloss
from fiber_tpu.detection import boxes as jboxes
from fiber_tpu.detection import contrastive as jcon
from fiber_tpu.detection import losses as jlosses
from fiber_tpu.detection import mlm as jmlm
from fiber_tpu.detection.deform_conv import \
    modulated_deform_conv2d as jax_deform
from fiber_torch.detection import atss, atss_loss, boxes, contrastive
from fiber_torch.detection import losses, mlm
from fiber_torch.detection.anchors import fpn_anchors
from fiber_torch.detection.deform_conv import modulated_deform_conv2d

torch.set_num_threads(1)
ATOL = 1e-5
FEATS = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))     # a 64 x 64 image
STRIDES = (8, 16, 32, 64, 128)
SIZES = (16, 32, 64, 128, 256)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def close_sum(got, want):
    """A loss summed over many terms: within ATOL of its magnitude (fp32
    sums of ~100 terms round apart by a few ulps)."""
    close(got, want, atol=ATOL * max(1.0, abs(float(np.asarray(want)))))


def rand_boxes(rng, shape, lo=0.0, hi=64.0):
    xy = rng.uniform(lo, hi - 20, shape + (2,))
    wh = rng.uniform(2.0, 20.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.fixture(scope="module")
def anchors():
    per_level = fpn_anchors(FEATS, strides=STRIDES, sizes=SIZES)
    return (np.concatenate(per_level).astype(np.float32),
            tuple(a.shape[0] for a in per_level))


# --------------------------------------------------------------------------
# boxes
# --------------------------------------------------------------------------
def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = rand_boxes(rng, (7,)), rand_boxes(rng, (5,))
    c = rand_boxes(rng, (7,))
    w = rng.uniform(0, 1, 7).astype(np.float32)
    close(boxes.box_iou_legacy(t(a), t(b)), jboxes.box_iou_legacy(a, b))
    close(boxes.pairwise_giou(t(a), t(c)), jboxes.pairwise_giou(a, c))
    close(boxes.giou_loss(t(a), t(c)), jboxes.giou_loss(a, c))
    close(boxes.giou_loss(t(a), t(c), t(w)), jboxes.giou_loss(a, c, w))
    close(boxes.encode_boxes(t(a), t(c)), jboxes.encode_boxes(a, c))
    # encode is decode's inverse
    close(boxes.decode_boxes(boxes.encode_boxes(t(a), t(c)), t(c)), a,
          atol=1e-4)


def test_soft_nms_matches_jax():
    rng = np.random.default_rng(1)
    bx = rand_boxes(rng, (12,), hi=40.0)
    sc = rng.uniform(0, 1, 12).astype(np.float32)
    for sigma, thr, n in ((0.5, 0.001, 8), (0.2, 0.3, 12)):
        keep, out = boxes.soft_nms(t(bx), t(sc), sigma, thr, n)
        jkeep, jout = jboxes.soft_nms(jnp.asarray(bx), jnp.asarray(sc),
                                      sigma, thr, n)
        assert keep.tolist() == np.asarray(jkeep).tolist()
        close(out, jout)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def test_focal_centerness_smooth_l1_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((9, 3)) * 3).astype(np.float32)
    cls_t = rng.integers(-1, 4, 9).astype(np.int32)
    close(losses.sigmoid_focal_loss(t(logits), t(cls_t).long(), 3),
          jlosses.sigmoid_focal_loss(logits, cls_t, 3))
    tl = (rng.standard_normal((2, 5, 6)) * 4).astype(np.float32)
    tt = (rng.uniform(0, 1, (2, 5, 6)) < 0.3).astype(np.float32)
    tm = (rng.uniform(0, 1, (2, 1, 6)) < 0.8).astype(np.float32)
    for alpha in (0.25, -1.0):
        close(losses.token_sigmoid_focal_loss(t(tl), t(tt), t(tm),
                                              alpha=alpha),
              jlosses.token_sigmoid_focal_loss(tl, tt, tm, alpha=alpha))
    close(losses.token_sigmoid_focal_loss(t(tl), t(tt)),
          jlosses.token_sigmoid_focal_loss(tl, tt))
    reg = rng.uniform(-2, 10, (11, 4)).astype(np.float32)
    close(losses.centerness_targets(t(reg)), jlosses.centerness_targets(reg))
    ct = rng.uniform(0, 1, 11).astype(np.float32)
    close(losses.centerness_bce(t(logits[:, 0].repeat(2)[:11]), t(ct)),
          jlosses.centerness_bce(logits[:, 0].repeat(2)[:11], ct))
    p, q = reg[:, :2], reg[:, 2:] * 0.05
    close(losses.smooth_l1_loss(t(p), t(q)), jlosses.smooth_l1_loss(p, q))


# --------------------------------------------------------------------------
# ATSS assignment
# --------------------------------------------------------------------------
def assert_assign_equal(got, want):
    assert got.assigned_gt.tolist() == np.asarray(want.assigned_gt).tolist()
    assert got.pos_mask.tolist() == np.asarray(want.pos_mask).tolist()
    pos = np.asarray(want.pos_mask)
    close(got.reg_targets.numpy()[pos], np.asarray(want.reg_targets)[pos])


def test_atss_assign_matches_jax(anchors):
    anc, sizes = anchors
    rng = np.random.default_rng(3)
    gt = rand_boxes(rng, (2, 5))
    gt[1, 2] = gt[1, 1]                      # two gts on one box
    valid = np.asarray([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]], bool)
    for topk in (9, 3):
        got = atss.batched_atss_assign(t(anc), sizes, t(gt), t(valid), topk)
        want = jatss.batched_atss_assign(jnp.asarray(anc), sizes,
                                         jnp.asarray(gt), jnp.asarray(valid),
                                         topk)
        assert_assign_equal(got, want)
        assert bool(got.pos_mask.any())
    one = atss.atss_assign(t(anc), sizes, t(gt[0]), t(valid[0]))
    assert_assign_equal(one, jatss.atss_assign(jnp.asarray(anc), sizes,
                                               jnp.asarray(gt[0]),
                                               jnp.asarray(valid[0])))


def test_atss_assign_tie_takes_lower_indices(anchors):
    """A gt centred on a grid corner (32, 32) is equidistant from the four
    anchors around it at every level: the k nearest of a level are taken
    in index order, as `lax.top_k` takes them."""
    anc, sizes = anchors
    gt = np.asarray([[[20.0, 20.0, 44.0, 44.0], [8.0, 8.0, 24.0, 24.0]]],
                    np.float32)
    valid = np.ones((1, 2), bool)
    for topk in (1, 2, 3, 9):
        got = atss.batched_atss_assign(t(anc), sizes, t(gt), t(valid), topk)
        want = jatss.batched_atss_assign(jnp.asarray(anc), sizes,
                                         jnp.asarray(gt), jnp.asarray(valid),
                                         topk)
        assert_assign_equal(got, want)


# --------------------------------------------------------------------------
# the ATSS grounding loss
# --------------------------------------------------------------------------
def head_outputs(rng, B, T, hw_levels):
    out = {"box_cls": [], "bbox_reg": [], "centerness": [],
           "dot_product_logits": [], "token_logits": [],
           "contrastive_logits": []}
    for h, w in hw_levels:
        out["box_cls"].append(rng.standard_normal((B, h, w, 1)))
        out["bbox_reg"].append(rng.standard_normal((B, h, w, 4)) * 0.5)
        out["centerness"].append(rng.standard_normal((B, h, w, 1)))
        for k in ("dot_product_logits", "token_logits", "contrastive_logits"):
            out[k].append(rng.standard_normal((B, h * w, T)) * 2)
    return {k: [v.astype(np.float32) for v in vs] for k, vs in out.items()}


@pytest.mark.parametrize("optional", [False, True])
def test_atss_grounding_loss_matches_jax(anchors, optional):
    anc, sizes = anchors
    rng = np.random.default_rng(4)
    B, G, T = 2, 4, 10
    head = head_outputs(rng, B, T, FEATS)
    if not optional:
        head = {k: v for k, v in head.items()
                if k not in ("token_logits", "contrastive_logits")}
    gt = rand_boxes(rng, (B, G))
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    pm = (rng.uniform(0, 1, (B, G, T)) < 0.3).astype(np.float32)
    tm = np.ones((B, T), np.float32)
    tm[1, 7:] = 0
    want = jloss.atss_grounding_loss(
        {k: [jnp.asarray(x) for x in v] for k, v in head.items()},
        jnp.asarray(anc), sizes, jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(pm), jnp.asarray(tm), reg_loss_weight=2.0, topk=9)
    got = atss_loss.atss_grounding_loss(
        {k: [t(x) for x in v] for k, v in head.items()}, t(anc), sizes,
        t(gt), t(valid), t(pm), t(tm), reg_loss_weight=2.0, topk=9)
    assert set(got) == set(want)
    assert ("loss_token" in got) == optional
    for k in want:
        close_sum(got[k], want[k])


def test_centerness_and_decoded_giou_match_jax(anchors):
    anc = anchors[0]
    rng = np.random.default_rng(5)
    d1 = (rng.standard_normal(anc.shape) * 0.7).astype(np.float32)
    d2 = (rng.standard_normal(anc.shape) * 0.7).astype(np.float32)
    close(atss_loss.centerness_from_targets(t(d1), t(anc)),
          jloss.centerness_from_targets(d1, anc))
    close(atss_loss._giou_decoded(t(d1), t(d2), t(anc)),
          jloss._giou_decoded(d1, d2, anc))


# --------------------------------------------------------------------------
# contrastive
# --------------------------------------------------------------------------
def test_contrastive_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    x[0, 1] = 0.0
    close(contrastive.safe_l2_normalize(t(x)), jcon.safe_l2_normalize(x))
    logits = (rng.standard_normal((2, 6, 5)) * 3).astype(np.float32)
    pm = rng.uniform(0, 1, (2, 6, 5)) < 0.3
    close_sum(contrastive.contrastive_align_loss(t(logits), t(pm)),
              jcon.contrastive_align_loss(logits, pm))
    tgt = rng.uniform(0, 1, (2, 6, 5)).astype(np.float32)
    close(contrastive.nll_softmax_loss(t(logits), t(tgt)),
          jcon.nll_softmax_loss(logits, tgt))
    pmf = pm.astype(np.float32)
    pmf[0, 0] = 0
    close(contrastive.normalized_positive_map(t(pmf)),
          jcon.normalized_positive_map(pmf))
    pos = rng.uniform(0, 1, (2, 30)) < 0.2
    agt = rng.integers(0, 3, (2, 30)).astype(np.int32)
    for k in (4, 12):
        idx, is_pos = contrastive.select_shallow_anchors(t(pos),
                                                         t(agt).long(), k)
        jidx, jis_pos = jcon.select_shallow_anchors(pos, agt, k)
        assert idx.tolist() == np.asarray(jidx).tolist()
        assert is_pos.tolist() == np.asarray(jis_pos).tolist()


@pytest.mark.parametrize("zero_pads", [False, True])
def test_shallow_contrastive_matches_jax(zero_pads):
    rng = np.random.default_rng(7)
    B, N, C, D, T, G, K, h = 2, 30, 8, 12, 9, 3, 6, 5
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    lang = rng.standard_normal((B, T, D)).astype(np.float32)
    proj = contrastive.ShallowProjections(C, D, h)
    with torch.no_grad():
        for lin in (proj.shallow_contrastive_projection_image,
                    proj.shallow_contrastive_projection_text):
            lin.weight.copy_(t(rng.standard_normal(tuple(lin.weight.shape))
                               .astype(np.float32) * 0.3))
            lin.bias.copy_(t(rng.standard_normal(h).astype(np.float32)
                             * 0.1))
        proj.shallow_log_scale.fill_(0.3)
    jparams = {"params": {
        "projection_image": {
            "kernel": proj.shallow_contrastive_projection_image.weight
            .detach().numpy().T,
            "bias": proj.shallow_contrastive_projection_image.bias
            .detach().numpy()},
        "projection_text": {
            "kernel": proj.shallow_contrastive_projection_text.weight
            .detach().numpy().T,
            "bias": proj.shallow_contrastive_projection_text.bias
            .detach().numpy()},
        "shallow_log_scale": np.asarray([0.3], np.float32)}}
    jqi, jqt, jls = jcon.ShallowProjections(hdim=h).apply(jparams, feats,
                                                          lang)
    qi, qt, ls = proj(t(feats), t(lang))
    close(qi, jqi)
    close(qt, jqt)
    pos = rng.uniform(0, 1, (B, N)) < 0.3
    agt = rng.integers(0, G, (B, N)).astype(np.int32)
    sel, is_pos = jcon.select_shallow_anchors(pos, agt, K)
    tm = np.ones((B, T), np.int32)
    tm[0, 6:] = 0
    pm = (rng.uniform(0, 1, (B, G, T)) < 0.3)
    od = rng.integers(0, 4, (B, G)).astype(np.int32)
    od_tok = rng.integers(-1, 4, (B, T)).astype(np.int32)
    od_tok[tm == 0] = -1                     # padded tokens carry no label
    npos = np.float32(pos.sum())
    want = jcon.shallow_contrastive_loss(
        jqi, jqt, jls, tm, sel, is_pos, agt, pm, od, od_tok, npos,
        zero_pads=zero_pads)
    got = contrastive.shallow_contrastive_loss(
        qi, qt, ls, t(tm), t(np.asarray(sel)).long(), t(np.asarray(is_pos)),
        t(agt).long(), t(pm), t(od), t(od_tok), torch.tensor(npos),
        zero_pads=zero_pads)
    close_sum(got, want)


# --------------------------------------------------------------------------
# MLM
# --------------------------------------------------------------------------
def test_random_word_mask_bit_equal_on_the_same_draws():
    rng = np.random.default_rng(8)
    B, T, V = 3, 40, 99
    ids = rng.integers(5, V, (B, T)).astype(np.int64)
    ids[2, 30:] = 1                                   # padding
    probs = rng.uniform(0, 0.3, (B, T)).astype(np.float32)
    rand = rng.integers(0, V, (B, T)).astype(np.int64)
    green = rng.integers(-1, 2, (B, T)).astype(np.int64)
    for gmap in (None, green):
        got = mlm.random_word_mask(
            None, t(ids), 4, V, 1, None if gmap is None else t(gmap),
            probs=t(probs), rand_tokens=t(rand))
        want = jmlm.random_word_mask(
            jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32), 4, V, 1,
            None if gmap is None else jnp.asarray(gmap), probs=probs,
            rand_tokens=jnp.asarray(rand, jnp.int32))
        for g, w in zip(got, want):
            assert g.tolist() == np.asarray(w).tolist()
    # drawn from a generator: the same draws from the same seed
    a = mlm.random_word_mask(torch.Generator().manual_seed(1), t(ids), 4, V,
                             1)
    b = mlm.random_word_mask(torch.Generator().manual_seed(1), t(ids), 4, V,
                             1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool((a[1] != mlm.IGNORE_INDEX).any())


def test_greenlight_map_and_mlm_loss_match_jax():
    offsets = [(0, 0), (0, 3), (4, 9), (10, 12), (13, 20), (0, 0)]
    for spans in ([(0, 3), (10, 20)], [(1, 9)], [(4, 9, 0)], []):
        assert (mlm.create_greenlight_map(spans, offsets, 8).tolist()
                == jmlm.create_greenlight_map(spans, offsets, 8).tolist())
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 7))
    labels[labels < 0] = mlm.IGNORE_INDEX
    close(mlm.mlm_loss(t(logits), t(labels), 0.5),
          jmlm.mlm_loss(logits, jnp.asarray(labels), 0.5))


# --------------------------------------------------------------------------
# the deformable conv's gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_grads_match_jax_grad(stride):
    """Gradients of sum(out * g) for x, offsets, mask, weight and bias; the
    offsets are non-integer (off the bilinear kinks)."""
    rng = np.random.default_rng(10 + stride)
    B, H, W, Cin, Cout = 2, 6, 7, 4, 5
    Ho, Wo = -(-H // stride), -(-W // stride)
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    off = (rng.standard_normal((B, Ho, Wo, 18)) * 1.7 + 0.13).astype(
        np.float32)
    mask = rng.uniform(0.05, 0.95, (B, Ho, Wo, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, Cout)) / 6).astype(np.float32)
    b = (rng.standard_normal(Cout) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, Ho, Wo, Cout)).astype(np.float32)

    def jfn(x, off, mask, w, b):
        fn = jax.vmap(functools.partial(jax_deform, stride=stride),
                      in_axes=(0, 0, 0, None, None))
        return jnp.sum(fn(x, off, mask, w, b) * g)

    want = jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(x, off, mask, w, b)
    nchw = lambda a: t(a.transpose(0, 3, 1, 2)).requires_grad_(True)
    tx, toff, tmask = nchw(x), nchw(off), nchw(mask)
    tw = t(w.transpose(3, 2, 0, 1)).requires_grad_(True)
    tb = t(b).requires_grad_(True)
    out = modulated_deform_conv2d(tx, toff, tmask, tw, tb, stride=stride)
    (out * t(g.transpose(0, 3, 1, 2))).sum().backward()
    back = lambda a: a.grad.numpy().transpose(0, 2, 3, 1)
    close(back(tx), want[0], atol=1e-4)
    close(back(toff), want[1], atol=1e-4)
    close(back(tmask), want[2], atol=1e-4)
    close(tw.grad.numpy().transpose(2, 3, 1, 0), want[3], atol=1e-4)
    close(tb.grad, want[4], atol=1e-4)
