"""The detection port's components against the JAX package on the CPU:
the modulated deformable conv, FPN, DyReLU, Conv3x3Norm, one DyConv with
deform on, the box ops, NMS and ML-NMS, the ATSS postprocess, the anchors
and the language dict.  Single ops within atol 1e-5 in fp32; NMS and the
postprocess slot for slot."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection import anchors as jax_anchors
from fiber_tpu.detection import boxes as jax_boxes
from fiber_tpu.detection import dyhead as jax_dyhead
from fiber_tpu.detection.deform_conv import \
    modulated_deform_conv2d as jax_deform
from fiber_tpu.detection.fpn import FPN as JaxFPN
from fiber_tpu.detection.postprocess import \
    atss_postprocess as jax_postprocess
from fiber_tpu.detection.postprocess import label_to_token_matrix
from fiber_tpu.models.roberta import make_lang_dict as jax_lang_dict
from fiber_tpu.utils.checkpoint_convert import convert_detection_state_dict
from fiber_torch.detection import anchors, boxes, dyhead
from fiber_torch.detection.deform_conv import modulated_deform_conv2d
from fiber_torch.detection.fpn import FPN
from fiber_torch.detection.postprocess import atss_postprocess
from fiber_torch.models.roberta import make_lang_dict
from torch_detection_parity import fill, unflatten, flatten

torch.set_num_threads(1)

ATOL = 1e-5
# bf16 deform conv, port against JAX, over the output's max-abs: the
# product's fp32 sums are rounded to bf16 once in JAX and, with the bias
# added after, twice in the port
BF16_RTOL = 1e-2

t = torch.from_numpy


def nchw(x: np.ndarray) -> torch.Tensor:
    return t(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def flax_subtree(module: torch.nn.Module, prefix: str, path: str,
                 use_deform: bool = True, seed: int = 0):
    """Seeded parameters for a port module, and the same parameters as
    the JAX module's tree: the module's keys put under `prefix` (their
    place in the detector), through the JAX package's
    `convert_detection_state_dict`, then the subtree at `path`."""
    sd = fill(module, seed)
    module.load_state_dict(sd, strict=True)
    params, unmapped = convert_detection_state_dict(
        {prefix + k: v.numpy() for k, v in sd.items()},
        use_deform=use_deform, strict=True)
    for part in path.split("/"):
        params = params[part]
    return {"params": unflatten(flatten(params))}


# --------------------------------------------------------------------------
# modulated deformable conv
# --------------------------------------------------------------------------
def deform_inputs(stride: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    B, H, W, Cin, Cout = 2, 7, 9, 5, 6
    Ho, Wo = -(-H // stride), -(-W // stride)
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    # large offsets push samples across and beyond every border; whole
    # offsets put samples exactly on grid points and on the borders
    off = rng.standard_normal((B, Ho, Wo, 18)) * 3.0
    off[:, ::2, ::3] = np.round(off[:, ::2, ::3])
    off[0, 0, 0, :2] = (-1.0, -1.0)                # on the (-1, -1) corner
    off[0, -1, -1, -2:] = (H, W)                   # past the far corner
    mask = rng.uniform(0.05, 0.95, (B, Ho, Wo, 9))
    w = rng.standard_normal((3, 3, Cin, Cout)) / np.sqrt(9 * Cin)
    b = rng.standard_normal(Cout) * 0.1
    return (x, off.astype(np.float32), mask.astype(np.float32),
            w.astype(np.float32), b.astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deform_conv_matches_jax(stride, dtype):
    x, off, mask, w, b = deform_inputs(stride, seed=stride)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fn = jax.jit(jax.vmap(functools.partial(jax_deform, stride=stride),
                          in_axes=(0, 0, 0, None, None)))
    want = np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(off, jdt),
                         jnp.asarray(mask, jdt), jnp.asarray(w, jdt),
                         jnp.asarray(b, jdt)), np.float32)
    got = modulated_deform_conv2d(
        nchw(x).to(tdt), nchw(off).to(tdt), nchw(mask).to(tdt),
        t(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(tdt),
        t(b).to(tdt), stride=stride)
    assert got.dtype == tdt
    got = to_nhwc(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


def test_deform_conv_zero_offsets_is_a_conv():
    """Zero offsets and a unit mask give the plain 3x3 conv (padding 1)."""
    x, off, mask, w, b = deform_inputs(2)
    wt = t(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = modulated_deform_conv2d(nchw(x), torch.zeros(2, 18, 4, 5),
                                  torch.ones(2, 9, 4, 5), wt, t(b), stride=2)
    want = torch.nn.functional.conv2d(nchw(x), wt, t(b), stride=2, padding=1)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# FPN and the DyHead's modules
# --------------------------------------------------------------------------
def test_fpn_matches_jax():
    rng = np.random.default_rng(3)
    chans = (8, 16, 32)
    feats = [rng.standard_normal((2, 12 // 2 ** i, 16 // 2 ** i, c))
             .astype(np.float32) for i, c in enumerate(chans)]
    port = FPN(chans, out_channels=16)
    variables = flax_subtree(port, "fusion_backbone.backbone.fpn.",
                             "backbone/fpn")
    want = jax.jit(JaxFPN(out_channels=16).apply)(
        variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    assert [g.shape[-2:] for g in got] == [(12, 16), (6, 8), (3, 4), (2, 2),
                                           (1, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_dyrelu_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5, 7, 32)).astype(
        np.float32)
    port = dyhead.DyReLU(32)
    variables = flax_subtree(port, "rpn.head.dyhead_tower.0.relu.",
                             "rpn/dyconv_0/dyrelu")
    want = jax_dyhead.DyReLU(32).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("deformable", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3norm_matches_jax(deformable, stride):
    rng = np.random.default_rng(5 + stride)
    x = rng.standard_normal((2, 7, 9, 32)).astype(np.float32)
    Ho, Wo = -(-7 // stride), -(-9 // stride)
    off = (rng.standard_normal((2, Ho, Wo, 18)) * 2).astype(np.float32)
    mask = rng.uniform(0, 1, (2, Ho, Wo, 9)).astype(np.float32)
    port = dyhead.Conv3x3Norm(32, 32, stride, deformable)
    variables = flax_subtree(port, "rpn.head.dyhead_tower.0.DyConv.1.",
                             "rpn/dyconv_0/conv_same", use_deform=deformable)
    jmod = jax_dyhead.Conv3x3Norm(32, stride, deformable=deformable)
    args = (jnp.asarray(off), jnp.asarray(mask)) if deformable else ()
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x), *args)
    with torch.no_grad():
        got = port(nchw(x), *((nchw(off), nchw(mask)) if deformable else ()))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_reinterpret_is_not_a_crop():
    """The conv over level l + 1 reads level l's offsets flat: at 5x7 over
    3x4 the reinterpreted buffer differs from the top-left crop."""
    buf = torch.arange(2 * 18 * 5 * 7, dtype=torch.float32).reshape(2, 18, 5,
                                                                    7)
    got = dyhead.reinterpret(buf, 3, 4)
    want = buf.reshape(2, -1)[:, :18 * 12].reshape(2, 18, 3, 4)
    assert torch.equal(got, want)
    assert not torch.equal(got, buf[:, :, :3, :4])


def test_dyconv_with_deform_matches_jax():
    """One DyConv (deform, DyFuse, DyReLU) over levels 10x14, 5x7, 3x4,
    2x2: each level's offsets feed the stride-2 conv of the level below and,
    reinterpreted, the conv of the level above."""
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((2, h, w, 32)).astype(np.float32)
             for h, w in ((10, 14), (5, 7), (3, 4), (2, 2))]
    port = dyhead.DyConv(32, 32)
    variables = flax_subtree(port, "rpn.head.dyhead_tower.0.",
                             "rpn/dyconv_0")
    jmod = jax_dyhead.DyConv(32, 32)
    want = jax.jit(jmod.apply)(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_vldyhead_refuses_options_it_does_not_port():
    """An early fusion the JAX package does not have raises; GLIP's MHA-B
    early fusion and the token and contrastive-align heads build."""
    with pytest.raises(ValueError, match="early_fuse"):
        dyhead.VLDyHead(num_convs=1, in_channels=16, channels=16,
                        lang_dim=8, early_fuse="mha-s")
    early = dyhead.VLDyHead(num_convs=1, in_channels=16, channels=16,
                            lang_dim=8, num_text_heads=2, early_fuse="mha-b")
    assert [type(m).__name__ for m in early.dyhead_tower] == [
        "VLFuse", "DummyLayer", "DyConv"]
    head = dyhead.VLDyHead(num_convs=1, in_channels=16, channels=16,
                           lang_dim=8, max_query_len=6, use_token_loss=True,
                           use_contrastive_align=True)
    assert head.token_logits.out_channels == 6


# --------------------------------------------------------------------------
# boxes and NMS
# --------------------------------------------------------------------------
def test_decode_and_small_boxes_match_jax():
    rng = np.random.default_rng(7)
    anc = np.asarray(jax_anchors.grid_anchors(6, 8, 16, 64), np.float32)
    deltas = (rng.standard_normal((48, 4)) * 3).astype(np.float32)
    deltas[:4, 2:] = 9.0                          # beyond the clamp
    want = np.asarray(jax_boxes.decode_boxes(jnp.asarray(deltas),
                                             jnp.asarray(anc)))
    got = boxes.decode_boxes(t(deltas), t(anc)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    for min_size in (0.0, 40.0, 200.0):
        np.testing.assert_array_equal(
            boxes.remove_small_boxes(t(got), min_size).numpy(),
            np.asarray(jax_boxes.remove_small_boxes(jnp.asarray(got),
                                                    min_size)))
    np.testing.assert_allclose(
        boxes.clip_boxes(t(got), 50.0, 70.0).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(got), 50.0, 70.0)),
        atol=0, rtol=0)
    np.testing.assert_allclose(
        boxes.box_iou(t(got[:5]), t(got)).numpy(),
        np.asarray(jax_boxes.box_iou(jnp.asarray(got[:5]), jnp.asarray(got))),
        atol=ATOL, rtol=0)


def nms_case(seed: int, n: int = 60):
    """Boxes on an integer grid with many overlaps; some scores tied; a few
    pairs at exactly IoU 0.5 (legacy +1): [0, 0, 9, 9] and [0, 0, 9, 4]."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 30, (n, 2))
    wh = rng.integers(3, 15, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[:4] = [[0, 0, 9, 9], [0, 0, 9, 4], [40, 40, 49, 49], [40, 40, 49, 44]]
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[[1, 3]] = s[[0, 2]] = 0.99                  # ties at the top
    s[10:20] = s[10]                              # a run of equal scores
    labels = rng.integers(1, 4, n).astype(np.int32)
    valid = rng.uniform(0, 1, n) > 0.2
    return b, s, labels, valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("max_outputs", [20, 80])
def test_nms_matches_jax(seed, use_valid, max_outputs):
    """Every slot of (keep, ok), with ties at the threshold and in the
    scores; 80 outputs is more than the live boxes."""
    b, s, labels, valid = nms_case(seed)
    v = valid if use_valid else None
    jk, jo = jax_boxes.nms(jnp.asarray(b), jnp.asarray(s), 0.5, max_outputs,
                           valid=None if v is None else jnp.asarray(v))
    tk, to = boxes.nms(t(b), t(s), 0.5, max_outputs,
                       valid=None if v is None else t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if max_outputs == 80:
        assert not to.numpy().all() and (tk.numpy()[~to.numpy()] == 0).all()
    jk, jo = jax_boxes.ml_nms(jnp.asarray(b), jnp.asarray(s),
                              jnp.asarray(labels), 0.5, max_outputs,
                              valid=None if v is None else jnp.asarray(v))
    tk, to = boxes.ml_nms(t(b), t(s), t(labels), 0.5, max_outputs,
                          valid=None if v is None else t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_nms_suppresses_at_the_threshold():
    b, s, _, _ = nms_case(0)
    keep, ok = boxes.nms(t(b[:2]), t(np.asarray([0.9, 0.8], np.float32)),
                         0.5, 2)
    assert keep.tolist() == [0, 0] and ok.tolist() == [True, False]


# --------------------------------------------------------------------------
# ATSS postprocess
# --------------------------------------------------------------------------
def head_outputs(seed: int, B: int = 2, T: int = 16,
                 sizes=((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))):
    """Seeded head outputs: grounding logits around the candidate
    threshold's logit (most below it), so that many candidates are
    zeroed and their tie order matters."""
    rng = np.random.default_rng(seed)
    out = {"box_cls": [], "bbox_reg": [], "centerness": [],
           "dot_product_logits": []}
    for h, w in sizes:
        out["box_cls"].append(rng.standard_normal((B, h, w, 1)))
        out["bbox_reg"].append(rng.standard_normal((B, h, w, 4)))
        out["centerness"].append(rng.standard_normal((B, h, w, 1)))
        out["dot_product_logits"].append(
            rng.normal(-4.5, 1.5, (B, h * w, T)))
    return {k: [a.astype(np.float32) for a in v] for k, v in out.items()}


@pytest.mark.parametrize("pre_nms_top_n", [20, 1000])
def test_atss_postprocess_matches_jax(pre_nms_top_n):
    head = head_outputs(8)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    per_level = jax_anchors.fpn_anchors(sizes, sizes=(16, 32, 64, 128, 256))
    agg = label_to_token_matrix({1: [1, 2], 2: [4], 3: [6, 7, 8]}, 3, 16)
    image_sizes = np.asarray([[60, 90], [45, 96]], np.float32)
    kw = dict(pre_nms_top_n=pre_nms_top_n, post_nms_top_n=100)
    want = jax.jit(functools.partial(jax_postprocess, **kw))(
        {k: [jnp.asarray(a) for a in v] for k, v in head.items()},
        [jnp.asarray(a) for a in per_level], jnp.asarray(agg),
        jnp.asarray(image_sizes))
    got = atss_postprocess({k: [t(a) for a in v] for k, v in head.items()},
                           [t(a) for a in per_level], t(agg), t(image_sizes),
                           **kw)
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=ATOL, rtol=0)


def test_top_k_stable_orders_ties_by_index():
    from fiber_torch.detection.postprocess import top_k_stable
    x = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.0, 0.1]])
    values, idx = top_k_stable(x, 5)
    assert idx.tolist() == [[1, 3, 5, 0, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist()


# --------------------------------------------------------------------------
# anchors, the language dict
# --------------------------------------------------------------------------
def test_anchors_bit_equal():
    sizes = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
    for a, b in zip(anchors.fpn_anchors(sizes), jax_anchors.fpn_anchors(sizes)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_lang_dict_matches_jax():
    rng = np.random.default_rng(9)
    text = rng.standard_normal((2, 6, 8)).astype(np.float32)
    mask = np.asarray([[1] * 6, [1, 1, 1, 0, 0, 0]], np.int32)
    want = jax_lang_dict(jnp.asarray(text), jnp.asarray(mask))
    got = make_lang_dict(t(text), t(mask))
    for k in ("hidden", "embedded", "aggregate"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0)
