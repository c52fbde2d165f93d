"""The matcher, ROIAlign / ROIPool, the mask and keypoint structures, mask
pasting and deformable PS-ROI pooling of `fiber_torch.detection` against
`fiber_tpu`'s on the CPU: the same seeded numpy inputs through both;
integer outputs equal, single ops and their gradients within 1e-5,
rasterised and pasted masks bit-equal.  Then `CocoDetectionDataset
(return_masks=True)` against JAX's on polygon fixtures."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.data import coco_datasets as jcoco
from fiber_tpu.detection import deform_conv as jdeform
from fiber_tpu.detection import matcher as jmatcher
from fiber_tpu.detection import roi_align as jroi
from fiber_tpu.detection import structures as jst
from fiber_torch.data import coco_datasets as tcoco
from fiber_torch.detection import deform_conv as tdeform
from fiber_torch.detection import matcher as tmatcher
from fiber_torch.detection import roi_align as troi
from fiber_torch.detection import structures as tst

torch.set_num_threads(1)
OP_ATOL = 1e-5


def close(got, want, atol=OP_ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert err <= atol * scale, f"{what}: {err}"


def t(x):
    return torch.from_numpy(np.array(x))


def chw(x):
    return t(np.asarray(x).transpose(2, 0, 1))


# ---------------------------------------------------------------------
# the matcher and the sampler
# ---------------------------------------------------------------------
@pytest.mark.parametrize("low_quality", [False, True])
def test_match_quality_matches_jax(low_quality):
    rng = np.random.default_rng(0)
    q = rng.uniform(0, 1, (5, 40)).astype(np.float32)
    q[:, 7] = 0.0
    valid = np.array([True, True, False, True, True])
    want = jmatcher.match_quality(jnp.asarray(q), jnp.asarray(valid), 0.6,
                                  0.3, allow_low_quality=low_quality)
    got = tmatcher.match_quality(t(q), t(valid), 0.6, 0.3,
                                 allow_low_quality=low_quality)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_match_quality_ties_take_the_first():
    """Equal qualities: the first gt wins the argmax, and every prediction
    that ties a gt's best keeps its raw match under the low-quality
    restore."""
    q = np.array([[0.4, 0.2, 0.4, 0.1],
                  [0.4, 0.2, 0.1, 0.4],
                  [0.1, 0.1, 0.1, 0.1]], np.float32)
    valid = np.array([True, True, True])
    for lq in (False, True):
        want = jmatcher.match_quality(jnp.asarray(q), jnp.asarray(valid), 0.5,
                                      0.15, allow_low_quality=lq)
        got = tmatcher.match_quality(t(q), t(valid), 0.5, 0.15,
                                     allow_low_quality=lq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 0, 0, 1]
    assert tmatcher.first_argmax(t(q), 0).tolist() == [0, 0, 0, 1]


def jax_keys(rng, n):
    k1, k2 = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


@pytest.mark.parametrize("n_pos", [3, 12])
def test_balanced_sample_on_jax_draws(n_pos):
    n = 40
    pos = np.zeros(n, bool)
    pos[np.random.default_rng(n_pos).choice(n, n_pos, replace=False)] = True
    neg = ~pos
    neg[:2] = False
    rng = jax.random.PRNGKey(5)
    jp, jn = jmatcher.balanced_sample(jnp.asarray(pos), jnp.asarray(neg),
                                      rng, 16, 0.5)
    tp, tn = tmatcher.balanced_sample(t(pos), t(neg), None, 16, 0.5,
                                      keys=t(jax_keys(rng, n)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tp.sum()) == min(n_pos, 8)
    assert int(tp.sum() + tn.sum()) == 16
    # from a generator: the same budget, a reproducible draw
    g = lambda: torch.Generator().manual_seed(1)
    a = tmatcher.balanced_sample(t(pos), t(neg), g(), 16, 0.5)
    b = tmatcher.balanced_sample(t(pos), t(neg), g(), 16, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[0].sum()) == min(n_pos, 8) and int(a[1].sum()) == \
        16 - min(n_pos, 8)


# ---------------------------------------------------------------------
# ROIAlign / ROIPool
# ---------------------------------------------------------------------
def rois_and_features(seed=0, H=13, W=17, C=6, R=9):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-10, 50, R)
    y1 = rng.uniform(-10, 40, R)
    rois = np.stack([x1, y1, x1 + rng.uniform(0.5, 40, R),
                     y1 + rng.uniform(0.5, 30, R)], 1).astype(np.float32)
    rois[0] = [3.0, 4.0, 3.2, 4.1]                  # smaller than a pixel
    feat = rng.standard_normal((H, W, C)).astype(np.float32)
    return feat, rois


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling", [1, 2])
def test_roi_align_and_grads_match_jax(aligned, sampling):
    feat, rois = rois_and_features()
    g = np.random.default_rng(1).standard_normal((9, 5, 5, 6)).astype(
        np.float32)
    kw = dict(spatial_scale=0.25, sampling_ratio=sampling, aligned=aligned)
    f = lambda x: (jroi.roi_align(x, jnp.asarray(rois), 5, **kw)
                   * g).sum()
    want = jroi.roi_align(jnp.asarray(feat), jnp.asarray(rois), 5, **kw)
    want_g = jax.grad(f)(jnp.asarray(feat))
    x = chw(feat).requires_grad_(True)
    got = troi.roi_align(x, t(rois), 5, **kw)
    close(got.permute(0, 2, 3, 1), want, what="roi_align")
    (got * t(g.transpose(0, 3, 1, 2))).sum().backward()
    close(x.grad.permute(1, 2, 0), want_g, what="roi_align grad")


def test_roi_pool_is_jax_mean_of_16_samples():
    feat, rois = rois_and_features(seed=2)
    want = jroi.roi_pool(jnp.asarray(feat), jnp.asarray(rois), 7, 0.5)
    got = troi.roi_pool(chw(feat), t(rois), 7, 0.5)
    close(got.permute(0, 2, 3, 1), want, what="roi_pool")
    close(got, troi.roi_align(chw(feat), t(rois), 7, 0.5, sampling_ratio=4,
                              aligned=False), atol=0.0)


# ---------------------------------------------------------------------
# masks and keypoints
# ---------------------------------------------------------------------
POLYS = [
    [np.array([3.2, 2.5, 20.7, 4.1, 17.3, 18.9, 5.5, 14.2])],
    # a self-crossing star and a separate triangle: even-odd holes, union
    [np.array([30., 5., 36., 25., 21., 12., 39., 12., 24., 25.]),
     np.array([2., 30., 12., 38., 1., 39.5])],
    [],
]


def test_rasterize_random_polygons_bit_equal():
    """Seeded polygons of 0 to 9 vertices, some on pixel centres or
    corners, some past the canvas: the port tests each only over its
    box, JAX over the whole canvas; the masks are equal."""
    rng = np.random.default_rng(7)
    for _ in range(60):
        H, W = rng.integers(5, 50, 2)
        polys = [rng.uniform(-10, 60, 2 * rng.integers(0, 10))
                 for _ in range(rng.integers(1, 5))]
        for p in polys:
            snap = rng.random(p.shape) < 0.5
            p[snap] = np.round(p[snap] * 2) / 2
        np.testing.assert_array_equal(tst.rasterize_polygons(polys, H, W),
                                      jst.rasterize_polygons(polys, H, W))


def test_rasterize_and_from_polygons_bit_equal():
    for polys in POLYS:
        np.testing.assert_array_equal(tst.rasterize_polygons(polys, 41, 43),
                                      jst.rasterize_polygons(polys, 41, 43))
    j = jst.SegmentationMasks.from_polygons(POLYS, 41, 43, pad_to=4)
    p = tst.SegmentationMasks.from_polygons(POLYS, 41, 43, pad_to=4,
                                            device="cpu")
    np.testing.assert_array_equal(p.masks.numpy(), np.asarray(j.masks))
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(p.hflip().masks.numpy(),
                                  np.asarray(j.hflip().masks))
    np.testing.assert_array_equal(p.areas().numpy(), np.asarray(j.areas()))


@pytest.mark.parametrize("size", [(20, 22), (41, 60), (13, 43)])
def test_mask_resize_matches_jax(size):
    """The resample within 1e-5 of `jax.image.resize`; the thresholded
    masks equal wherever JAX's value is not within 1e-5 of 0.5."""
    p = tst.SegmentationMasks.from_polygons(POLYS, 41, 43, pad_to=3,
                                            device="cpu")
    j = jst.SegmentationMasks(jnp.asarray(p.masks.numpy()),
                              jnp.asarray(p.valid.numpy()))
    want = np.asarray(jax.image.resize(j.masks.astype(jnp.float32),
                                       (3,) + size, "bilinear"))
    got = tst.resize_axes(p.masks.float(), {1: size[0], 2: size[1]})
    close(got, want, what="resize")
    clear = np.abs(want - 0.5) > 1e-5
    np.testing.assert_array_equal(p.resize(*size).masks.numpy()[clear],
                                  np.asarray(j.resize(*size).masks)[clear])


def test_crop_and_resize_matches_jax():
    p = tst.SegmentationMasks.from_polygons(POLYS, 41, 43, pad_to=3,
                                            device="cpu")
    j = jst.SegmentationMasks(jnp.asarray(p.masks.numpy()),
                              jnp.asarray(p.valid.numpy()))
    boxes = np.array([[3., 2., 21., 19.], [20., 4., 40., 26.],
                      [0., 0., 43., 41.]], np.float32)
    want = j.crop_and_resize(jnp.asarray(boxes), 14)
    close(p.crop_and_resize(t(boxes), 14), want, what="crop_and_resize")
    # a mask index per box: the masks of boxes 2, 0, 0
    idx = np.array([2, 0, 0])
    want = jst.SegmentationMasks(j.masks[idx], j.valid[idx]) \
        .crop_and_resize(jnp.asarray(boxes), 14)
    close(p.crop_and_resize(t(boxes), 14, index=t(idx)), want,
          what="crop_and_resize index")


def keypoints(seed=0, N=4, K=17):
    rng = np.random.default_rng(seed)
    kps = np.zeros((N, K, 3), np.float32)
    kps[..., 0] = rng.uniform(-5, 70, (N, K))
    kps[..., 1] = rng.uniform(-5, 50, (N, K))
    kps[..., 2] = rng.integers(0, 3, (N, K))
    valid = np.array([True, True, False, True])[:N]
    boxes = np.array([[0., 0., 60., 40.], [10., 5., 30., 45.],
                      [5., 5., 50., 30.], [20., 10., 20.5, 10.5]],
                     np.float32)[:N]
    return kps, valid, boxes


def test_keypoints_match_jax():
    kps, valid, boxes = keypoints()
    j = jst.Keypoints(jnp.asarray(kps), jnp.asarray(valid))
    p = tst.Keypoints(t(kps), t(valid))
    close(p.resize(0.5, 1.5).kps, j.resize(0.5, 1.5).kps, atol=0.0)
    close(p.hflip(64).kps, j.hflip(64).kps, atol=0.0)
    for hm in (56, 14):
        jb, jv = j.to_heatmap_targets(jnp.asarray(boxes), hm)
        tb, tv = p.to_heatmap_targets(t(boxes), hm)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tst.flip_indices(), jst._flip_indices())


def test_paste_masks_bit_equal():
    rng = np.random.default_rng(3)
    probs = rng.uniform(0, 1, (5, 28, 28))
    boxes = np.array([[10.3, 5.7, 40.2, 33.9], [-8., -3., 20., 15.],
                      [50., 40., 90., 79.], [0., 0., 0.4, 0.4],
                      [30., 20., 31., 60.]])
    for thresh in (0.5, -1.0):
        want = jst.paste_masks_in_image(probs, boxes, 64, 80, thresh)
        got = tst.paste_masks_in_image(t(probs), t(boxes), 64, 80, thresh)
        np.testing.assert_array_equal(got, want)
    assert tst.paste_masks_in_image(np.zeros((0, 28, 28)), np.zeros((0, 4)),
                                    8, 9).shape == (0, 8, 9)


# ---------------------------------------------------------------------
# deformable PS-ROI pooling
# ---------------------------------------------------------------------
def psroi_inputs(seed, no_trans, num_classes=2):
    rng = np.random.default_rng(seed)
    OD, G, P = 4 * num_classes, 2, 4
    H, W = 12, 16
    x = rng.standard_normal((H, W, OD * G * G)).astype(np.float32)
    rois = np.array([[2, 3, 40, 30], [0, 0, 63, 47], [10, 8, 20, 44],
                     [30, 20, 33, 22], [-20, -9, 90, 70.5]], np.float32)
    trans = None if no_trans else rng.standard_normal(
        (len(rois), num_classes, 2, 3, 3)).astype(np.float32)
    kw = dict(spatial_scale=0.25, output_dim=OD, group_size=G,
              pooled_size=P, part_size=3, sample_per_part=3, trans_std=0.1)
    return x, rois, trans, kw


@pytest.mark.parametrize("no_trans", [False, True])
def test_deform_psroi_pool_and_grads_match_jax(no_trans):
    x, rois, trans, kw = psroi_inputs(4, no_trans)
    g = np.random.default_rng(5).standard_normal((5, 4, 4, 8)).astype(
        np.float32)
    jt = None if no_trans else jnp.asarray(trans)
    want = jdeform.deform_psroi_pool(jnp.asarray(x), jnp.asarray(rois), jt,
                                     **kw)

    def f(xx, tt):
        return (jdeform.deform_psroi_pool(xx, jnp.asarray(rois), tt, **kw)
                * g).sum()

    xt = chw(x).requires_grad_(True)
    tt = None if no_trans else t(trans).requires_grad_(True)
    got = tdeform.deform_psroi_pool(xt, t(rois), tt, **kw)
    close(got.permute(0, 2, 3, 1), want, what="deform_psroi_pool")
    (got * t(g.transpose(0, 3, 1, 2))).sum().backward()
    if no_trans:
        gx = jax.grad(lambda xx: f(xx, None))(jnp.asarray(x))
    else:
        gx, gt = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jt)
        close(tt.grad, gt, what="trans grad")
        assert float(tt.grad.abs().sum()) > 0
    close(xt.grad.permute(1, 2, 0), gx, what="x grad")


# ---------------------------------------------------------------------
# the dataset's instance masks
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def coco_polygons(tmp_path_factory):
    """Four PNG images (landscape and portrait) with two polygon boxes
    each, one of them a crowd box, and one RLE-only annotation."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coco_masks")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(4):
        w, h = (96, 64) if i % 2 == 0 else (64, 96)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            root / f"{i:04d}.png")
        images.append({"id": i + 1, "file_name": f"{i:04d}.png",
                       "height": h, "width": w})
        for b in range(2):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": [1, 3][b],
                         "iscrowd": int(i == 3 and b),
                         "bbox": [float(x), float(y), 20.0, 15.0],
                         "area": 300.0,
                         "segmentation": [[x, y, x + 20, y + 3, x + 14, y + 15,
                                           x, y + 11]]})
    anns.append({"id": len(anns) + 1, "image_id": 2, "category_id": 3,
                 "iscrowd": 0, "bbox": [1.0, 2.0, 5.0, 5.0], "area": 25.0,
                 "segmentation": {"counts": [0, 5], "size": [96, 64]}})
    cats = [{"id": 1, "name": "dog"}, {"id": 3, "name": "car"}]
    ann = root / "coco.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": cats}))
    return str(root), str(ann)


def test_dataset_masks_bit_equal_to_jax(coco_polygons):
    pytest.importorskip("PIL")
    root, ann = coco_polygons
    tds = tcoco.CocoDetectionDataset(root, ann, return_masks=True)
    jds = jcoco.CocoDetectionDataset(root, ann, return_masks=True)
    for i in range(len(tds)):
        a, b = tds[i], jds[i]
        assert a["masks"].dtype == bool and a["masks"].shape == \
            (len(a["boxes"]), a["height"], a["width"])
        np.testing.assert_array_equal(a["masks"], b["masks"])
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        assert a["masks"].any(axis=(1, 2)).sum() >= 1
    assert "masks" not in tcoco.CocoDetectionDataset(root, ann)[0]
