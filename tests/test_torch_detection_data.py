"""The detection data path against `fiber_tpu` on the CPU: COCO JSON and
PNG fixtures written by the test, `CocoGroundingDataset`,
`ModulatedCocoDataset`, `create_positive_map_from_spans`,
`DetectionBatcher` (the bilinear resize within 1e-5 of
`jax.image.resize` on normalised pixels; boxes, flips, buckets and
positive maps equal) and `lvis_frequency_groups`; then the two CLIs at
tiny dims on the CPU, `finetune_det` on the fixtures."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fiber_tpu.data import coco_datasets as jcoco
from fiber_tpu.data import loader as jloader
from fiber_tpu.data.tokenizer import WhitespaceTokenizer as JaxTokenizer
from fiber_torch.data import coco_datasets as tcoco
from fiber_torch.data import loader as tloader
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.tools import finetune_det, train_det

pytest.importorskip("PIL")
CATS = [{"id": 1, "name": "dog", "image_count": 5},
        {"id": 3, "name": "car", "frequency": "c"},
        {"id": 7, "name": "red person", "image_count": 400}]
CAPTION = "a red dog chasing a blue car"


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Six PNG images (landscape, portrait, one square) with two boxes each,
    a grounding and a captioned annotation file."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(6):
        h, w = ((50, 90), (90, 50), (70, 70))[i % 3]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / f"{i}.png")
        images.append({"id": i + 1, "file_name": f"{i}.png", "height": h,
                       "width": w, "caption": CAPTION})
        for b, (cat, span) in enumerate(((1, [[6, 9]]), (3, [[25, 28]]))):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cat, "iscrowd": int(i == 5 and b),
                         "bbox": [float(x), float(y), 17.5, 12.25],
                         "tokens_positive": span})
    ann_file = root / "ann.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns,
                                    "categories": CATS}))
    return str(root), str(ann_file)


def assert_records_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_positive_map_from_spans_matches_jax():
    offsets = [(0, 0), (0, 1), (2, 5), (6, 9), (10, 17), (18, 21), (0, 0)]
    spans = [[(2, 9)], [(1, 5), (10, 17)], [(11, 15)], [(30, 40)], []]
    for normalize in (True, False):
        np.testing.assert_array_equal(
            tcoco.create_positive_map_from_spans(offsets, spans, 9,
                                                 normalize),
            jcoco.create_positive_map_from_spans(offsets, spans, 9,
                                                 normalize))


def test_datasets_match_jax(coco):
    root, ann = coco
    for tcls, jcls, kw in (
            (tcoco.CocoGroundingDataset, jcoco.CocoGroundingDataset,
             dict(num_negatives=1, seed=3)),
            (tcoco.ModulatedCocoDataset, jcoco.ModulatedCocoDataset, {})):
        tds = tcls(root, ann, WhitespaceTokenizer(), max_query_len=16, **kw)
        jds = jcls(root, ann, JaxTokenizer(), max_query_len=16, **kw)
        assert len(tds) == len(jds) == 6
        for i in range(len(tds)):
            assert_records_equal(tds[i], jds[i])
    plain = tcoco.CocoDetectionDataset(root, ann)
    assert_records_equal(plain[5], jcoco.CocoDetectionDataset(root, ann)[5])
    assert len(plain[5]["boxes"]) == 1                  # the crowd box left out
    # the fixtures have no polygons: every instance mask is empty, as JAX's
    masked = tcoco.CocoDetectionDataset(root, ann, return_masks=True)
    assert_records_equal(masked[0], jcoco.CocoDetectionDataset(
        root, ann, return_masks=True)[0])
    assert masked[0]["masks"].shape == (2, 50, 90)
    assert not masked[0]["masks"].any()


def test_lvis_frequency_groups_match_jax(coco):
    _, ann = coco
    assert tcoco.lvis_frequency_groups(ann) == \
        jcoco.lvis_frequency_groups(ann) == {1: "r", 2: "c", 3: "f"}


@pytest.mark.parametrize("size", [(50, 90, 37, 66), (90, 50, 128, 71),
                                  (70, 70, 70, 33)])
def test_bilinear_resize_matches_jax(size):
    h, w, nh, nw = size
    rng = np.random.default_rng(h + nw)
    img = ((rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            - jloader.IMAGENET_MEAN) / jloader.IMAGENET_STD)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (nh, nw, 3),
                                       "bilinear"))
    got = tloader.resize_bilinear(img, nh, nw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_batcher_matches_jax(coco):
    root, ann = coco
    tds = tcoco.CocoGroundingDataset(root, ann, WhitespaceTokenizer(),
                                     max_query_len=16, num_negatives=1)
    jds = jcoco.CocoGroundingDataset(root, ann, JaxTokenizer(),
                                     max_query_len=16, num_negatives=1)
    kw = dict(batch_size=2, min_sizes=(32, 64), max_size=96, max_boxes=3,
              min_items=10, seed=4, hflip_prob=0.5)
    tb = list(tloader.DetectionBatcher(tds, **kw))
    jb = list(jloader.DetectionBatcher(jds, **kw))
    assert len(tb) == len(jb) >= 4
    shapes = set()
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["images"], b["images"], atol=1e-5,
                                   rtol=0)
        for k in a:
            if k != "images":
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0,
                                           err_msg=k)
        shapes.add(a["images"].shape[1:3])
    assert len(shapes) >= 2                          # several buckets
    assert tloader.resize_min_size(50, 90, 64, 96) == \
        jloader.resize_min_size(50, 90, 64, 96)


def test_train_det_cli_tiny(capsys):
    trainer = train_det.main(["--tiny", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--log-every", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["steps"]) == 2 and trainer.step == 2
    assert all(np.isfinite(s["total_loss"]) and s["finite"] == 1.0
               for s in out["steps"])
    assert train_det.parse_size("800x1344") == (800, 1344)
    assert train_det.parse_size("448") == (448, 448)


def test_finetune_det_cli_on_coco(coco, capsys):
    root, ann = coco
    trainer = finetune_det.main([
        "--tiny", "--device", "cpu", "--steps", "3", "--tuning",
        "language_prompt_v2", "--img-root", root, "--ann-file", ann,
        "--shots", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["frozen_excess_over_decay"] <= 0.0
    assert out["trainable_params"] == trainer.model.fusion_backbone \
        .tunable_linear.weight.numel()
