"""The port's long-tail dataset readers and catalog against
`fiber_tpu.data.long_tail` / `catalog` on fixtures written in tmp_path:
the mixed, GQA and PhraseCut grounding sets, the caption TSV with pseudo
boxes, the background and ImageNet readers, mixup with the same seed;
field for field and equal.  The two catalogs hold the same names and
specs, and `build_dataset` resolves to the port's readers.  Without PIL
the caption reader raises instead of returning black images."""

import base64
import io
import json
import sys

import numpy as np
import pytest
import torch

from fiber_tpu.data import catalog as jax_catalog
from fiber_tpu.data import long_tail as jax_lt
from fiber_tpu.data.tokenizer import WhitespaceTokenizer as JaxTokenizer
from fiber_torch.data import catalog, coco_datasets, long_tail as lt, tsv
from fiber_torch.data.tokenizer import WhitespaceTokenizer

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(1)


def assert_items_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, (np.ndarray, np.generic)):
            assert isinstance(y, (np.ndarray, np.generic)), k
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y) and x == y, k


def _img(path, w=48, h=32, seed=0):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)


def _modulated_json(tmp_path, extra=None, n=3):
    images, annotations = [], []
    for i in range(n):
        rec = {"id": i + 1, "file_name": f"{i:04d}.jpg", "height": 32,
               "width": 48, "caption": "a red dog chasing a blue car"}
        rec.update(extra(i) if extra else {})
        images.append(rec)
        for j in range(1 + i % 2):
            annotations.append({
                "id": 10 * i + j + 1, "image_id": i + 1, "category_id": 1,
                "bbox": [2.0 + j, 2.0, 20.0, 15.0], "area": 300.0,
                "iscrowd": 0, "tokens_positive": [[6, 9]] if j == 0
                else [[2, 5], [21, 25]]})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "dog"}]}))
    return str(ann)


def _images(root, n, seed=0):
    root.mkdir(exist_ok=True)
    for i in range(n):
        _img(root / f"{i:04d}.jpg", seed=seed + i)
    return str(root)


def _pairs(port, jax):
    assert len(port) == len(jax)
    for i in range(len(port)):
        assert_items_equal(port[i], jax[i])


def test_mixed_dataset_matches_jax(tmp_path):
    coco = _images(tmp_path / "coco", 3)
    vg = _images(tmp_path / "vg", 3, seed=10)
    ann = _modulated_json(
        tmp_path, lambda i: {"data_source": "coco" if i % 2 == 0 else "vg"})
    port = lt.MixedGroundingDataset(coco, vg, ann, WhitespaceTokenizer(),
                                    max_query_len=16)
    jax = jax_lt.MixedGroundingDataset(coco, vg, ann, JaxTokenizer(),
                                       max_query_len=16)
    _pairs(port, jax)
    np.testing.assert_array_equal(
        port[1]["image"], np.asarray(Image.open(tmp_path / "vg/0001.jpg")))
    assert port.img_folder == coco


def test_gqa_and_phrasecut_match_jax(tmp_path):
    root = _images(tmp_path / "img", 4)
    ann = _modulated_json(
        tmp_path, lambda i: {"answer": ["yes", "dog", "weird", "red"][i],
                             "question_type": ["obj", "attr", "rel",
                                               "global"][i]}, n=4)
    a2id = tmp_path / "answer2id.json"
    a2id.write_text(json.dumps({"yes": 0, "dog": 1, "unknown": 2}))
    by_type = tmp_path / "answer2id_by_type.json"
    by_type.write_text(json.dumps({
        "answer_attr": {"dog": 5, "unknown": 0},
        "answer_rel": {"unknown": 0}, "answer_global": {"red": 3},
        "answer_cat": {"unknown": 0}}))
    for kw in (dict(), dict(answer2id_file=str(a2id)),
               dict(answer2id_file=str(a2id),
                    answer2id_by_type_file=str(by_type))):
        _pairs(lt.GQAGroundingDataset(root, ann, WhitespaceTokenizer(),
                                      max_query_len=16, **kw),
               jax_lt.GQAGroundingDataset(root, ann, JaxTokenizer(),
                                          max_query_len=16, **kw))
    _pairs(lt.PhrasecutDataset(root, ann, WhitespaceTokenizer(),
                               max_query_len=16),
           jax_lt.PhrasecutDataset(root, ann, JaxTokenizer(),
                                   max_query_len=16))


def _caption_tsv(tmp_path, rows):
    lines = []
    for key, anno, blob in rows:
        if blob is None:
            buf = io.BytesIO()
            Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(
                buf, format="PNG")
            blob = base64.b64encode(buf.getvalue()).decode()
        lines.append(f"{key}\t{json.dumps(anno)}\t{blob}")
    p = tmp_path / "cap.tsv"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


CAPTION = {"caption": "a dog and a car", "img_h": 8, "img_w": 8,
           "tokens_positive": [[[2, 5]], [[12, 15]], [[2, 5]]],
           "bboxes": [[0, 0, 6, 6], [0.2, 0.1, 6.1, 6.2], [1, 1, 7, 7]],
           "scores": [0.9, 0.8, 0.3]}


@pytest.mark.parametrize("kw", [dict(), dict(score_thresh=0.5),
                                dict(score_thresh=0.5, nms_thresh=0.7),
                                dict(nms_thresh=0.5), dict(caption_min_box=3)])
def test_caption_pseudo_box_dataset_matches_jax(tmp_path, kw):
    """Score filter, NMS, min-box check, and a blob that does not decode
    (the zero image in both)."""
    path = _caption_tsv(tmp_path, [
        ("img0", CAPTION, None),
        ("img1", dict(CAPTION, img_h=5, img_w=7), "bm90IGFuIGltYWdl"),
        ("img2", {"caption": "x", "img_h": 8, "img_w": 8, "bboxes": [],
                  "tokens_positive": [], "scores": []}, None)])
    port = lt.CaptionPseudoBoxDataset(path, WhitespaceTokenizer(),
                                      max_query_len=16, **kw)
    jax = jax_lt.CaptionPseudoBoxDataset(path, JaxTokenizer(),
                                         max_query_len=16, **kw)
    assert len(port) == len(jax) == 3
    got = {}
    for i in range(3):
        try:
            want = jax[i]
        except IndexError:
            with pytest.raises(IndexError):
                port[i]
            continue
        got[i] = port[i]
        assert_items_equal(got[i], want)
    assert 0 in got
    if 1 in got:
        assert got[1]["image"].shape == (5, 7, 3)
        assert not got[1]["image"].any()


def test_caption_reader_raises_without_pil(tmp_path, monkeypatch):
    """A missing PIL raises (JAX's reader would return a black image)."""
    path = _caption_tsv(tmp_path, [("img0", CAPTION, None)])
    ds = lt.CaptionPseudoBoxDataset(path, WhitespaceTokenizer(),
                                    max_query_len=16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        ds[0]


def test_nms_keep_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (30, 2))], 1
                           ).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, 30), 1).astype(np.float32)
    for thr in (0.3, 0.5, 0.9):
        got = lt._nms_keep(boxes, scores, thr)
        want = jax_lt._nms_keep(boxes, scores, thr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_background_and_imagenet_match_jax(tmp_path):
    root = tmp_path / "img"
    root.mkdir()
    for i in range(3):
        _img(root / f"{i}.jpg", seed=i)
    bg_ann = tmp_path / "bg.json"
    bg_ann.write_text(json.dumps(
        {"images": [{"id": 5, "file_name": "0.jpg"},
                    {"file_name": "2.jpg"}]}))
    _pairs(lt.BackgroundDataset(str(bg_ann), str(root)),
           jax_lt.BackgroundDataset(str(bg_ann), str(root)))
    for data in ([{"file_name": "0.jpg", "label": 3},
                  {"file_name": "1.jpg", "label": 7},
                  {"file_name": "2.jpg", "label": 7}],
                 {"images": [{"file_name": "1.jpg", "label": 4},
                             {"file_name": "2.jpg"}]}):
        ann = tmp_path / "in.json"
        ann.write_text(json.dumps(data))
        port = lt.ImagenetClassificationDataset(str(ann), str(root))
        jax = jax_lt.ImagenetClassificationDataset(str(ann), str(root))
        _pairs(port, jax)
        _pairs(port.select_class([7, 0]), jax.select_class([7, 0]))


class _Tiny:
    def __len__(self):
        return 5

    def __getitem__(self, i):
        return {"image": np.full((10 + i, 12 - i, 3), 50.0 * (i + 1),
                                 np.float32),
                "height": 10 + i, "width": 12 - i,
                "boxes": np.array([[1.0, 1.0, 5.0, 5.0]] * (1 + i % 2)),
                "labels": np.arange(1 + i % 2, dtype=np.int32) + i,
                "positive_map": np.eye(1 + i % 2, 4, dtype=np.float32)}


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_mixup_matches_jax_with_the_same_seed(seed):
    """The same seed draws the same lambdas and partners (numpy's
    default_rng in both), including draws at lambda = 1."""
    for alpha, beta in ((1.5, 1.5), (20.0, 0.05)):
        port = lt.MixupDetectionDataset(_Tiny(), alpha, beta, seed=seed)
        jax = jax_lt.MixupDetectionDataset(_Tiny(), alpha, beta, seed=seed)
        for i in (0, 3, 1, 4, 2, 0):
            assert_items_equal(port[i], jax[i])


def test_catalogs_hold_the_same_names_and_specs():
    assert catalog.DatasetCatalog.names() == jax_catalog.DatasetCatalog.names()
    assert catalog.DatasetCatalog.set == catalog.DatasetCatalog.register
    for name in catalog.DatasetCatalog.names():
        p, j = catalog.DatasetCatalog.get(name), \
            jax_catalog.DatasetCatalog.get(name)
        assert (p.factory, p.args, p.task) == (j.factory, j.args, j.task), \
            name


def test_catalog_data_root_from_the_environment(monkeypatch):
    monkeypatch.setattr(catalog.DatasetCatalog, "DATA_ROOT", "/data/x")
    spec = catalog.DatasetCatalog.get("coco_2017_val")
    assert spec.args["ann_file"] == \
        "/data/x/coco/annotations/instances_val2017.json"
    with pytest.raises(KeyError):
        catalog.DatasetCatalog.get("no_such_dataset")


def test_build_dataset_resolves_to_the_port_readers(tmp_path, monkeypatch):
    """Each factory kind and name routing, against JAX's build of the same
    registration: the port's classes, the same items."""
    monkeypatch.setattr(catalog.DatasetCatalog, "_REGISTRY",
                        dict(catalog.DatasetCatalog._REGISTRY))
    monkeypatch.setattr(jax_catalog.DatasetCatalog, "_REGISTRY",
                        dict(jax_catalog.DatasetCatalog._REGISTRY))
    root = _images(tmp_path / "img", 3)
    ann = _modulated_json(tmp_path)
    bg_ann = tmp_path / "bg.json"
    bg_ann.write_text(json.dumps({"images": [{"id": 1,
                                              "file_name": "0000.jpg"}]}))
    in_ann = tmp_path / "in.json"
    in_ann.write_text(json.dumps([{"file_name": "0001.jpg", "label": 2}]))
    cap = _caption_tsv(tmp_path, [("img0", CAPTION, None)])
    det_tsv = tmp_path / "det.tsv"
    det_tsv.write_text("k0\t" + json.dumps(
        {"boxes": [[1, 2, 3, 4]], "labels": [1]}) + "\t\n")
    specs = {
        "unit_modulated": ("jsonl", "grounding",
                           dict(img_root=root, ann_file=ann),
                           coco_datasets.ModulatedCocoDataset),
        "mixed_unit": ("jsonl", "grounding",
                       dict(img_root=root, ann_file=ann),
                       lt.MixedGroundingDataset),
        "gqa_unit": ("jsonl", "grounding",
                     dict(img_root=root, ann_file=ann),
                     lt.GQAGroundingDataset),
        "phrasecut_unit": ("jsonl", "grounding",
                           dict(img_root=root, ann_file=ann),
                           lt.PhrasecutDataset),
        "unit_coco_det": ("coco_json", "detection",
                          dict(img_root=root, ann_file=ann),
                          coco_datasets.CocoDetectionDataset),
        "unit_coco_grounding": ("coco_json", "grounding",
                                dict(img_root=root, ann_file=ann),
                                coco_datasets.CocoGroundingDataset),
        "unit_bg": ("background", "detection",
                    dict(img_root=root, ann_file=str(bg_ann)),
                    lt.BackgroundDataset),
        "unit_imagenet": ("imagenet", "classification",
                          dict(img_root=root, ann_file=str(in_ann)),
                          lt.ImagenetClassificationDataset),
        "unit_caption_tsv": ("tsv", "caption", dict(tsv_path=cap),
                             lt.CaptionPseudoBoxDataset),
        "unit_det_tsv": ("tsv", "detection", dict(tsv_path=str(det_tsv)),
                         tsv.TsvDetectionDataset),
    }
    deterministic = {"unit_coco_det", "unit_bg", "unit_imagenet",
                     "unit_modulated", "mixed_unit", "gqa_unit",
                     "phrasecut_unit", "unit_caption_tsv"}
    for name, (factory, task, args, cls) in specs.items():
        catalog.DatasetCatalog.set(name, catalog.DatasetSpec(
            factory=factory, args=args, task=task))
        jax_catalog.DatasetCatalog.set(name, jax_catalog.DatasetSpec(
            factory=factory, args=args, task=task))
        tok = (WhitespaceTokenizer() if task in ("grounding", "caption")
               else None)
        jtok = JaxTokenizer() if tok is not None else None
        port = catalog.build_dataset(name, tok, max_query_len=16)
        jax = jax_catalog.build_dataset(name, jtok, max_query_len=16)
        assert type(port) is cls, name
        assert type(jax).__name__ == cls.__name__, name
        assert type(port).__module__.startswith("fiber_torch.")
        if name in deterministic:
            _pairs(port, jax)
    catalog.DatasetCatalog.set("unit_bad", catalog.DatasetSpec(
        factory="parquet", args={}, task="caption"))
    with pytest.raises(ValueError):
        catalog.build_dataset("unit_bad")
