"""The port's host data pipeline (`fiber_torch/data/`) against
`fiber_tpu/data/` on the CPU: on the same inputs and numpy seeds every
output must be equal, exactly.  The tests write their own fixtures (PNG
images, Karpathy / VQA / NLVR2 annotations, arrow and TSV files, a tiny BPE
vocab); those that need pyarrow, PIL or transformers skip without them."""

import base64
import io
import json
import os

import numpy as np
import pytest
import torch

from fiber_tpu.data import arrow_dataset as j_arrow
from fiber_tpu.data import mlm as j_mlm
from fiber_tpu.data import multitask as j_multitask
from fiber_tpu.data import tokenizer as j_tok
from fiber_tpu.data import vqa as j_vqa
from fiber_torch.data import arrow_dataset as t_arrow
from fiber_torch.data import mlm as t_mlm
from fiber_torch.data import multitask as t_multitask
from fiber_torch.data import tokenizer as t_tok
from fiber_torch.data import vqa as t_vqa

torch.set_num_threads(1)


def assert_same(a, b, where=""):
    """Recursive exact equality of dicts, lists, arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ---------------------------------------------------------------------------
# numpy-only modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_mlm_mask_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 100, (16, 24))
    special = rng.random(ids.shape) < 0.2
    got = t_mlm.mlm_mask(ids, special, 100, 4, np.random.default_rng(seed))
    want = j_mlm.mlm_mask(ids, special, 100, 4, np.random.default_rng(seed))
    assert_same(list(got), list(want))
    assert (got[1][special] == t_mlm.IGNORE_INDEX).all()


def test_sharded_iterator_equals_jax_disjoint_and_deterministic():
    n, bs, hosts = 37, 4, 3
    per_epoch = []
    for host in range(hosts):
        a = iter(t_arrow.ShardedBatchIterator(n, bs, host, hosts, seed=5))
        b = iter(j_arrow.ShardedBatchIterator(n, bs, host, hosts, seed=5))
        c = iter(t_arrow.ShardedBatchIterator(n, bs, host, hosts, seed=5))
        got = [next(a) for _ in range(8)]
        assert_same(got, [next(b) for _ in range(8)])
        assert_same(got, [next(c) for _ in range(8)])
        per_epoch.append(np.concatenate(got[:3]))      # 12 // 4 an epoch
    flat = np.concatenate(per_epoch)
    assert len(set(flat.tolist())) == len(flat)          # disjoint hosts


def test_multitask_iterator_equals_jax():
    got = t_multitask.MultitaskIterator([10, 30, 7], 3, seed=2)
    want = j_multitask.MultitaskIterator([10, 30, 7], 3, seed=2)
    for _ in range(25):
        (d1, i1), (d2, i2) = next(got), next(want)
        assert d1 == d2
        assert_same(i1, i2)


TEXTS = ["A dog, on the grass!", "two cats", "", "the dog's ball is red " * 4]


def test_whitespace_tokenizer_equals_jax():
    got, want = t_tok.WhitespaceTokenizer(), j_tok.WhitespaceTokenizer()
    assert_same(got.batch(TEXTS, max_length=12),
                want.batch(TEXTS, max_length=12))
    assert_same(got(TEXTS[0], return_offsets_mapping=True, max_length=8,
                    padding="max_length"),
                want(TEXTS[0], return_offsets_mapping=True, max_length=8,
                     padding="max_length"))
    assert got.vocab == want.vocab and got.vocab_size == want.vocab_size
    frozen = t_tok.WhitespaceTokenizer(got.vocab, frozen=True)
    assert frozen("unknown words")["input_ids"][1] == frozen.unk_token_id


def test_get_tokenizer_falls_back_like_jax(tmp_path):
    with pytest.warns(UserWarning, match="WhitespaceTokenizer"):
        got = t_tok.get_tokenizer(str(tmp_path / "missing"))
    with pytest.warns(UserWarning):
        want = j_tok.get_tokenizer(str(tmp_path / "missing"))
    assert type(got).__name__ == type(want).__name__ == "WhitespaceTokenizer"


def test_bpe_tokenizer_from_local_files_equals_jax(tmp_path):
    pytest.importorskip("transformers")
    chars = list("abcdefghijklmnopqrstuvwxyz.,'!") + ["Ġ"]
    merged = ["do", "dog", "ca", "car", "Ġd", "Ġdo", "Ġdog", "Ġc", "Ġca",
              "Ġcar", "th", "the", "Ġt", "Ġth", "Ġthe"]
    merges = ["d o", "do g", "c a", "ca r", "Ġ d", "Ġd o", "Ġdo g", "Ġ c",
              "Ġc a", "Ġca r", "t h", "th e", "Ġ t", "Ġt h", "Ġth e"]
    specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    vocab = {t: i for i, t in enumerate(specials + chars + merged)}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n"
                                         + "\n".join(merges) + "\n")
    got = t_tok.get_tokenizer(str(tmp_path))
    want = j_tok.get_tokenizer(str(tmp_path))
    assert type(got).__name__ == "RobertaTokenizerFast"
    texts = ["the dog. the car.", "a cat, a dog's car!", "dogcar"]
    kw = dict(max_length=16, padding="max_length", truncation=True,
              return_offsets_mapping=True)
    a, b = got(texts, **kw), want(texts, **kw)
    for k in ("input_ids", "attention_mask", "offset_mapping"):
        assert a[k] == b[k], k
    assert got.mask_token_id == want.mask_token_id


ANSWERS = ["Two", "two.", "the dog", "A dog!", "dont know", "1,000", "3.5",
           "yes", "Yes ", "none", "isnt it", "red-blue"]


def test_vqa_helpers_equal_jax(tmp_path):
    assert [t_vqa.normalize_answer(a) for a in ANSWERS] == \
        [j_vqa.normalize_answer(a) for a in ANSWERS]
    assert [t_vqa.vqa_soft_score(c) for c in range(6)] == \
        [j_vqa.vqa_soft_score(c) for c in range(6)]
    annotations = [ANSWERS[:5], ANSWERS[3:9], ANSWERS[1:3] * 3]
    vocab = t_vqa.build_answer_vocab(annotations, size=5)
    assert vocab == j_vqa.build_answer_vocab(annotations, size=5)
    labels, scores = [[0, 3], [], [4]], [[1.0, 0.3], [], [0.6]]
    assert_same(t_vqa.dense_vqa_targets(labels, scores, 5),
                j_vqa.dense_vqa_targets(labels, scores, 5))
    for writer, args in (("write_vqa_submission", ([3, 1], ["yes", "2"])),
                         ("write_caption_submission",
                          ([5, 2, 5], ["a", "b", "c"]))):
        paths = [str(tmp_path / f"{writer}_{p}.json") for p in ("t", "j")]
        getattr(t_vqa, writer)(*args, paths[0])
        getattr(j_vqa, writer)(*args, paths[1])
        assert open(paths[0]).read() == open(paths[1]).read()


# ---------------------------------------------------------------------------
# images, arrow and TSV files
# ---------------------------------------------------------------------------
def _save_png(path, rng, h, w):
    from PIL import Image
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        path)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Images and annotation files in the layouts the prepare scripts
    read."""
    pytest.importorskip("PIL")
    root = tmp_path_factory.mktemp("raw")
    img = root / "images"
    img.mkdir()
    rng = np.random.default_rng(0)
    karpathy = {"images": []}
    for i, split in enumerate(["train", "train", "val", "test", "restval"]):
        name = f"COCO_{i}.png"
        _save_png(img / name, rng, 30 + 7 * i, 50 - 4 * i)
        karpathy["images"].append({
            "filename": name, "filepath": "", "split": split, "cocoid": i,
            "imgid": 100 + i, "sentences": [{"raw": f"a picture {i}"},
                                            {"raw": f"scene number {i}."}]})
    (root / "karpathy.json").write_text(json.dumps(karpathy))
    (root / "cc.json").write_text(json.dumps(
        [[str(img / "COCO_0.png"), "a conceptual caption"],
         ["/elsewhere/COCO_1.png", "another one"]]))
    (root / "vg.json").write_text(json.dumps([{"regions": [
        {"image_id": 0, "phrase": "a red thing", "width": 3, "height": 4,
         "x": 1, "y": 2},
        {"image_id": 0, "phrase": "blue sky", "width": 5, "height": 6,
         "x": 0, "y": 0},
        {"image_id": 1, "phrase": "green", "width": 1, "height": 1,
         "x": 3, "y": 3}]}]))
    for iid in (0, 1):
        _save_png(img / f"{iid}.jpg", rng, 20, 24)
    questions = [{"image_id": i % 3, "question_id": 10 + i,
                  "question": f"what is {i}?"} for i in range(5)]
    (root / "q.json").write_text(json.dumps({"questions": questions}))
    annotations = [{"question_id": 10 + i, "answers": [
        {"answer": a} for a in ANSWERS[i:i + 10]]} for i in range(5)]
    (root / "a.json").write_text(json.dumps({"annotations": annotations}))
    for i in range(3):
        _save_png(img / f"vqa_{i}.png", rng, 26 + i, 33)
    lines = []
    for s in range(2):
        for k in range(2):
            lines.append(json.dumps({"identifier": f"dev-{s}-0-{k}",
                                     "sentence": f"claim {s} {k}",
                                     "label": ["True", "False"][(s + k) % 2]}))
        for side in (0, 1):
            _save_png(img / f"dev-{s}-0-img{side}.png", rng, 22, 30 + side)
    (root / "nlvr2.jsonl").write_text("\n".join(lines) + "\n")
    return root


def _record_calls(raw):
    img, vocab = str(raw / "images"), {"2": 0, "yes": 1, "dog": 2}
    return [
        ("coco_karpathy_records", (str(raw / "karpathy.json"), img, "train")),
        ("coco_karpathy_records", (str(raw / "karpathy.json"), img, "train",
                                   True)),
        ("f30k_karpathy_records", (str(raw / "karpathy.json"), img, "test")),
        ("conceptual_caption_records", (str(raw / "cc.json"), img, "train")),
        ("vg_records", (str(raw / "vg.json"), img)),
        ("vqa_records", (str(raw / "q.json"), str(raw / "a.json"), img,
                         "vqa_{}.png", vocab, "train")),
        ("nlvr2_records", (str(raw / "nlvr2.jsonl"), img, "dev")),
    ]


def test_prepare_records_equal_jax(raw):
    from fiber_tpu.data import prepare as j_prep
    from fiber_torch.data import prepare as t_prep
    for fn, args in _record_calls(raw):
        got = list(getattr(t_prep, fn)(*args))
        assert got, fn
        assert_same(got, list(getattr(j_prep, fn)(*args)), fn)


def _write_arrows(prep, raw, out):
    """Every writer of `prep` into `out`, named as the task datasets
    read them."""
    img = str(raw / "images")
    os.makedirs(out, exist_ok=True)
    for split in ("train", "val", "test"):
        recs = prep.coco_karpathy_records(str(raw / "karpathy.json"), img,
                                          split)
        prep.make_arrow(recs, os.path.join(
            out, f"coco_caption_karpathy_{split}.arrow"))
    vocab = {"2": 0, "yes": 1, "dog": 2}
    for split in ("train", "val"):
        prep.write_vqa_arrow(str(raw / "q.json"), str(raw / "a.json"), img,
                             "vqa_{}.png", vocab, split,
                             os.path.join(out, f"vqav2_{split}.arrow"))
    prep.write_nlvr2_arrow(str(raw / "nlvr2.jsonl"), img, "train",
                           os.path.join(out, "nlvr2_train.arrow"))
    recs = prep.vg_records(str(raw / "vg.json"), img)
    prep.make_arrow(recs, os.path.join(out, "vg.arrow"),
                    extra_columns=("width", "height", "x", "y"))


@pytest.fixture(scope="module")
def arrows(raw, tmp_path_factory):
    """(the port's arrow directory, JAX's), written from the same raw
    files."""
    pytest.importorskip("pyarrow")
    from fiber_tpu.data import prepare as j_prep
    from fiber_torch.data import prepare as t_prep
    ours = str(tmp_path_factory.mktemp("arrow_port"))
    theirs = str(tmp_path_factory.mktemp("arrow_jax"))
    _write_arrows(t_prep, raw, ours)
    _write_arrows(j_prep, raw, theirs)
    return ours, theirs


def test_prepare_arrow_files_equal_jax(arrows):
    import pyarrow as pa
    ours, theirs = arrows
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 7
    for name in names:
        tables = []
        for d in (ours, theirs):
            with pa.memory_map(os.path.join(d, name), "r") as src:
                tables.append(pa.ipc.RecordBatchFileReader(src).read_all())
        assert tables[0].num_rows > 0
        assert tables[0].equals(tables[1]), name


@pytest.mark.parametrize("train", [False, True])
def test_arrow_dataset_images_equal_jax(arrows, train):
    path = [os.path.join(arrows[0], "coco_caption_karpathy_train.arrow")]
    got, want = t_arrow.ArrowCaptionDataset(path), \
        j_arrow.ArrowCaptionDataset(path)
    assert len(got) == len(want) == 4 and got.index == want.index
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(len(got)):
        assert got.get_caption(i) == want.get_caption(i)
        assert_same(got.get_image(i, 40, train=train, rng=r1),
                    want.get_image(i, 40, train=train, rng=r2))
        assert_same(list(got.stage_image(i, 48)),
                    list(want.stage_image(i, 48)))


def test_resize_image_and_randaug_equal_jax():
    pytest.importorskip("PIL")
    from PIL import Image
    from fiber_tpu.data import randaug as j_randaug
    from fiber_tpu.data import transforms as j_transforms
    from fiber_torch.data import randaug as t_randaug
    from fiber_torch.data import transforms as t_transforms
    rng = np.random.default_rng(9)
    img = Image.fromarray(rng.integers(0, 256, (45, 61, 3), dtype=np.uint8))
    for train in (False, True):
        for seed in range(4):
            assert_same(t_transforms.resize_image(
                img, 32, train, np.random.default_rng(seed)),
                j_transforms.resize_image(img, 32, train,
                                          np.random.default_rng(seed)))
    drawn = set()
    for seed in range(40):
        r = np.random.default_rng(seed)
        drawn.update(int(r.integers(len(t_randaug.OPS))) for _ in range(2))
        got = t_randaug.rand_augment(img, 2, 7, np.random.default_rng(seed))
        want = j_randaug.rand_augment(img, 2, 7, np.random.default_rng(seed))
        assert_same(np.asarray(got), np.asarray(want))
    assert len(t_randaug.OPS) == len(j_randaug.OPS) == 14
    assert len(drawn) == 14


def _sample_lists(ds, n):
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("task,split,kw", [
    ("coco", "train", dict(draw_false_image=1, draw_false_text=1)),
    ("coco", "test", dict(image_only=True)),
    ("vqav2", "train", {}),
    ("vqav2", "val", dict(train=True)),
    ("nlvr2", "train", {}),
])
def test_task_datasets_equal_jax(arrows, task, split, kw):
    from fiber_tpu.data.task_datasets import build_task_dataset as j_build
    from fiber_torch.data.task_datasets import build_task_dataset as t_build
    got = t_build(task, arrows[0], split, image_size=32, seed=4, **kw)
    want = j_build(task, arrows[0], split, image_size=32, seed=4, **kw)
    assert len(got) == len(want) > 0
    assert_same(_sample_lists(got, len(got)), _sample_lists(want, len(want)))


def test_task_dataset_unknown_and_missing(tmp_path):
    from fiber_torch.data.task_datasets import arrow_paths, \
        build_task_dataset
    with pytest.raises(KeyError):
        build_task_dataset("imagenet", str(tmp_path), "train")
    with pytest.raises(FileNotFoundError):
        arrow_paths(str(tmp_path), "coco", "train")


@pytest.fixture(scope="module")
def tsv_file(tmp_path_factory):
    pytest.importorskip("PIL")
    from PIL import Image
    root = tmp_path_factory.mktemp("tsv")
    rng = np.random.default_rng(1)
    rows = []
    labels = [[{"rect": [1, 2, 5, 6], "class": "dog"}, {"bbox": [0, 0, 3, 3],
                                                        "category_id": 2}],
              {"objects": [{"rect": [2, 2, 4, 4], "class": "cat"},
                           {"no_box": 1}]},
              {"annotations": []}]
    for i, lab in enumerate(labels):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (12 + i, 9, 3),
                                     dtype=np.uint8)).save(buf, format="PNG")
        rows.append(f"key{i}\t{json.dumps(lab)}\t"
                    f"{base64.b64encode(buf.getvalue()).decode()}")
    path = root / "data.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_tsv_equals_jax(tsv_file):
    from fiber_tpu.data import tsv as j_tsv
    from fiber_torch.data import tsv as t_tsv
    got = t_tsv.TsvFile(tsv_file)                   # builds the .lineidx
    assert os.path.exists(tsv_file[:-4] + ".lineidx")
    want = j_tsv.TsvFile(tsv_file)                  # reads it
    assert len(got) == len(want) == 3 and got.offsets == want.offsets
    assert [got.row(i) for i in (2, 0, 1)] == [want.row(i) for i in (2, 0, 1)]
    gd, wd = t_tsv.TsvDetectionDataset(tsv_file), \
        j_tsv.TsvDetectionDataset(tsv_file)
    for i in range(len(gd)):
        a, b = gd[i], wd[i]
        a["image"], b["image"] = np.asarray(a["image"]), np.asarray(b["image"])
        assert_same(a, b)
    assert gd[1]["labels"] == ["cat"]
