"""Offline data prep: JSON annotations + image files -> .arrow tables.

The equivalent of the reference's write_* scripts
(fiber/utils/write_{coco_karpathy,vqa,nlvr2,f30k,...}.py): one generic
converter producing the same on-disk pyarrow layout the reference
datasets read (columns: image bytes, caption list<str>, image_id, split,
plus task extras), so data prepared for either framework is
interchangeable.

The port's copy of `fiber_tpu/data/prepare.py`; pyarrow is imported inside
the writers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence


def make_arrow(records: Iterable[Dict], out_path: str,
               extra_columns: Sequence[str] = ()) -> int:
    """records: dicts with keys `image_path`, `caption` (str or list),
    `image_id`, `split`, plus any `extra_columns` (e.g. vqa labels).
    Returns the number of rows written."""
    rows = {k: [] for k in
            ("image", "caption", "image_id", "split", *extra_columns)}
    n = 0
    for rec in records:
        with open(rec["image_path"], "rb") as f:
            rows["image"].append(f.read())
        cap = rec.get("caption", "")
        rows["caption"].append(cap if isinstance(cap, list) else [cap])
        rows["image_id"].append(rec.get("image_id", n))
        rows["split"].append(rec.get("split", "train"))
        for k in extra_columns:
            rows[k].append(rec.get(k))
        n += 1
    return _write_table(rows, out_path)


def coco_karpathy_records(karpathy_json: str, image_root: str,
                          split: str,
                          include_restval: bool = False) -> Iterable[Dict]:
    """Karpathy-split COCO captions (ref write_coco_karpathy.py).

    The reference deliberately trains WITHOUT the karpathy 'restval'
    images ("removing restval does not hurt the model performance",
    coco_caption_karpathy_dataset.py:12-17); include_restval=True folds
    them into train for parity with other codebases that keep them."""
    with open(karpathy_json) as f:
        data = json.load(f)
    for img in data["images"]:
        if img["split"] != split and not (
                include_restval and split == "train"
                and img["split"] == "restval"):
            continue
        yield {
            "image_path": os.path.join(image_root, img.get("filepath", ""),
                                       img["filename"]),
            "caption": [s["raw"] for s in img["sentences"]],
            "image_id": img.get("cocoid", img.get("imgid")),
            "split": split,
        }


def f30k_karpathy_records(karpathy_json: str, image_root: str,
                          split: str) -> Iterable[Dict]:
    """Karpathy-split Flickr30k captions (ref write_f30k_karpathy.py:
    flat image dir, split taken from the json; reference train merges
    val via the dataset class, not the writer)."""
    with open(karpathy_json) as f:
        data = json.load(f)
    for img in data["images"]:
        if img["split"] != split:
            continue
        yield {
            "image_path": os.path.join(image_root, img["filename"]),
            "caption": [s["raw"] for s in img["sentences"]],
            "image_id": img["filename"],
            "split": split,
        }


def conceptual_caption_records(annot_json: str, image_root: str,
                               split: str) -> Iterable[Dict]:
    """Conceptual Captions / SBU annot format: a json list of
    [downloaded_path, caption] pairs (ref write_conceptual_caption.py /
    write_sbu.py — one caption per image, file name is the id)."""
    with open(annot_json) as f:
        pairs = json.load(f)
    for path, caption in pairs:
        name = os.path.basename(path)
        full = os.path.join(image_root, name)
        if not os.path.exists(full):
            full = path  # already absolute
        yield {
            "image_path": full,
            "caption": [caption],
            "image_id": name,
            "split": split,
        }


sbu_records = conceptual_caption_records  # identical layout (write_sbu.py)


def vg_records(region_json: str, image_root: str) -> Iterable[Dict]:
    """Visual Genome region descriptions (ref write_vg.py): per image,
    the region phrases as captions plus per-region box extras
    (width/height/x/y columns)."""
    from collections import defaultdict
    with open(region_json) as f:
        data = json.load(f)
    by_img = defaultdict(list)
    for entry in data:
        for r in entry["regions"]:
            by_img[r["image_id"]].append(r)
    for iid, regions in by_img.items():
        yield {
            "image_path": os.path.join(image_root, f"{iid}.jpg"),
            "caption": [r["phrase"] for r in regions],
            "image_id": str(iid),
            "split": "train",
            "width": [r["width"] for r in regions],
            "height": [r["height"] for r in regions],
            "x": [r["x"] for r in regions],
            "y": [r["y"] for r in regions],
        }


def write_vqa_arrow(questions_json: str, annotations_json: Optional[str],
                    image_root: str, image_template: str,
                    answer_vocab: Dict[str, int], split: str,
                    out_path: str) -> int:
    """VQAv2 -> reference arrow layout (write_vqa.py): rows grouped per
    IMAGE with list columns questions / question_id and list-of-list
    answers / answer_labels / answer_scores — the layout
    data/task_datasets.VQAv2Dataset reads."""
    import pyarrow as pa
    from collections import Counter, defaultdict
    from fiber_torch.data.vqa import normalize_answer, vqa_soft_score

    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    annos = {}
    if annotations_json:
        with open(annotations_json) as f:
            for a in json.load(f)["annotations"]:
                annos[a["question_id"]] = a

    by_img = defaultdict(list)
    for q in questions:
        by_img[q["image_id"]].append(q)

    rows = {k: [] for k in ("image", "questions", "question_id", "answers",
                            "answer_labels", "answer_scores", "image_id",
                            "split")}
    for iid, qs in by_img.items():
        path = os.path.join(image_root, image_template.format(iid))
        with open(path, "rb") as f:
            rows["image"].append(f.read())
        qtexts, qids, answers, labels, scores = [], [], [], [], []
        for q in qs:
            qtexts.append(q["question"])
            qids.append(q["question_id"])
            ans, lab, sco = [], [], []
            if q["question_id"] in annos:
                counts = Counter(normalize_answer(a["answer"]) for a in
                                 annos[q["question_id"]]["answers"])
                # answers stay PARALLEL to labels/scores: the reference
                # writer derives answers from the vocab-filtered labels
                # (write_vqa.py), so consumers may zip the three lists
                for a, c in counts.items():
                    if a in answer_vocab:
                        ans.append(a)
                        lab.append(answer_vocab[a])
                        sco.append(vqa_soft_score(c))
            answers.append(ans)
            labels.append(lab)
            scores.append(sco)
        rows["questions"].append(qtexts)
        rows["question_id"].append(qids)
        rows["answers"].append(answers)
        rows["answer_labels"].append(labels)
        rows["answer_scores"].append(scores)
        rows["image_id"].append(iid)
        rows["split"].append(split)
    return _write_table(rows, out_path)


def write_nlvr2_arrow(jsonl_path: str, image_root: str, split: str,
                      out_path: str) -> int:
    """NLVR2 -> reference arrow layout (write_nlvr2.py): both pair
    images as byte columns image_0/image_1, sentences under `questions`,
    string answers — the layout data/task_datasets.NLVR2Dataset reads."""
    from collections import defaultdict
    groups = defaultdict(lambda: {"questions": [], "answers": []})
    with open(jsonl_path) as f:
        for line in f:
            ex = json.loads(line)
            base = "-".join(ex["identifier"].split("-")[:-1])
            groups[base]["questions"].append(ex["sentence"])
            groups[base]["answers"].append(str(ex["label"]))

    rows = {k: [] for k in ("image_0", "image_1", "questions", "answers",
                            "image_id", "split")}
    for base, g in groups.items():
        for col, suffix in (("image_0", "img0"), ("image_1", "img1")):
            with open(os.path.join(image_root, f"{base}-{suffix}.png"),
                      "rb") as f:
                rows[col].append(f.read())
        rows["questions"].append(g["questions"])
        rows["answers"].append(g["answers"])
        rows["image_id"].append(base)
        rows["split"].append(split)
    return _write_table(rows, out_path)


def _write_table(rows: Dict[str, list], out_path: str) -> int:
    import pyarrow as pa
    table = pa.table(rows)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with pa.OSFile(out_path, "wb") as sink:
        with pa.RecordBatchFileWriter(sink, table.schema) as writer:
            writer.write_table(table)
    return table.num_rows


def vqa_records(questions_json: str, annotations_json: Optional[str],
                image_root: str, image_template: str,
                answer_vocab: Dict[str, int], split: str
                ) -> Iterable[Dict]:
    """VQAv2 -> records with question/labels/scores extras
    (ref write_vqa.py)."""
    from fiber_torch.data.vqa import normalize_answer, vqa_soft_score
    from collections import Counter
    with open(questions_json) as f:
        questions = {q["question_id"]: q
                     for q in json.load(f)["questions"]}
    annos = {}
    if annotations_json:
        with open(annotations_json) as f:
            for a in json.load(f)["annotations"]:
                annos[a["question_id"]] = a
    for qid, q in questions.items():
        labels, scores = [], []
        if qid in annos:
            counts = Counter(normalize_answer(ans["answer"])
                             for ans in annos[qid]["answers"])
            for ans, c in counts.items():
                if ans in answer_vocab:
                    labels.append(answer_vocab[ans])
                    scores.append(vqa_soft_score(c))
        yield {
            "image_path": os.path.join(
                image_root, image_template.format(q["image_id"])),
            "caption": q["question"],
            "image_id": q["image_id"],
            "split": split,
            "question_id": qid,
            "answer_labels": labels,
            "answer_scores": scores,
        }


def nlvr2_records(jsonl_path: str, image_root: str, split: str
                  ) -> Iterable[Dict]:
    """NLVR2 paired-image records (ref write_nlvr2.py): image column holds
    the left image; `image_1_path` extra carries the right one."""
    with open(jsonl_path) as f:
        for line in f:
            ex = json.loads(line)
            ident = ex["identifier"]  # e.g. split-setid-pairid-sentid
            base = "-".join(ident.split("-")[:-1])
            yield {
                "image_path": os.path.join(image_root, f"{base}-img0.png"),
                "image_1_path": os.path.join(image_root,
                                             f"{base}-img1.png"),
                "caption": ex["sentence"],
                "image_id": ident,
                "split": split,
                "answers": 1 if ex["label"] == "True" else 0,
            }
