"""Dataset catalog: name -> factory + args, with runtime registration.

Behavioral spec: maskrcnn_benchmark/config/paths_catalog.py:30-730
(DatasetCatalog with ~60 named datasets resolved to factory classes and
kwargs, plus `.set()` runtime registration used for custom ODinW
datasets, ref data/build.py:288-300).

Entries describe data *locations* relative to a DATA_ROOT; the actual IO
goes through the arrow/TSV/COCO-json readers in fiber_torch.data.

The port's copy of `fiber_tpu/data/catalog.py`: the same names, factories
and arguments, resolved by `build_dataset` to the port's readers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict


@dataclasses.dataclass
class DatasetSpec:
    factory: str              # reader kind: arrow | coco_json | tsv | jsonl
    args: Dict[str, Any]
    task: str = "caption"     # caption | vqa | nlvr2 | grounding | detection


class DatasetCatalog:
    _REGISTRY: Dict[str, DatasetSpec] = {}
    DATA_ROOT = os.environ.get("FIBER_DATA_ROOT", "data")

    @classmethod
    def register(cls, name: str, spec: DatasetSpec) -> None:
        cls._REGISTRY[name] = spec

    # runtime registration (ref DATASETS.REGISTER / DatasetCatalog.set)
    set = register

    @classmethod
    def get(cls, name: str) -> DatasetSpec:
        if name not in cls._REGISTRY:
            raise KeyError(
                f"unknown dataset '{name}'; known: "
                f"{sorted(cls._REGISTRY)[:20]}...")
        spec = cls._REGISTRY[name]
        args = {k: (os.path.join(cls.DATA_ROOT, v)
                    if isinstance(v, str) and k.endswith(("_file", "_root",
                                                          "_path"))
                    else v)
                for k, v in spec.args.items()}
        return DatasetSpec(factory=spec.factory, args=args, task=spec.task)

    @classmethod
    def names(cls):
        return sorted(cls._REGISTRY)


def _r(name, factory, task, **args):
    DatasetCatalog.register(name, DatasetSpec(factory=factory, args=args,
                                              task=task))


# ---- coarse-grained arrow datasets (ref fiber/datamodules) --------------
for split in ("train", "val", "test"):
    _r(f"coco_caption_karpathy_{split}", "arrow", "caption",
       arrow_path=f"coco_caption_karpathy_{split}.arrow")
    _r(f"f30k_caption_karpathy_{split}", "arrow", "caption",
       arrow_path=f"f30k_caption_karpathy_{split}.arrow")
_r("vg_caption", "arrow", "caption", arrow_path="vg.arrow")
_r("sbu_caption", "arrow", "caption", arrow_path="sbu.arrow")
_r("gcc_caption", "arrow", "caption", arrow_path="conceptual_caption.arrow")
for split in ("train", "val", "test"):
    _r(f"vqav2_{split}", "arrow", "vqa",
       arrow_path=f"vqav2_{split}.arrow")
    _r(f"nlvr2_{split}", "arrow", "nlvr2",
       arrow_path=f"nlvr2_{split}.arrow")

# ---- fine-grained detection/grounding (ref paths_catalog.py) ------------
_r("coco_2017_train", "coco_json", "detection",
   img_root="coco/train2017",
   ann_file="coco/annotations/instances_train2017.json")
_r("coco_2017_val", "coco_json", "detection",
   img_root="coco/val2017",
   ann_file="coco/annotations/instances_val2017.json")
_r("coco_grounding_train", "coco_json", "grounding",
   img_root="coco/train2017",
   ann_file="coco/annotations/instances_train2017.json")
_r("lvis_v1_minival", "coco_json", "detection",
   img_root="coco", ann_file="lvis/lvis_v1_minival.json")
_r("flickr30k_train", "jsonl", "grounding",
   img_root="flickr30k/images",
   ann_file="mdetr_annotations/final_flickr_separateGT_train.json")
_r("flickr30k_val", "jsonl", "grounding",
   img_root="flickr30k/images",
   ann_file="mdetr_annotations/final_flickr_separateGT_val.json")
_r("flickr30k_test", "jsonl", "grounding",
   img_root="flickr30k/images",
   ann_file="mdetr_annotations/final_flickr_separateGT_test.json")
_r("mixed_train_no_coco", "jsonl", "grounding",
   img_root="mixed",
   ann_file="mdetr_annotations/final_mixed_train_no_coco.json")
for name in ("refcoco", "refcoco+", "refcocog"):
    for split in ("train", "val", "testA", "testB", "test"):
        _r(f"{name}_{split}", "jsonl", "grounding",
           img_root="coco/train2014",
           ann_file=f"mdetr_annotations/finetune_{name}_{split}.json")
_r("object365_train", "tsv", "detection",
   tsv_path="object365/train.tsv")

# ---- remaining reference name set (paths_catalog.py:30-730), mapped to
# our readers; COCO-style splits share the coco_json factory ------------
for split, img, ann in (
        ("coco_2014_train", "coco/train2014",
         "coco/annotations/instances_train2014.json"),
        ("coco_2014_val", "coco/val2014",
         "coco/annotations/instances_val2014.json"),
        ("coco_2014_minival", "coco/val2014",
         "coco/annotations/instances_minival2014.json"),
        ("coco_2014_valminusminival", "coco/val2014",
         "coco/annotations/instances_valminusminival2014.json"),
        ("coco_2017_test", "coco/test2017",
         "coco/annotations/image_info_test2017.json"),
        ("coco_keypoint_2017_train", "coco/train2017",
         "coco/annotations/person_keypoints_train2017.json"),
        ("coco_keypoint_2017_val", "coco/val2017",
         "coco/annotations/person_keypoints_val2017.json"),
        ("lvis_train", "coco",
         "lvis/lvis_v1_train.json"),
        ("lvis_val", "coco",
         "lvis/lvis_v1_val.json"),
        ("lvis_evaluation_val", "coco",
         "lvis/lvis_od_val.json"),
        ("lvis_grounding_train", "coco",
         "lvis/lvis_od_train.json"),
        ("object365_dt_train", "object365/images",
         "object365/objects365_train.json"),
        ("imagenetod_train_odinw_2copy_dt", "imagenetod/images",
         "imagenetod/train.json"),
        ("crowdhuman_train", "crowdhuman/images",
         "crowdhuman/annotation_train.json"),
        ("crowdhuman_val", "crowdhuman/images",
         "crowdhuman/annotation_val.json"),
):
    _r(split, "coco_json", "detection", img_root=img, ann_file=ann)

for n in range(1, 11):  # few-shot COCO subsets (coco_2014_train_few*)
    _r(f"coco_2014_train_few{n * 100}", "coco_json", "detection",
       img_root="coco/train2014",
       ann_file=f"coco/annotations/instances_train2014_few{n * 100}.json")

_r("mixed_train", "jsonl", "grounding",
   img_root="mixed",
   ann_file="mdetr_annotations/final_mixed_train.json")
_r("gqa_val", "jsonl", "grounding",
   img_root="gqa/images",
   ann_file="mdetr_annotations/final_gqa_val.json")
_r("phrasecut_train", "jsonl", "grounding",
   img_root="phrasecut/images",
   ann_file="mdetr_annotations/finetune_phrasecut_train.json")
_r("bing_caption_train", "tsv", "caption",
   tsv_path="bing/caption_train.tsv")
for split in ("train", "val", "test"):
    _r(f"cityscapes_fine_instanceonly_seg_{split}_cocostyle", "coco_json",
       "detection", img_root=f"cityscapes/{split}",
       ann_file=f"cityscapes/annotations/instancesonly_{split}.json")
# ODinW 13/35 datasets register at runtime through DatasetCatalog.set
# (ref data/build.py:288-300) — same mechanism here.


def build_dataset(name: str, tokenizer=None, max_query_len: int = 256,
                  transform=None, **overrides):
    """Resolve a catalog name to a constructed reader (ref
    data/build.py:76-106 build_dataset).  `overrides` replace spec args
    (e.g. ann_file=... for tests); grounding/caption readers require a
    tokenizer.
    """
    spec = DatasetCatalog.get(name)
    args = dict(spec.args)
    args.update(overrides)

    if spec.factory == "arrow":
        from fiber_torch.data.arrow_dataset import ArrowCaptionDataset
        return ArrowCaptionDataset([args["arrow_path"]])

    if spec.factory == "coco_json":
        if spec.task == "grounding" or tokenizer is not None:
            from fiber_torch.data.coco_datasets import CocoGroundingDataset
            return CocoGroundingDataset(
                args["img_root"], args["ann_file"], tokenizer,
                max_query_len=max_query_len, transform=transform)
        from fiber_torch.data.coco_datasets import CocoDetectionDataset
        return CocoDetectionDataset(args["img_root"], args["ann_file"],
                                    transform=transform)

    if spec.factory == "jsonl":  # modulated (MDETR-style) annotations
        from fiber_torch.data.long_tail import (GQAGroundingDataset,
                                              MixedGroundingDataset,
                                              PhrasecutDataset)
        if name.startswith("mixed"):
            return MixedGroundingDataset(
                args.get("root_coco", args["img_root"]),
                args.get("root_vg", args["img_root"]),
                args["ann_file"], tokenizer,
                max_query_len=max_query_len, transform=transform)
        cls = (GQAGroundingDataset if name.startswith("gqa")
               else PhrasecutDataset if name.startswith("phrasecut")
               else None)
        if cls is None:
            from fiber_torch.data.coco_datasets import ModulatedCocoDataset
            cls = ModulatedCocoDataset
        return cls(args["img_root"], args["ann_file"], tokenizer,
                   max_query_len=max_query_len, transform=transform)

    if spec.factory == "tsv":
        if spec.task == "caption":
            from fiber_torch.data.long_tail import CaptionPseudoBoxDataset
            return CaptionPseudoBoxDataset(
                args["tsv_path"], tokenizer, max_query_len=max_query_len)
        from fiber_torch.data.tsv import TsvDetectionDataset
        return TsvDetectionDataset(args["tsv_path"])

    if spec.factory == "background":
        from fiber_torch.data.long_tail import BackgroundDataset
        return BackgroundDataset(args["ann_file"], args["img_root"],
                                 transform=transform)

    if spec.factory == "imagenet":
        from fiber_torch.data.long_tail import ImagenetClassificationDataset
        return ImagenetClassificationDataset(
            args["ann_file"], args["img_root"], transform=transform)

    raise ValueError(f"unknown factory kind '{spec.factory}' for {name}")


_r("background_train", "background", "detection",
   img_root="background/images", ann_file="background/images.json")
_r("imagenet_train", "imagenet", "classification",
   img_root="imagenet/train", ann_file="imagenet/train.json")
