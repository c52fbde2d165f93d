"""The grounding detector of the reference (fusion backbone, FPN, VLDyHead)
and its postprocess: dense class scores and boxes at every anchor, and
the ATSS postprocess's per-level top-k and class-aware NMS, in fp32.

The arithmetic of the port's `fiber_torch/detection/detector.py`
(`GroundingDetector.forward`), `postprocess.py` and `boxes.py`, written
against nothing of the port; the prompt and its token map are worked out
here again from the class names and the benchmark's tokenizer.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from portbench.reference.anchors import fpn_anchors
from portbench.reference.dyhead import VLDyHead
from portbench.reference.fusion_backbone import FusionSwinFPN

# log(1000 / 16): the largest width / height delta the decoder takes
BBOX_XFORM_CLIP = 4.135166556742356


class GroundingDetector(nn.Module):
    """Built on `device` with PyTorch's default initialisation, to be
    overwritten by `load_state_dict`; fp32, eval; fusion v2 only."""

    def __init__(self, m: Mapping, device="cuda"):
        if m["fusion_version"] != "v2":
            raise ValueError("the reference holds FIBER's fusion v2 only")
        super().__init__()
        self.m = m
        with torch.device(device):
            self.fusion_backbone = FusionSwinFPN(
                image_size=tuple(m["image_size"]), patch_size=m["patch_size"],
                embed_dim=m["embed_dim"], depths=m["depths"],
                num_heads=m["num_heads"], window_size=m["window_size"],
                drop_path_rate=m["drop_path_rate"],
                num_fuse_block=m["num_fuse_block"],
                out_channels=m["out_channels"], vocab_size=m["vocab_size"],
                lang_dim=m["lang_dim"], num_text_heads=m["num_text_heads"])
            head = VLDyHead(num_convs=m["num_dyhead_convs"],
                            in_channels=m["out_channels"],
                            channels=m["out_channels"],
                            lang_dim=m["lang_dim"],
                            use_dyrelu=m["use_dyrelu"],
                            use_dyfuse=m["use_dyfuse"],
                            use_deform=m["use_deform"])
            self.rpn = nn.ModuleDict({"head": head})
        self.to(device)
        self.eval()

    def forward(self, images, input_ids, attention_mask):
        feats, lang = self.fusion_backbone(images, input_ids, attention_mask)
        return self.rpn["head"](feats, lang["embedded"])


# ---------------------------------------------------------------------------
# The prompt of a chunk of classes
# ---------------------------------------------------------------------------
def chunks(names: Mapping[int, str], size: int) -> List[List[int]]:
    labels = sorted(names)
    return [labels[i:i + size] for i in range(0, len(labels), size)]


def prompt(names: Mapping[int, str], chunk: Sequence[int], tokenizer,
           T: int) -> Tuple[str, np.ndarray]:
    """The caption "name1. name2. ..." of the chunk's classes, and its (C,
    T) mean-aggregation matrix: row c averages the tokens of class c's
    words."""
    caption, spans = "", []
    for i, label in enumerate(chunk):
        name = names[label].strip().lower()
        spans.append((len(caption), len(caption) + len(name)))
        caption += name + (". " if i != len(chunk) - 1 else "")
    enc = tokenizer(caption, max_length=T, truncation=True,
                    return_offsets_mapping=True)
    agg = np.zeros((len(chunk), T), np.float32)
    for c, (a, b) in enumerate(spans):
        toks = [t for t, (s, e) in enumerate(enc["offset_mapping"])
                if s != e and s < b and e > a]
        agg[c, toks] = 1.0 / len(toks)
    return caption, agg


# ---------------------------------------------------------------------------
# Dense scores and boxes; the postprocess
# ---------------------------------------------------------------------------
def decode_boxes(deltas, anchors, weights=(10., 10., 5., 5.)):
    """(dx, dy, dw, dh) on anchors -> xyxy, the +1 pixel convention."""
    aw = anchors[..., 2] - anchors[..., 0] + 1
    ah = anchors[..., 3] - anchors[..., 1] + 1
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = (deltas[..., 2] / weights[2]).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / weights[3]).clamp(max=BBOX_XFORM_CLIP)
    cx, cy = dx * aw + ax, dy * ah + ay
    w, h = torch.exp(dw) * aw, torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                        cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], dim=-1)


def clip_boxes(boxes, height, width):
    """Into [0, width - 1] x [0, height - 1]; height, width (B, 1)."""
    hy, hx = height - 1, width - 1
    return torch.stack([torch.minimum(boxes[..., 0].clamp_min(0), hx),
                        torch.minimum(boxes[..., 1].clamp_min(0), hy),
                        torch.minimum(boxes[..., 2].clamp_min(0), hx),
                        torch.minimum(boxes[..., 3].clamp_min(0), hy)], -1)


def dense(head_out: Dict[str, List[torch.Tensor]], m: Mapping,
          agg: torch.Tensor, image_sizes: torch.Tensor) -> List[Dict]:
    """Per level: `score` (B, A, C), the square root of the aggregated
    grounding probability times the centerness; `candidate` (B, A, C),
    the aggregated probability over the threshold; `boxes` (B, A, 4),
    decoded and clipped to each image's size."""
    B = head_out["centerness"][0].shape[0]
    H, W = m["image_size"]
    sizes = [(-(-H // s), -(-W // s)) for s in m["anchor_strides"]]
    levels = fpn_anchors(tuple(sizes), strides=m["anchor_strides"],
                         sizes=m["anchor_sizes"])
    out = []
    for lvl, anchors in enumerate(levels):
        anchors = torch.from_numpy(anchors).to(agg.device)
        ctr = torch.sigmoid(head_out["centerness"][lvl].reshape(B, -1).float())
        reg = head_out["bbox_reg"][lvl].reshape(B, -1, 4).float()
        prob = torch.sigmoid(head_out["dot_product_logits"][lvl].float()) @ agg.T
        boxes = clip_boxes(decode_boxes(reg, anchors[None]),
                           image_sizes[:, 0:1], image_sizes[:, 1:2])
        out.append({"candidate": prob > m["pre_nms_thresh"],
                    "score": torch.sqrt((prob * ctr[:, :, None]).clamp_min(0)),
                    "product": prob * ctr[:, :, None], "boxes": boxes})
    return out


def postprocess(levels: List[Dict], m: Mapping) -> Dict[str, torch.Tensor]:
    """The ATSS postprocess's detections, (B, post_nms_top_n) each: each
    level's top `pre_nms_top_n` candidates, then class-aware greedy NMS
    (IoU in the +1 pixel convention); `boxes`, `scores` (the square root
    of probability times centerness), 1-based local `labels`, `valid`."""
    boxes, scores, labels, valid = [], [], [], []
    for lv in levels:
        B, A, C = lv["product"].shape
        flat = torch.where(lv["candidate"], lv["product"],
                           torch.zeros_like(lv["product"])).reshape(B, -1)
        k = min(m["pre_nms_top_n"], A * C)
        top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        loc = torch.div(idx, C, rounding_mode="floor")
        boxes.append(lv["boxes"].gather(1, loc[..., None].expand(B, k, 4)))
        scores.append(torch.sqrt(top.clamp_min(0)))
        labels.append(idx % C + 1)
        valid.append(top > 0)
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
    labels, live = torch.cat(labels, 1), torch.cat(valid, 1)
    span = boxes.amax(dim=(1, 2)) - boxes.amin(dim=(1, 2)) + 1.0
    moved = boxes + labels.float()[..., None] * span[:, None, None]
    area = ((moved[..., 2] - moved[..., 0] + 1)
            * (moved[..., 3] - moved[..., 1] + 1))
    B, n = scores.shape
    ar = torch.arange(n, device=scores.device)
    keep, ok = [], []
    for _ in range(m["post_nms_top_n"]):
        masked = torch.where(live, scores, torch.full_like(scores, -1e30))
        idx = masked.argmax(dim=1, keepdim=True)
        keep.append(idx[:, 0])
        ok.append(masked.gather(1, idx)[:, 0] > -1e29)
        box = moved.gather(1, idx[..., None].expand(B, 1, 4))
        lt = torch.maximum(box[..., :2], moved[..., :2])
        rb = torch.minimum(box[..., 2:], moved[..., 2:])
        wh = (rb - lt + 1).clamp_min(0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area.gather(1, idx) + area - inter)
        live = live & ~(iou >= m["nms_thresh"]) & (ar != idx)
    keep, ok = torch.stack(keep, 1), torch.stack(ok, 1)
    return {"boxes": boxes.gather(1, keep[..., None].expand(B, -1, 4)),
            "scores": scores.gather(1, keep), "labels": labels.gather(1, keep),
            "valid": ok}
