"""Single-image grounding demo: an image and a free caption in, labelled
boxes out.

The PyTorch counterpart of `fiber_tpu/detection/demo.py`: tokenize the
caption, map each noun phrase (or the phrases given) to its tokens, run
the detector, turn the grounding logits into per-phrase scores, threshold
and NMS, and return the boxes in the image's own coordinates.
`render_detections` draws them on the image on the host; it imports PIL
inside, so nothing else here needs PIL.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from fiber_torch.data.od_to_grounding import char_spans_to_token_ids
from fiber_torch.detection.detector import (GroundingDetector,
                                            detection_inference)
from fiber_torch.detection.postprocess import label_to_token_matrix


# closed-class words that end a noun phrase (the chunker used where the
# NLTK models are not installed)
_NP_BREAKERS = frozenset(
    "a an the is are was were be been being and or but of on in at to "
    "with for from by over under near behind chasing eating running "
    "wearing holding riding next beside above below across through "
    "that this these those there it its his her their".split())


def find_noun_phrases(caption: str) -> List[Tuple[int, int]]:
    """Noun-phrase char spans.  With NLTK's models installed: its POS tags
    and the grammar 'NP: {<DT>?<JJ.*>*<NN.*>+}'.  Otherwise a closed-class
    chunker that approximates those spans: maximal runs of words that are
    not in `_NP_BREAKERS`, within the pieces between punctuation."""
    try:
        import nltk
        tokens = nltk.word_tokenize(caption.lower())
        pos_tags = nltk.pos_tag(tokens)
        grammar = "NP: {<DT>?<JJ.*>*<NN.*>+}"
        cp = nltk.RegexpParser(grammar)
        tree = cp.parse(pos_tags)
        spans = []
        cursor = 0
        for sub in tree.subtrees(lambda t: t.label() == "NP"):
            phrase = " ".join(w for w, _ in sub.leaves())
            m = re.search(re.escape(phrase), caption.lower()[cursor:])
            if m:
                spans.append((cursor + m.start(), cursor + m.end()))
                cursor += m.end()
        if spans:
            return spans
    except (LookupError, ImportError):
        pass

    spans = []
    for seg_m in re.finditer(r"[^.,;!?]+", caption):
        words = list(re.finditer(r"\w+", seg_m.group(0)))
        chunk: List[re.Match] = []
        for w in words + [None]:
            if w is None or w.group(0).lower() in _NP_BREAKERS:
                if chunk:
                    s = seg_m.start() + chunk[0].start()
                    e = seg_m.start() + chunk[-1].end()
                    spans.append((s, e))
                chunk = []
            else:
                chunk.append(w)
    return spans


def run_ner(caption: str,
            refexp_mode: bool = False) -> List[List[Tuple[int, int]]]:
    """The char spans of every occurrence of each noun phrase, one list per
    phrase (the whole caption in refexp mode)."""
    if refexp_mode:
        return [[(0, len(caption))]]
    phrases = [caption[s:e] for s, e in find_noun_phrases(caption)]
    tokens_positive = []
    for phrase in dict.fromkeys(p for p in phrases if p):
        occ = [(m.start(), m.end())
               for m in re.finditer(re.escape(phrase.lower()),
                                    caption.lower())]
        if occ:
            tokens_positive.append(occ)
    return tokens_positive


# an image staged for the detector: the (H, W, 3) RGB canvas in [0, 1] at
# the config's image size, and (h0, w0, scale) of the original image
Staged = Tuple[np.ndarray, Tuple[int, int, float]]


_PALETTE = [(230, 60, 60), (60, 160, 230), (60, 200, 120), (240, 180, 40),
            (170, 90, 230), (240, 120, 200), (120, 220, 220), (250, 140, 70)]


def render_detections(image_u8: np.ndarray, boxes: np.ndarray,
                      labels: Sequence[str],
                      scores: Optional[np.ndarray] = None,
                      masks: Optional[np.ndarray] = None,
                      width: int = 2) -> np.ndarray:
    """Draw boxes (+ optional masks) with labels onto a copy of the image
    (ref predictor_FIBER overlay_boxes/overlay_class_names/overlay_mask).
    Host numpy in and out; PIL draws, so it runs where PIL is installed."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(image_u8).convert("RGB")
    if masks is not None:
        overlay = np.asarray(img, np.float32)
        for i, m in enumerate(masks):
            color = np.asarray(_PALETTE[i % len(_PALETTE)], np.float32)
            mm = m.astype(bool)
            overlay[mm] = 0.5 * overlay[mm] + 0.5 * color
        img = Image.fromarray(overlay.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for i, (box, label) in enumerate(zip(boxes, labels)):
        color = _PALETTE[i % len(_PALETTE)]
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=width)
        text = label if scores is None else f"{label} {scores[i]:.2f}"
        draw.text((x1 + 2, max(y1 - 12, 0)), text, fill=color)
    return np.asarray(img)


class GroundingDemo:
    def __init__(self, model: GroundingDetector, tokenizer,
                 score_threshold: float = 0.5):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.score_threshold = score_threshold

    def preprocess(self, image_u8: np.ndarray) -> Staged:
        """uint8 HWC -> the staged image: resized (PIL, keeping the aspect
        ratio) to fit the config's image size, RGB in [0, 1] in the
        top-left corner of a zero canvas."""
        from PIL import Image
        H, W = self.cfg.image_size
        h0, w0 = image_u8.shape[:2]
        scale = min(H / h0, W / w0)
        nh, nw = int(h0 * scale), int(w0 * scale)
        img = Image.fromarray(image_u8).resize((nw, nh))
        canvas = np.zeros((H, W, 3), np.float32)
        canvas[:nh, :nw] = np.asarray(img, np.float32) / 255.0
        return canvas, (h0, w0, scale)

    def __call__(self, image: Union[np.ndarray, Staged], caption: str,
                 phrases: Optional[List[str]] = None) -> Dict:
        """image: uint8 HWC (staged on the host with PIL), or an image
        already staged as `preprocess` returns it.  Returns the boxes
        (original coordinates), scores and phrase labels above the score
        threshold."""
        cfg = self.cfg
        if phrases:
            spans = []
            for p in phrases:
                i = caption.lower().find(p.lower())
                if i >= 0:
                    spans.append((i, i + len(p)))
        else:
            spans = find_noun_phrases(caption)
        labels = {i + 1: caption[s:e] for i, (s, e) in enumerate(spans)}

        enc = (self.tokenizer.batch([caption], max_length=cfg.max_query_len)
               if hasattr(self.tokenizer, "batch") else
               self.tokenizer([caption], max_length=cfg.max_query_len,
                              padding="max_length", truncation=True,
                              return_tensors="np"))
        l2t = {i + 1: char_spans_to_token_ids(self.tokenizer, caption,
                                              span, cfg.max_query_len)
               for i, span in enumerate(spans)}
        agg = label_to_token_matrix(l2t, len(spans), cfg.max_query_len)

        img, (h0, w0, scale) = (image if isinstance(image, tuple)
                                else self.preprocess(image))
        batch = {
            "images": np.asarray(img, np.float32)[None],
            "input_ids": np.asarray(enc["input_ids"], np.int64),
            "attention_mask": np.asarray(enc["attention_mask"], np.int64),
            "image_sizes": np.asarray([[h0 * scale, w0 * scale]],
                                      np.float32),
        }
        dets = detection_inference(self.model, batch, agg)
        boxes = dets.boxes[0].cpu().numpy() / scale
        scores = dets.scores[0].cpu().numpy()
        cls = dets.labels[0].cpu().numpy()
        valid = dets.valid[0].cpu().numpy() & (scores >= self.score_threshold)
        return {
            "boxes": boxes[valid],
            "scores": scores[valid],
            "labels": [labels.get(int(c), str(int(c)))
                       for c in cls[valid]],
        }
