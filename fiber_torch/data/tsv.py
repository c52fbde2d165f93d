"""TSV-storage dataset reader (ref data/datasets/tsv.py, 408 LoC):
rows of `key\tlabel_json\tbase64_image` with a companion .lineidx file of
byte offsets for O(1) random access — the format used by the Object365 /
CC pretraining shards.

The port's copy of `fiber_tpu/data/tsv.py`; PIL is imported only to decode
an image.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Any, Dict, List, Optional


class TsvFile:
    def __init__(self, tsv_path: str,
                 lineidx_path: Optional[str] = None):
        self.tsv_path = tsv_path
        lineidx_path = lineidx_path or os.path.splitext(tsv_path)[0] + \
            ".lineidx"
        if os.path.exists(lineidx_path):
            with open(lineidx_path) as f:
                self.offsets = [int(l) for l in f if l.strip()]
        else:
            # build the index on first open (the reference ships .lineidx
            # with the data; we tolerate its absence)
            self.offsets = []
            with open(tsv_path, "rb") as f:
                off = 0
                for line in f:
                    self.offsets.append(off)
                    off += len(line)
            with open(lineidx_path, "w") as f:
                f.write("\n".join(str(o) for o in self.offsets))
        self._fh = None

    def __len__(self) -> int:
        return len(self.offsets)

    def row(self, idx: int) -> List[str]:
        if self._fh is None:
            self._fh = open(self.tsv_path, "rb")
        self._fh.seek(self.offsets[idx])
        return self._fh.readline().decode("utf-8").rstrip("\n").split("\t")


class TsvDetectionDataset:
    """key / boxes-json / base64-image rows -> detection records."""

    def __init__(self, tsv_path: str):
        self.tsv = TsvFile(tsv_path)

    def __len__(self) -> int:
        return len(self.tsv)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        key, label_json, img_b64 = self.tsv.row(idx)[:3]
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(img_b64)))
        anns = json.loads(label_json)
        if isinstance(anns, dict):
            anns = anns.get("objects", anns.get("annotations", []))
        boxes, labels = [], []
        for a in anns:
            rect = a.get("rect") or a.get("bbox")
            if rect is None:
                continue
            boxes.append(rect)
            labels.append(a.get("class", a.get("category_id", 0)))
        return {"key": key, "image": img, "boxes": boxes,
                "labels": labels}
