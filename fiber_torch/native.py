"""The host library of CIDEr-D and greedy NMS, through ctypes.

The port's own binding to `native/fiber_host.cpp` (the C++ scorer and NMS
that the JAX package binds in `fiber_tpu/native/__init__.py`; the port
cannot import that package).  The source is compiled at first use with the
flags of `native/Makefile` (`g++ -O3 -std=c++17 -fPIC -shared`) into
`fiber_torch/_build/`, named by a hash of the source and the flags, so an
unchanged source is loaded as it is; nothing is written under `native/`.
Nothing is built when this module is imported.

* `CiderD` — CIDEr-D over integer token sequences (the SCST reward of
  `fiber_torch.objectives.caption.compute_caption_cider`);
* `nms_host` — greedy NMS with the reference's +1 box extents and
  >= threshold suppression.

The C interface takes int32 tokens: the port's int64 ids are converted at
the call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "fiber_host.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfiber_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Written to a temporary file and renamed, so that processes building at
    once never load half a library."""
    so = _target()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host library is built with a "
                           "C++17 compiler (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.cider_new.restype = ctypes.c_void_p
    lib.cider_new.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.cider_free.argtypes = [ctypes.c_void_p]
    lib.cider_set_refs.argtypes = [ctypes.c_void_p, i32, i64, i32,
                                   ctypes.c_int, ctypes.c_int]
    lib.cider_score.argtypes = [ctypes.c_void_p, i32, i64, i32, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double)]
    lib.nms_host.restype = ctypes.c_int
    lib.nms_host.argtypes = [ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                             ctypes.c_float, ctypes.c_int, i32]
    return lib


def _flatten(seqs: Sequence[Sequence[int]]):
    """(int32 tokens, int64 offsets of len(seqs) + 1) of the sequences."""
    lengths = np.asarray([len(s) for s in seqs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    tokens = np.asarray([int(t) for s in seqs for t in s], np.int64)
    if tokens.size and (tokens.min() < np.iinfo(np.int32).min
                        or tokens.max() > np.iinfo(np.int32).max):
        raise ValueError("token ids must fit in int32")
    tokens = tokens.astype(np.int32) if tokens.size else np.zeros(1, np.int32)
    return tokens, offsets


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class CiderD:
    """CIDEr-D over integer token sequences, scaled to [0, 10].

    refs: {image: [token list, ...]}; the document frequencies are counted
    over the images, as the reference's scorer counts them."""

    def __init__(self, refs: Dict[int, List[List[int]]], max_n: int = 4,
                 sigma: float = 6.0):
        lib = _lib()
        self._lib = lib
        self._h = lib.cider_new(max_n, sigma)
        self._image_index = {img: i for i, img in enumerate(sorted(refs))}
        flat, ref_image = [], []
        for img in sorted(refs):
            for r in refs[img]:
                flat.append(list(r))
                ref_image.append(self._image_index[img])
        tokens, offsets = _flatten(flat)
        ref_image = np.asarray(ref_image, np.int32)
        lib.cider_set_refs(self._h, _ptr(tokens, ctypes.c_int32),
                           _ptr(offsets, ctypes.c_int64),
                           _ptr(ref_image, ctypes.c_int32), len(flat),
                           len(self._image_index))

    def score(self, candidates: Dict[int, List[int]]) -> Dict[int, float]:
        """{image: candidate tokens} -> {image: CIDEr-D}."""
        imgs = sorted(candidates)
        tokens, offsets = _flatten([list(candidates[i]) for i in imgs])
        cand_image = np.asarray([self._image_index[i] for i in imgs],
                                np.int32)
        out = np.zeros(len(imgs), np.float64)
        self._lib.cider_score(self._h, _ptr(tokens, ctypes.c_int32),
                              _ptr(offsets, ctypes.c_int64),
                              _ptr(cand_image, ctypes.c_int32), len(imgs),
                              _ptr(out, ctypes.c_double))
        return {img: float(s) for img, s in zip(imgs, out)}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.cider_free(h)


def nms_host(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
             max_outputs: int = 100) -> np.ndarray:
    """Indices of the kept boxes (n, 4) xyxy, highest score first."""
    lib = _lib()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(min(max_outputs, len(boxes)), np.int32)
    n = lib.nms_host(_ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
                     len(boxes), iou_threshold, len(keep),
                     _ptr(keep, ctypes.c_int32))
    return keep[:n]
