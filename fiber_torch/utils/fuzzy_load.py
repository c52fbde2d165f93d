"""Fuzzy multi-format checkpoint loading into a torch state_dict.

The port's counterpart of `fiber_tpu/utils/fuzzy_load.py` (the reference's
DetectronCheckpointer stack: utils/checkpoint.py:114-160,
utils/model_serialization.py:22-208, utils/c2_model_loading.py): read a
foreign checkpoint (a torch ``.pth`` / ``.pt``, a Caffe2 / Detectron
``.pkl`` blob dict or an ``.npz``) and merge it into a model's state_dict
by longest-suffix key matching, resizing relative-position bias tables
whose window differs.

The port's keys are the reference's, so JAX's torch -> flax layout guesses
(transposes, ``weight`` -> ``kernel`` / ``scale``, ``_``-joined indices)
drop out: a loaded tensor lands on a model key when its key is the longest
suffix of that model key (at a ``.`` boundary) and its shape is the model
tensor's.  A bias table of another window is resized bicubically
(`resize_relative_position_bias_table`); any other shape mismatch is
skipped and reported.  Loaded keys lose leading ``module.`` / ``model.`` /
``state_dict.`` wrappers, and the tower names ``text_transformer.`` and
``vit_model.`` wherever they stand, as JAX's do; the suffix match puts them
back on the right tower, since every model key of a tower ends in the
stripped key.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# leading wrappers stripped only at the START of a key (a naive
# replace-anywhere corrupts e.g. "some.submodule.weight" -> "some.sub");
# the tower names are removed anywhere, matching the reference's
# align_and_update_state_dicts (model_serialization.py:41-44).
LEADING_PREFIXES = ("module.", "model.", "state_dict.")
ANYWHERE_SUBSTRINGS = ("text_transformer.", "vit_model.")

StateDict = Dict[str, torch.Tensor]
Report = Dict[str, List[str]]


# ---------------------------------------------------------------------
# the relative-position bias table's bicubic resize (torch's
# F.interpolate(mode="bicubic", align_corners=False): a = -0.75, edges
# clamped), on the host in numpy as JAX's checkpoint_convert.py does
# ---------------------------------------------------------------------
def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights for the 4 taps around fractional
    offset t in [0, 1): positions (-1-t, -t, 1-t, 2-t)."""
    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2,
                     a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                     0.0))
    offs = np.stack([-1 - t, -t, 1 - t, 2 - t], axis=-1)  # (N, 4)
    return k(offs)


def _bicubic_1d(x: np.ndarray, out_size: int) -> np.ndarray:
    """torch F.interpolate(mode='bicubic', align_corners=False) along
    axis 0 with edge clamping."""
    in_size = x.shape[0]
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = _cubic_weights(t)                                  # (out, 4)
    idx = np.clip(i0[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    return np.einsum("ot,ot...->o...", w, x[idx])


def resize_relative_position_bias_table(table: np.ndarray,
                                        window_before: int,
                                        window_after: int) -> np.ndarray:
    """Bicubic re-interpolation of the ((2w-1)^2, nH) RPB table (ref
    swin_helpers.swin_adapt_position_encoding, swin_helpers.py:20-44)."""
    if window_before == window_after:
        return table
    s_before = 2 * window_before - 1
    s_after = 2 * window_after - 1
    nh = table.shape[1]
    grid = np.asarray(table, np.float32).reshape(s_before, s_before, nh)
    out = _bicubic_1d(grid, s_after)                       # rows
    out = _bicubic_1d(out.transpose(1, 0, 2), s_after).transpose(1, 0, 2)
    return out.reshape(s_after * s_after, nh)


def _table_window(rows: int) -> Optional[int]:
    """w when rows == (2w - 1)^2, else None."""
    w = int(round((np.sqrt(rows) + 1) / 2))
    return w if (2 * w - 1) ** 2 == rows else None


# ---------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------
def strip_key(key: str) -> str:
    """A loaded key without its leading wrappers (repeated) and tower
    names, as the loader keys it."""
    stripped = True
    while stripped:
        stripped = False
        for p in LEADING_PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                stripped = True
    for p in ANYWHERE_SUBSTRINGS:
        key = key.replace(p, "")
    return key


def _tensor(v) -> Optional[torch.Tensor]:
    """v as a CPU tensor; None for what is not numeric (a Lightning
    checkpoint's strings and objects)."""
    if torch.is_tensor(v):
        return v
    a = np.asarray(v)
    return None if a.dtype.kind not in "biuf" else torch.from_numpy(a.copy())


def load_foreign_state_dict(path: str) -> StateDict:
    """Read a .pth / .pt (torch), .pkl (Caffe2 blobs) or .npz checkpoint
    into a flat {dotted_key: CPU tensor} dict, the keys stripped as the
    module docstring says."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    elif path.endswith(".pkl"):
        # Detectron/C2 format: pickled dict, often {"blobs": {...}}
        # (ref c2_model_loading.py:131-140, checkpoint.py:133-141)
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        if "blobs" in data:
            data = data["blobs"]
        if "model" in data and isinstance(data["model"], dict):
            data = data["model"]
        sd = {k: v for k, v in data.items() if not k.endswith("_momentum")}
    else:
        try:
            # Safe path first: tensors-only deserialization.
            data = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            # Older/pickled formats (Lightning, Detectron surgeries) need
            # full unpickling, which executes code embedded in the file —
            # only do so for checkpoints you trust.
            warnings.warn(
                f"{path}: falling back to weights_only=False torch.load; "
                "this trusts arbitrary code in the checkpoint file.")
            data = torch.load(path, map_location="cpu", weights_only=False)
        for key in ("state_dict", "model", "module"):
            if isinstance(data, dict) and key in data and isinstance(
                    data[key], dict):
                data = data[key]
                break
        sd = data
    out = {strip_key(k): _tensor(v) for k, v in sd.items()}
    return {k: v for k, v in out.items() if v is not None}


# ---------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------
def _longest_suffix(model_key: str, loaded: Mapping) -> Optional[str]:
    """The longest loaded key equal to `model_key` or ending it at a "."
    boundary (model_serialization.py:22-80)."""
    parts = model_key.split(".")
    for i in range(len(parts)):
        cand = ".".join(parts[i:])
        if cand in loaded:
            return cand
    return None


def align_and_update(state_dict: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, torch.Tensor],
                     reshape_keys: Tuple[str, ...] = (
                         "relative_position_bias_table",),
                     ) -> Tuple[StateDict, Report]:
    """Merge `loaded` into a copy of `state_dict` by longest-suffix key
    matching.  Each matched tensor takes the model tensor's dtype and
    device; a bias table (a key holding one of `reshape_keys`) of another
    window is resized.  Returns (new_state_dict, report), the report's
    lists "matched" ("<model key> <- <loaded key>"), "skipped_shape" and
    "unmatched_model", as JAX's."""
    report: Report = {"matched": [], "skipped_shape": [],
                      "unmatched_model": []}
    new = dict(state_dict)
    for mkey in sorted(state_dict):
        lkey = _longest_suffix(mkey, loaded)
        if lkey is None:
            report["unmatched_model"].append(mkey)
            continue
        mval, lval = state_dict[mkey], loaded[lkey]
        value = lval if tuple(lval.shape) == tuple(mval.shape) else None
        if value is None and any(k in mkey for k in reshape_keys) \
                and lval.dim() == 2 and mval.dim() == 2:
            w_src = _table_window(lval.shape[0])
            w_dst = _table_window(mval.shape[0])
            if w_src and w_dst and lval.shape[1] == mval.shape[1]:
                value = torch.from_numpy(resize_relative_position_bias_table(
                    lval.float().numpy(), w_src, w_dst))
        if value is None:
            report["skipped_shape"].append(f"{mkey} <- {lkey}")
            continue
        new[mkey] = value.to(dtype=mval.dtype, device=mval.device)
        report["matched"].append(f"{mkey} <- {lkey}")
    return new, report


def load_into_state_dict(state_dict: Mapping[str, torch.Tensor], path: str,
                         **kwargs
                         ) -> Tuple[StateDict, Report]:
    """One-call fuzzy load: read any supported format and merge."""
    return align_and_update(state_dict, load_foreign_state_dict(path),
                            **kwargs)


# JAX's name (there over a flax param tree)
load_into_params = load_into_state_dict


def load_into_model(model: torch.nn.Module, path: str,
                    **kwargs) -> Report:
    """Fuzzy-load `path` into `model` in place; returns the report."""
    new, report = load_into_state_dict(model.state_dict(), path, **kwargs)
    model.load_state_dict(new)
    return report
