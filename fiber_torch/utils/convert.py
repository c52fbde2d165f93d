"""JAX parameter tree -> port state_dict.

`params_from_flax` takes the JAX package's `FiberCoarse` parameters,
flattened by the caller to "a/b/c" paths and numpy arrays, and returns the
port's `state_dict`, named as the reference checkpoint names it.  It is the
inverse of the JAX package's `convert_fiber_state_dict`:

* Dense kernels (in, out) become Linear weights (out, in);
* Conv kernels HWIO become OIHW;
* LayerNorm `scale` becomes `weight`, an Embed's `embedding` its `weight`;
* the fusion gates `alpha_*` keep the reference's (1,) shape;
* the captioning projections `caption_image_proj_{i}` are the reference's
  `cross_modal_att_layers.{i}`.

`stacked_params_from_flax` carries the JAX package's stacked Swin-block
parameters (`fiber_tpu/ops/swin_stage.py::stack_block_params`) across to
the port's fused-blocks op (`fiber_torch/ops/swin_stage.py`).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fiber_torch.ops.swin_stage import FP32_KEYS, STACK_KEYS

# module renames, applied in order to the "/"-joined flax path without its
# leaf; each yields the port's dotted module path
_MODULE_RULES = [
    (r"^vit_model/layers_(\d+)/blocks_(\d+)/", r"vit_model.layers.\1.blocks.\2."),
    (r"^vit_model/layers_(\d+)/", r"vit_model.layers.\1."),
    (r"^text_transformer/layer_(\d+)(/|$)", r"text_transformer.encoder.layer.\1\2"),
    (r"attention/(query|key|value)$", r"attention.self.\1"),
    (r"attention/out_dense$", r"attention.output.dense"),
    (r"crossattention_t2i/(query|key|value)$", r"crossattention_t2i.self.\1"),
    (r"crossattention_t2i/out_dense$", r"crossattention_t2i.output.dense"),
    (r"attn_layer_norm$", r"attention.output.LayerNorm"),
    (r"intermediate_dense$", r"intermediate.dense"),
    (r"output_dense$", r"output.dense"),
    (r"output_layer_norm$", r"output.LayerNorm"),
    (r"^mlm_score/transform_dense$", r"mlm_score.transform.dense"),
    (r"^mlm_score/transform_ln$", r"mlm_score.transform.LayerNorm"),
    (r"^(vqa|nlvr2)_classifier/fc1$", r"\1_classifier.0"),
    (r"^(vqa|nlvr2)_classifier/ln$", r"\1_classifier.1"),
    (r"^(vqa|nlvr2)_classifier/fc2$", r"\1_classifier.3"),
    (r"^caption_image_proj_(\d+)$", r"cross_modal_att_layers.\1"),
]


def _port_key(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax path and value -> the port's key and value."""
    module, _, leaf = path.rpartition("/")
    for pat, rep in _MODULE_RULES:
        module = re.sub(pat, rep, module)
    module = module.replace("/", ".")
    if module == "mlm_score.decoder":
        # the reference keeps the decoder bias outside the Linear
        return ("mlm_score.decoder.weight", value.T) if leaf == "kernel" \
            else ("mlm_score.bias", value)
    if leaf == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return (f"{module}.{leaf}" if module else leaf), value


# the inverse renames, port dotted module path -> flax "/" path
_FLAX_RULES = [
    (r"^vit_model\.layers\.(\d+)\.blocks\.(\d+)\.", r"vit_model/layers_\1/blocks_\2/"),
    (r"^vit_model\.layers\.(\d+)\.", r"vit_model/layers_\1/"),
    (r"^text_transformer\.encoder\.layer\.(\d+)(\.|$)", r"text_transformer/layer_\1/"),
    (r"(^|/)attention\.self\.(query|key|value)$", r"\1attention/\2"),
    (r"(^|/)attention\.output\.dense$", r"\1attention/out_dense"),
    (r"(^|/)attention\.output\.LayerNorm$", r"\1attn_layer_norm"),
    (r"crossattention_t2i\.self\.(query|key|value)$", r"crossattention_t2i/\1"),
    (r"crossattention_t2i\.output\.dense$", r"crossattention_t2i/out_dense"),
    (r"(^|/)intermediate\.dense$", r"\1intermediate_dense"),
    (r"(^|/)output\.dense$", r"\1output_dense"),
    (r"(^|/)output\.LayerNorm$", r"\1output_layer_norm"),
    (r"^mlm_score\.transform\.dense$", r"mlm_score/transform_dense"),
    (r"^mlm_score\.transform\.LayerNorm$", r"mlm_score/transform_ln"),
    (r"^(vqa|nlvr2)_classifier\.0$", r"\1_classifier/fc1"),
    (r"^(vqa|nlvr2)_classifier\.1$", r"\1_classifier/ln"),
    (r"^(vqa|nlvr2)_classifier\.3$", r"\1_classifier/fc2"),
    (r"^cross_modal_att_layers\.(\d+)$", r"caption_image_proj_\1"),
]


def flax_path(key: str) -> str:
    """The port's state_dict key -> the flax path `_port_key` maps to it
    (its inverse, used to give a port parameter the JAX package's
    optimizer group).  A `weight` becomes the flax leaf of its module:
    `scale` of a LayerNorm, `embedding` of an Embed, else `kernel`."""
    if key == "mlm_score.bias":
        return "mlm_score/decoder/bias"
    module, _, leaf = key.rpartition(".")
    for pat, rep in _FLAX_RULES:
        module = re.sub(pat, rep, module)
    module = module.replace(".", "/").rstrip("/")
    if leaf == "weight":
        last = module.rsplit("/", 1)[-1]
        leaf = ("scale" if "norm" in last.lower() or last.endswith("ln")
                else "embedding" if last.endswith("_embeddings")
                else "kernel")
    return f"{module}/{leaf}" if module else leaf


def params_from_flax(flat: Dict[str, np.ndarray],
                     model: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """flax "a/b/c" -> numpy parameters  =>  the port's state_dict.

    Raises on a flax path that maps to no parameter of `model`, and on a
    parameter of `model` left unset, or whose shape differs.  Without a
    model only the renaming is done."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key, v = _port_key(path, np.asarray(value))
        if key in out:
            raise ValueError(f"flax paths collide on {key!r}")
        out[key] = torch.from_numpy(np.array(v, np.float32))
    if model is None:
        return out
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    unknown = sorted(set(out) - set(expected))
    if unknown:
        raise ValueError(f"flax parameters with no place in the port: "
                         f"{unknown[:20]}")
    unset = sorted(set(expected) - set(out))
    if unset:
        raise ValueError(f"port parameters the flax tree leaves unset: "
                         f"{unset[:20]}")
    bad = [(k, tuple(out[k].shape), s) for k, s in expected.items()
           if tuple(out[k].shape) != s]
    if bad:
        raise ValueError(f"shape mismatch (key, flax, port): {bad[:20]}")
    return out


# the stacked (n, in, out) kernels, which the port keeps as (n, out, in)
_STACKED_KERNELS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def stacked_params_from_flax(sp: Dict[str, np.ndarray],
                             dtype: torch.dtype = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked Swin-block parameters (numpy arrays, flax
    (in, out) kernels) -> the port's: the kernels transposed to nn.Linear's
    (out, in), the weights and Linear biases in `dtype`, the LayerNorm
    parameters and the (n, h, N, N) relative-position biases in fp32 --
    what `fiber_torch.ops.swin_stage.stack_block_params` gives for the same
    blocks."""
    if set(sp) != set(STACK_KEYS):
        raise ValueError(f"stacked parameters must have the keys "
                         f"{STACK_KEYS}, got {sorted(sp)}")
    out = {}
    for k in STACK_KEYS:
        v = np.array(sp[k], np.float32)
        if k in _STACKED_KERNELS:
            v = v.transpose(0, 2, 1)
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t if k in FP32_KEYS else t.to(dtype)
    return out
