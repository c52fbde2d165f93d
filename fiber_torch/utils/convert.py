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


# the DyConv's three convs, as the reference numbers them
_DYCONV_INDEX = {"conv_up": 0, "conv_same": 1, "conv_down": 2}
_DET_BODY = "fusion_backbone.backbone.body."
_DET_TEXT = "fusion_backbone.language_backbone.body.model."
_DET_HEAD = "rpn.head."
_DET_LOSS = "rpn.loss_evaluator."


def _det_key(path: str, v: np.ndarray, use_deform: bool
             ) -> Optional[Tuple[str, np.ndarray]]:
    """One flax path of the JAX `GroundingDetector` -> the port's key and
    value (None for the path of another `use_deform`)."""
    conv = lambda w: w.transpose(3, 2, 0, 1)              # HWIO -> OIHW
    leaf = lambda l: "weight" if l in ("kernel", "scale") else l
    m = re.match(r"backbone/language_backbone/(.*)$", path)
    if m:
        key, v = _port_key("text_transformer/" + m.group(1), v)
        return _DET_TEXT + key[len("text_transformer."):], v
    m = re.match(r"backbone/((layers_\d+|patch_embed)/.*)$", path)
    if m:
        key, v = _port_key("vit_model/" + m.group(1), v)
        return _DET_BODY + key[len("vit_model."):], v
    m = re.match(r"backbone/out_norm_(\d+)/(scale|bias)$", path)
    if m:
        return f"{_DET_BODY}norm{m.group(1)}.{leaf(m.group(2))}", v
    m = re.match(r"backbone/(cross_modal_image_transform[23])/(kernel|bias)$",
                 path)
    if m:
        return (f"{_DET_BODY}{m.group(1)}.{leaf(m.group(2))}",
                v.T if m.group(2) == "kernel" else v)
    if path == "backbone/tunable_linear":
        return "fusion_backbone.tunable_linear.weight", v
    m = re.match(r"backbone/fpn/(lateral|output|p6|p7)_?(\d*)/(kernel|bias)$",
                 path)
    if m:
        kind, i, wb = m.groups()
        mod = (f"fpn_inner{int(i) + 2}" if kind == "lateral" else
               f"fpn_layer{int(i) + 2}" if kind == "output" else
               f"top_blocks.{kind}")
        return (f"fusion_backbone.backbone.fpn.{mod}.{leaf(wb)}",
                conv(v) if wb == "kernel" else v)
    m = re.match(r"rpn/dyconv_(\d+)/(.*)$", path)
    if m:
        base = f"{_DET_HEAD}dyhead_tower.{m.group(1)}."
        rest = m.group(2)
        mm = re.match(r"(conv_up|conv_same|conv_down)/(conv/)?(kernel|bias)$",
                      rest)
        if mm:
            name, nested, wb = mm.groups()
            if bool(nested) == use_deform:
                # the deformable Conv3x3Norm keeps its kernel at the module
                # level, the plain one under `conv`
                return None
            return (f"{base}DyConv.{_DYCONV_INDEX[name]}.conv.{leaf(wb)}",
                    conv(v) if wb == "kernel" else v)
        mm = re.match(r"(conv_up|conv_same|conv_down)/gn/(scale|bias)$", rest)
        if mm:
            return (f"{base}DyConv.{_DYCONV_INDEX[mm.group(1)]}.bn."
                    f"{leaf(mm.group(2))}", v)
        mm = re.match(r"attn_conv/(kernel|bias)$", rest)
        if mm:   # a (C, 1) Dense -> a (1, C, 1, 1) conv
            return (f"{base}AttnConv.1.{leaf(mm.group(1))}",
                    v.T.reshape(1, -1, 1, 1) if mm.group(1) == "kernel" else v)
        mm = re.match(r"dyrelu/fc([12])/(kernel|bias)$", rest)
        if mm:
            j = 0 if mm.group(1) == "1" else 2
            return (f"{base}relu.fc.{j}.{leaf(mm.group(2))}",
                    v.T if mm.group(2) == "kernel" else v)
        mm = re.match(r"offset_conv/(kernel|bias)$", rest)
        if mm:
            return (f"{base}offset.{leaf(mm.group(1))}",
                    conv(v) if mm.group(1) == "kernel" else v)
        raise ValueError(f"unknown detection parameter {path!r}")
    m = re.match(r"rpn/(cls_logits|bbox_pred|centerness|token_logits|"
                 r"contrastive_align_projection_image)/(kernel|bias)$", path)
    if m:
        return (f"{_DET_HEAD}{m.group(1)}.{leaf(m.group(2))}",
                conv(v) if m.group(2) == "kernel" else v)
    m = re.match(r"rpn/(dot_product_projection_text|"
                 r"contrastive_align_projection_text)/(kernel|bias)$", path)
    if m:
        return (f"{_DET_HEAD}{m.group(1)}.{leaf(m.group(2))}",
                v.T if m.group(2) == "kernel" else v)
    if path in ("rpn/log_scale", "rpn/bias0", "rpn/bias_lang"):
        return _DET_HEAD + path[len("rpn/"):], v
    m = re.match(r"mlm_head/(.*)$", path)
    if m:
        key, v = _port_key("mlm_score/" + m.group(1), v)
        return f"{_DET_HEAD}mlm_head.{key[len('mlm_score.'):]}", v
    m = re.match(r"shallow_head/projection_(image|text)/(kernel|bias)$", path)
    if m:
        return (f"{_DET_LOSS}shallow_contrastive_projection_{m.group(1)}."
                f"{leaf(m.group(2))}", v.T if m.group(2) == "kernel" else v)
    if path == "shallow_head/shallow_log_scale":
        return f"{_DET_LOSS}shallow_log_scale", v
    raise ValueError(f"unknown detection parameter {path!r}")


# the port's module names under the tower and the heads -> the JAX
# package's, the inverse of `_det_key`
_DET_FLAX_RULES = [
    (r"^rpn\.head\.dyhead_tower\.(\d+)\.DyConv\.(\d)\.(conv|bn)$",
     lambda m: (f"rpn/dyconv_{m[1]}/"
                f"{_DYCONV_NAMES[int(m[2])]}/{'gn' if m[3] == 'bn' else 'conv'}")),
    (r"^rpn\.head\.dyhead_tower\.(\d+)\.AttnConv\.1$",
     lambda m: f"rpn/dyconv_{m[1]}/attn_conv"),
    (r"^rpn\.head\.dyhead_tower\.(\d+)\.relu\.fc\.(0|2)$",
     lambda m: f"rpn/dyconv_{m[1]}/dyrelu/fc{1 if m[2] == '0' else 2}"),
    (r"^rpn\.head\.dyhead_tower\.(\d+)\.offset$",
     lambda m: f"rpn/dyconv_{m[1]}/offset_conv"),
    (r"^rpn\.head\.(?!mlm_head)(\w+)$", lambda m: f"rpn/{m[1]}"),
    (r"^rpn\.loss_evaluator\.shallow_contrastive_(projection_\w+)$",
     lambda m: f"shallow_head/{m[1]}"),
    (r"^fusion_backbone\.backbone\.fpn\.fpn_(inner|layer)(\d)$",
     lambda m: (f"backbone/fpn/{'lateral' if m[1] == 'inner' else 'output'}"
                f"_{int(m[2]) - 2}")),
    (r"^fusion_backbone\.backbone\.fpn\.top_blocks\.(p6|p7)$",
     lambda m: f"backbone/fpn/{m[1]}"),
    (r"^fusion_backbone\.backbone\.body\.norm(\d)$",
     lambda m: f"backbone/out_norm_{m[1]}"),
    (r"^fusion_backbone\.backbone\.body\.(cross_modal_image_transform\d)$",
     lambda m: f"backbone/{m[1]}"),
]
_DYCONV_NAMES = {v: k for k, v in _DYCONV_INDEX.items()}


def detection_flax_path(key: str, use_deform: bool = True) -> str:
    """The port detector's state_dict key -> the JAX `GroundingDetector`'s
    flax path of the same parameter (the inverse of `_det_key`; the five
    `scales.{l}.scale` are the one leaf `rpn/scales`).  The optimizer
    groups and the tuning masks apply the JAX package's rules to it."""
    if key.startswith(_DET_TEXT):
        path = flax_path("text_transformer." + key[len(_DET_TEXT):])
        return "backbone/language_backbone/" + path[len("text_transformer/"):]
    if key == "fusion_backbone.tunable_linear.weight":
        return "backbone/tunable_linear"
    if key.startswith(_DET_HEAD + "mlm_head."):
        path = flax_path("mlm_score." + key[len(_DET_HEAD + "mlm_head."):])
        return "mlm_head/" + path[len("mlm_score/"):]
    if key == f"{_DET_LOSS}shallow_log_scale":
        return "shallow_head/shallow_log_scale"
    if key in tuple(_DET_HEAD + n for n in ("log_scale", "bias0",
                                            "bias_lang")):
        return "rpn/" + key[len(_DET_HEAD):]
    if re.match(r"rpn\.head\.scales\.\d\.scale$", key):
        return "rpn/scales"
    if key.startswith(_DET_BODY) and re.match(r"(layers|patch_embed)\.",
                                              key[len(_DET_BODY):]):
        path = flax_path("vit_model." + key[len(_DET_BODY):])
        return "backbone/" + path[len("vit_model/"):]
    module, _, leaf = key.rpartition(".")
    for pat, rule in _DET_FLAX_RULES:
        m = re.match(pat, module)
        if m:
            path = rule(m)
            break
    else:
        raise ValueError(f"unknown detection parameter {key!r}")
    if path.endswith("/conv"):       # a tower conv: deformable at its
        if use_deform:               # Conv3x3Norm's level, else nested
            path = path[:-len("/conv")]
    norm = path.endswith(("/gn", "out_norm_1", "out_norm_2", "out_norm_3"))
    if leaf == "weight":
        leaf = "scale" if norm else "kernel"
    return f"{path}/{leaf}"


def detection_params_from_flax(flat: Dict[str, np.ndarray], cfg
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's `GroundingDetector` parameters, flattened to
    "a/b/c" (or "a.b.c") paths of numpy arrays, -> the port's state_dict,
    named as the reference's detection checkpoint names it.  The inverse of
    the JAX package's `convert_detection_state_dict`, and beyond it the
    fusion v1 image projections `cross_modal_image_transform2/3`:

    * conv kernels HWIO become OIHW, Dense kernels are transposed;
    * the level attention's (C, 1) Dense becomes the (1, C, 1, 1) conv
      `AttnConv.1`, and `scales` (5,) the five `scales.{l}.scale`;
    * the tower's convs are read where `cfg.use_deform` puts them (at the
      Conv3x3Norm's level when deformable, under `conv` when not);
    * the Swin and RoBERTa names go through `_port_key`;
    * a text layer's gate `alpha_t2i` is dropped where the layer has no
      cross-attention (fusion v1's layers 6-9, which the JAX package
      builds fused and never fuses)."""
    flat = {k.replace(".", "/"): np.asarray(v) for k, v in flat.items()}
    crossed = {m.group(1) for k in flat
               for m in [re.match(r"(.*/layer_\d+)/crossattention_t2i/", k)]
               if m}
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        if path.startswith("params/"):
            path = path[len("params/"):]
        m = re.match(r"(.*/layer_\d+)/alpha_t2i$", path)
        if m and m.group(1) not in crossed:
            continue
        if path == "rpn/scales":
            for lvl, s in enumerate(value.reshape(-1)):
                out[f"{_DET_HEAD}scales.{lvl}.scale"] = torch.tensor(
                    [float(s)])
            continue
        mapped = _det_key(path, value, cfg.use_deform)
        if mapped is None:
            raise ValueError(f"{path!r} is named for use_deform="
                             f"{not cfg.use_deform}, the config says "
                             f"{cfg.use_deform}")
        key, v = mapped
        if key in out:
            raise ValueError(f"flax paths collide on {key!r}")
        out[key] = torch.from_numpy(np.array(v, np.float32))
    return out
