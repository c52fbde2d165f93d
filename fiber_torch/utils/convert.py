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
`roi_head_params_from_flax` and `dense_head_params_from_flax` carry the
ROI heads and the dense heads (RPN, RetinaNet, FCOS, plain ATSS) across
under the reference's `roi_heads.*` and `rpn.head.` names.
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


def _tower_index(i: int, kind: int, early: bool) -> int:
    """The `dyhead_tower` index of step i's VLFuse (kind 0), language layer
    (1) or DyConv (2): interleaved in threes under early fusion."""
    return 3 * i + kind if early else i


def _det_key(path: str, v: np.ndarray, use_deform: bool,
             early: bool = False) -> Optional[Tuple[str, np.ndarray]]:
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
    m = re.match(r"rpn/(vlfuse|lang_layer)_(\d+)/(.*)$", path)
    if m:
        kind = 0 if m.group(1) == "vlfuse" else 1
        rel = (_vlfuse_key if kind == 0 else _lang_layer_key)(m.group(3), v)
        return (f"{_DET_HEAD}dyhead_tower."
                f"{_tower_index(int(m.group(2)), kind, True)}.{rel[0]}",
                rel[1])
    m = re.match(r"rpn/dyconv_(\d+)/(.*)$", path)
    if m:
        base = (f"{_DET_HEAD}dyhead_tower."
                f"{_tower_index(int(m.group(1)), 2, early)}.")
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


def detection_flax_path(key: str, use_deform: bool = True,
                        early_fuse: str = "none") -> str:
    """The port detector's state_dict key -> the JAX `GroundingDetector`'s
    flax path of the same parameter (the inverse of `_det_key`; the five
    `scales.{l}.scale` are the one leaf `rpn/scales`).  The optimizer
    groups and the tuning masks apply the JAX package's rules to it.
    Under `early_fuse` "mha-b" the tower interleaves VLFuse, language
    layer and DyConv (`dyhead_tower.{3i}`, `{3i+1}`, `{3i+2}`)."""
    m = re.match(r"rpn\.head\.dyhead_tower\.(\d+)\.(.*)$", key)
    if m and early_fuse != "none":
        i, kind = divmod(int(m.group(1)), 3)
        if kind == 0:
            return f"rpn/vlfuse_{i}/{_vlfuse_flax_path(m.group(2))}"
        if kind == 1:
            return f"rpn/lang_layer_{i}/{_lang_layer_flax_path(m.group(2))}"
        key = f"rpn.head.dyhead_tower.{i}.{m.group(2)}"
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
      builds fused and never fuses);
    * under early fusion `vlfuse_{i}`, `lang_layer_{i}` and `dyconv_{i}`
      become `dyhead_tower.{3i}`, `{3i+1}` and `{3i+2}` (`_vlfuse_key`,
      `_lang_layer_key`)."""
    early = getattr(cfg, "early_fuse", "none") != "none"
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
        mapped = _det_key(path, value, cfg.use_deform, early)
        if mapped is None:
            raise ValueError(f"{path!r} is named for use_deform="
                             f"{not cfg.use_deform}, the config says "
                             f"{cfg.use_deform}")
        key, v = mapped
        if key in out:
            raise ValueError(f"flax paths collide on {key!r}")
        out[key] = torch.from_numpy(np.array(v, np.float32))
    return out


# --------------------------------------------------------------------------
# The early-fusion head, the backbone registry and the zoo modules
# --------------------------------------------------------------------------
def _leaf(leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A flax leaf and value -> the port's: a Dense kernel transposed, a
    conv kernel HWIO -> OIHW, a norm's `scale` and an Embed's `embedding`
    its `weight`, a frozen BatchNorm's `mean` / `var` its running
    statistics."""
    if leaf == "kernel":
        return "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
    if leaf in ("scale", "embedding"):
        return "weight", v
    return {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf), v


def _rename(path: str, rules) -> Tuple[str, str]:
    """("a/b/c" module path after `rules`, leaf)."""
    module, _, leaf = path.rpartition("/")
    for pat, rep in rules:
        module = re.sub(pat, rep, module)
    return module.replace("/", "."), leaf


def _check_against(out: Dict[str, torch.Tensor], model: nn.Module) -> None:
    """Raise unless `out` sets exactly `model`'s state_dict, in its
    shapes."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    unknown = sorted(set(out) - set(expected))
    unset = sorted(set(expected) - set(out))
    bad = [(k, tuple(out[k].shape), s) for k, s in expected.items()
           if k in out and tuple(out[k].shape) != s]
    if unknown or unset or bad:
        raise ValueError(f"flax -> port mismatch: unknown {unknown[:10]}, "
                         f"unset {unset[:10]}, shapes {bad[:10]}")


def params_by_rules(flat: Dict[str, np.ndarray], rules,
                    model: Optional[nn.Module] = None,
                    special=None) -> Dict[str, torch.Tensor]:
    """flax "a/b/c" parameters -> a port state_dict: each module path
    renamed by `rules` (regex, replacement) in order, each leaf by
    `_leaf`; `special(path, value)` may map a path itself (a (key, value)
    pair, or None to fall through).  Checked against `model` when given."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        v = np.asarray(v)
        mapped = special(path, v) if special is not None else None
        if mapped is None:
            module, leaf = _rename(path, rules)
            leaf, v = _leaf(leaf, v)
            mapped = (f"{module}.{leaf}" if module else leaf), v
        key, v = mapped
        if key in out:
            raise ValueError(f"flax paths collide on {key!r}")
        out[key] = torch.from_numpy(np.array(v, np.float32))
    if model is not None:
        _check_against(out, model)
    return out


_VLFUSE_LISTS = r"(query_proj|joint_fusion|gamma|beta)"


def _vlfuse_key(rel: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A path inside the JAX `VLFuse` -> the port's key inside `VLFuse`
    (the per-level `query_proj_{i}` ... become ModuleList entries)."""
    module, leaf = _rename(rel, [(_VLFUSE_LISTS + r"_(\d+)", r"\1/\2")])
    leaf, v = _leaf(leaf, v)
    return (f"{module}.{leaf}" if module else leaf), v


def _vlfuse_flax_path(rel_key: str) -> str:
    module, _, leaf = rel_key.rpartition(".")
    module = re.sub(_VLFUSE_LISTS + r"\.(\d+)", r"\1_\2", module)
    module = module.replace(".", "/")
    if leaf == "weight":
        leaf = ("scale" if module.rsplit("/", 1)[-1].startswith("layer_norm")
                else "kernel")
    return f"{module}/{leaf}" if module else leaf


# the JAX `CLIPTransformerLayer`'s modules -> the port's (nn.MultiheadAttention
# and the reference's `mlp` names)
_CLIP_LAYER = {"out_proj": "attn.out_proj", "c_fc": "mlp.c_fc",
               "c_proj": "mlp.c_proj", "ln_1": "ln_1", "ln_2": "ln_2"}


def _lang_layer_key(rel: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A path inside a JAX early-fusion language layer (a `RobertaLayer` or
    a `CLIPTransformerLayer`) -> the port's key inside the layer."""
    module, _, leaf = rel.rpartition("/")
    if module == "in_proj":
        return (("attn.in_proj_weight", v.T) if leaf == "kernel"
                else ("attn.in_proj_bias", v))
    if module in _CLIP_LAYER:
        leaf, v = _leaf(leaf, v)
        return f"{_CLIP_LAYER[module]}.{leaf}", v
    key, v = _port_key("text_transformer/layer_0/" + rel, v)
    return key[len("text_transformer.encoder.layer.0."):], v


def _lang_layer_flax_path(rel_key: str) -> str:
    if rel_key in ("attn.in_proj_weight", "attn.in_proj_bias"):
        return "in_proj/" + ("kernel" if rel_key.endswith("weight")
                             else "bias")
    module, _, leaf = rel_key.rpartition(".")
    back = {v: k for k, v in _CLIP_LAYER.items()}
    if module in back:
        module = back[module]
        if leaf == "weight":
            leaf = "scale" if module.startswith("ln_") else "kernel"
        return f"{module}/{leaf}"
    path = flax_path("text_transformer.encoder.layer.0." + rel_key)
    return path[len("text_transformer/layer_0/"):]


def vlfuse_params_from_flax(flat: Dict[str, np.ndarray],
                            model: Optional[nn.Module] = None
                            ) -> Dict[str, torch.Tensor]:
    """The JAX `VLFuse` parameters -> the port's `VLFuse` state_dict."""
    return params_by_rules(flat, [], model,
                           special=lambda p, v: _vlfuse_key(p, v))


def lang_layer_params_from_flax(flat: Dict[str, np.ndarray],
                                model: Optional[nn.Module] = None
                                ) -> Dict[str, torch.Tensor]:
    """A JAX `RobertaLayer` or `CLIPTransformerLayer` -> the port's."""
    return params_by_rules(flat, [], model,
                           special=lambda p, v: _lang_layer_key(p, v))


# module renames of each family, flax path -> port path ("/"-separated)
_FPN_RULES = [
    (r"(^|/)fpn/lateral_(\d)$",
     lambda m: f"{m[1]}fpn/fpn_inner{int(m[2]) + 2}"),
    (r"(^|/)fpn/output_(\d)$",
     lambda m: f"{m[1]}fpn/fpn_layer{int(m[2]) + 2}"),
    (r"(^|/)fpn/(p6|p7)$", r"\1fpn/top_blocks/\2"),
]
ZOO_RULES = {
    # SwinV2Backbone, SwinVLBackbone
    "swin": [(r"(^|/)stage(\d+)_block(\d+)", r"\1layers/\2/blocks/\3"),
             (r"(^|/)downsample(\d+)", r"\1layers/\2/downsample"),
             (r"(^|/)out_norm(\d+)$", r"\1norm\2")],
    "resnet": [(r"(^|/)stem_conv$", r"\1stem/conv1"),
               (r"(^|/)stem_bn$", r"\1stem/bn1"),
               (r"(^|/)layer(\d+)_block(\d+)", r"\1layer\2/\3"),
               (r"(^|/)downsample_conv$", r"\1downsample/0"),
               (r"(^|/)downsample_bn$", r"\1downsample/1")],
    "efficientnet": [(r"(^|/)s(\d+)_b(\d+)", r"\1stages/\2/\3")],
    "bifpn": [(r"(^|/)bifpn/layer(\d+)", r"\1bifpn/layers/\2"),
              (r"^layer(\d+)", r"layers/\1")],
    "fbnet": [(r"(^|/)stage(\d+)_block(\d+)", r"\1stages/\2/\3")],
    "layers_zoo": [],
    "rnn": [(r"^mlp$", "mlp/0")],
    "bert_text": [(r"^(word|position|token_type)_embeddings$",
                   r"embeddings/\1_embeddings"),
                  (r"^LayerNorm$", "embeddings/LayerNorm")],
    "clip_text": [],
}


def _rnn_special(path: str, v: np.ndarray):
    """flax's per-gate LSTM / GRU cells (`LSTMCell_{k}` / `GRUCell_{k}`, k
    counting layer by layer, the forward direction first) -> one entry
    per gate, gathered by `_pack_rnn`."""
    m = re.match(r"(LSTM|GRU)Cell_(\d+)/([ih])(\w)/(kernel|bias)$", path)
    if m is None:
        return None
    kind, k, side, gate, leaf = m.groups()
    return f"__rnn__/{kind}/{k}/{side}{gate}/{leaf}", v


def _pack_rnn(out: Dict[str, torch.Tensor], bidirectional: bool
              ) -> Dict[str, torch.Tensor]:
    """Gather `_rnn_special`'s gate entries into torch's `rnn.weight_ih_l{k}
    [_reverse]`, `weight_hh`, `bias_ih`, `bias_hh` (gates i f g o, or r z
    n; a gate flax has no bias for gets zeros)."""
    parts: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}
    for key in [key for key in out if key.startswith("__rnn__")]:
        _, kind, k, gate, leaf = key.split("/")
        parts.setdefault((kind, int(k)), {})[f"{gate}/{leaf}"] = out.pop(key)
    dirs = 2 if bidirectional else 1
    for (kind, k), p in parts.items():
        gates = "ifgo" if kind == "LSTM" else "rzn"
        layer, sfx = k // dirs, "_reverse" if k % dirs else ""
        H = p[f"h{gates[0]}/kernel"].shape[1]
        for side in "ih":
            out[f"rnn.weight_{side}h_l{layer}{sfx}"] = torch.cat(
                [p[f"{side}{g}/kernel"].T for g in gates])
            out[f"rnn.bias_{side}h_l{layer}{sfx}"] = torch.cat(
                [p.get(f"{side}{g}/bias", torch.zeros(H)) for g in gates])
    return out


def _zoo_special(family: str):
    if family in ("bert_text",):
        def special(path, v):
            m = re.match(r"layer_(\d+)/(.*)$", path)
            if m is None:
                return None
            key, v = _port_key(f"text_transformer/layer_{m[1]}/{m[2]}", v)
            return "encoder." + key[len("text_transformer.encoder."):], v
        return special
    if family == "clip_text":
        names = {"ln1": "ln_1", "qkv": "in_proj", "attn_out": "out_proj",
                 "ln2": "ln_2", "mlp_fc": "c_fc", "mlp_proj": "c_proj"}

        def special(path, v):
            m = re.match(r"(ln1|qkv|attn_out|ln2|mlp_fc|mlp_proj)_(\d+)/(.*)$",
                         path)
            if m is None:
                return None
            key, v = _lang_layer_key(f"{names[m[1]]}/{m[3]}", v)
            return f"transformer.resblocks.{m[2]}.{key}", v
        return special
    if family in ("layers_zoo",):
        def special(path, v):
            m = re.match(r"dyconv_(\d+)/(.*)$", path)
            if m is None:
                return None
            key, v = _det_key(f"rpn/dyconv_{m[1]}/{m[2]}", v, True)
            return key[len(_DET_HEAD):], v
        return special
    if family == "rnn":
        return _rnn_special
    return None


def zoo_params_from_flax(family: str, flat: Dict[str, np.ndarray],
                         model: Optional[nn.Module] = None,
                         bidirectional: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """The parameters of a JAX zoo module -> the port's state_dict.
    `family`: "swin" (SwinV2Backbone / SwinVLBackbone and their blocks
    under `stage{s}_block{b}`), "resnet", "efficientnet", "bifpn",
    "fbnet", "layers_zoo", "rnn" (its cells two a layer when
    `bidirectional`), "bert_text", "clip_text"."""
    out = params_by_rules(flat, ZOO_RULES[family] + _FPN_RULES,
                          special=_zoo_special(family))
    if family == "rnn":
        out = _pack_rnn(out, bidirectional)
    if model is not None:
        _check_against(out, model)
    return out


# registry name -> the families of its trunk (under `body`) and neck
def _registry_rules(name: str):
    if name.startswith("R-"):
        trunk = ZOO_RULES["resnet"]
    elif name.startswith("SWINT"):
        trunk = ZOO_RULES["swin"]
    elif name.startswith("EFFICIENTNET"):
        trunk = ZOO_RULES["efficientnet"] + ZOO_RULES["bifpn"]
    elif name.startswith("FBNET"):
        trunk = ZOO_RULES["fbnet"]
    else:
        raise ValueError(f"no flax rules for backbone {name!r}")
    return [(r"^trunk(/|$)", r"body\1")] + trunk + _FPN_RULES


def backbone_params_from_flax(name: str, flat: Dict[str, np.ndarray],
                              model: Optional[nn.Module] = None
                              ) -> Dict[str, torch.Tensor]:
    """The parameters of the JAX `build_backbone(name)` module -> the
    port's (the trunk `trunk` becomes `body`).  The fusion backbone goes
    through the detector's mapping (`_det_key` under `backbone/`)."""
    if name.startswith("FUSION"):
        def special(path, v):
            key, v = _det_key("backbone/" + path, v, True)
            return key[len("fusion_backbone."):], v
        return params_by_rules(flat, [], model, special=special)
    return params_by_rules(flat, _registry_rules(name), model)


# --------------------------------------------------------------------------
# The ROI heads and the dense heads
# --------------------------------------------------------------------------
# the reference's state_dict prefixes of the heads in a full model
ROI_HEAD_PREFIX = {"box": "roi_heads.box.", "mask": "roi_heads.mask.",
                   "keypoint": "roi_heads.keypoint."}
DENSE_HEAD_PREFIX = "rpn.head."
_ROI_RULES = [
    (r"^(fc6|fc7|mask_fcn\d+|conv_fcn\d+)$", r"feature_extractor/\1"),
    (r"^(cls_score|bbox_pred|conv5_mask|mask_fcn_logits|kps_score_lowres)$",
     r"predictor/\1"),
]


def roi_head_params_from_flax(flat: Dict[str, np.ndarray],
                              model: Optional[nn.Module] = None,
                              pool_size: Optional[int] = None,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX `BoxHead`, `MaskHead` or `KeypointHead` -> the port's
    state_dict, each key behind `prefix` (`ROI_HEAD_PREFIX[kind]` for the
    reference's full-model names).  fc6's rows are the JAX pool's (P, P,
    C) flattening, the port's (C, P, P): they are reordered (P from
    `pool_size`, else `model.pool_size`, else 7).  A flax ConvTranspose
    does not flip its kernel: the torch weight is the (kh, kw, in, out)
    kernel flipped in both spatial axes, laid out (in, out, kh, kw)."""
    P = pool_size or getattr(model, "pool_size", 7)

    def special(path, v):
        module, _, leaf = path.rpartition("/")
        if leaf != "kernel":
            return None
        if module == "fc6":
            C = v.shape[0] // (P * P)
            w = v.reshape(P, P, C, -1).transpose(3, 2, 0, 1)
            return "feature_extractor.fc6.weight", w.reshape(v.shape[1], -1)
        if module in ("conv5_mask", "kps_score_lowres"):
            return (f"predictor.{module}.weight",
                    v[::-1, ::-1].transpose(2, 3, 0, 1))
        return None

    out = params_by_rules(flat, _ROI_RULES, model, special=special)
    return {prefix + k: v for k, v in out.items()}


def dense_head_params_from_flax(flat: Dict[str, np.ndarray],
                                model: Optional[nn.Module] = None,
                                prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX `RPNHead`, `RetinaNetHead`, `FCOSHead` or `PlainAtssHead` ->
    the port's state_dict, keys behind `prefix` (`DENSE_HEAD_PREFIX` for
    the reference's).  The towers' `conv{i}` / `gn{i}` are the
    Sequential's `{3i}` / `{3i+1}` with GroupNorm, `conv{i}` is `{2i}`
    without; the per-level `scales` (L,) become `scales.{l}.scale` (1,)."""
    flat = {(k[len("params/"):] if k.startswith("params/") else k): v
            for k, v in flat.items()}
    scales = flat.pop("scales", None)
    step = 3 if any(re.search(r"_tower/gn\d+/", k) for k in flat) else 2
    rules = [(r"^(cls_tower|bbox_tower)/conv(\d+)$",
              lambda m: f"{m[1]}/{step * int(m[2])}"),
             (r"^(cls_tower|bbox_tower)/gn(\d+)$",
              lambda m: f"{m[1]}/{step * int(m[2]) + 1}")]
    out = params_by_rules(flat, rules)
    if scales is not None:
        for l, s in enumerate(np.asarray(scales, np.float32)):
            out[f"scales.{l}.scale"] = torch.tensor([float(s)])
    if model is not None:
        _check_against(out, model)
    return {prefix + k: v for k, v in out.items()}
