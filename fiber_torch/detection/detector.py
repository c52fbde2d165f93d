"""The grounding detector: fusion backbone, VLDyHead, ATSS loss and
postprocess.

The PyTorch counterpart of `fiber_tpu/detection/detector.py`:
`GroundingDetector.forward` (FPN features and the language dict from
`FusionSwinFPN`, the head outputs from `VLDyHead`, and with the training
options the MLM logits and the shallow contrastive projections),
`detector_anchors`, `detection_loss` and `detection_inference`.  Captions
are tokenized on the host.  Module names are the reference's state_dict
keys (`fusion_backbone.*`, `rpn.head.*`; the MLM head `rpn.head.mlm_head.*`
and the shallow projections `rpn.loss_evaluator.*`, where the reference
keeps them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fiber_torch.detection import mlm as det_mlm
from fiber_torch.detection.anchors import fpn_anchors
from fiber_torch.detection.atss import batched_atss_assign
from fiber_torch.detection.atss_loss import atss_grounding_loss
from fiber_torch.detection.contrastive import (ShallowProjections,
                                               select_shallow_anchors,
                                               shallow_contrastive_loss)
from fiber_torch.detection.dyhead import VLDyHead
from fiber_torch.detection.fusion_backbone import FusionSwinFPN
from fiber_torch.detection.postprocess import Detections, atss_postprocess
from fiber_torch.models.fiber import _TRUNC_NORMAL_STD, resolve_device
from fiber_torch.models.heads import MLMHead
from fiber_torch.models.layers import normal_, trunc_normal_
from fiber_torch.models.roberta import RobertaLayer
from fiber_torch.parallel.data_parallel import global_count

# parameters kept in fp32 when the model is cast to its compute dtype
_FP32_PARAMS = ("relative_position_bias_table", "log_scale", "bias_lang",
                "bias0", ".scale")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """The JAX package's `DetectorConfig` fields with the same defaults and
    a torch `compute_dtype`.  Left out: `use_pallas_attention` (the device
    of the tensor picks the window-attention kernel).  GLIP's early fusion
    in the head: `early_fuse` "mha-b" (VLFuse and a language layer before
    each DyConv), the layer `lang_model` "bert" or "clip", `clamp_bertattn`
    (the BERT layers' scores clamped to +-50000) and
    `use_fused_features_dot_product` (a language layer after the last
    VLFuse too).

    The training options: `atss_topk` and `reg_loss_weight` of the ATSS
    loss; `mlm_loss` (GLIP's masked-word pretext on the embedded text, an
    MLM head), `use_token_loss` (the soft-token head), `use_contrastive_
    align` (MDETR's box-token alignment) and `use_shallow_contrastive`
    (GLIP's contrastive loss on the raw FPN features), each with its weight
    and sizes; `remat` checkpoints every Swin block and DyConv in
    training."""

    # static padded image size (H, W), a multiple of 32
    image_size: Tuple[int, int] = (1344, 1344)
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    drop_path_rate: float = 0.0
    num_fuse_block: int = 6
    out_channels: int = 256
    num_dyhead_convs: int = 6
    max_query_len: int = 256
    vocab_size: int = 50265
    lang_dim: int = 768
    num_text_heads: int = 12
    anchor_sizes: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    use_dyrelu: bool = True
    use_dyfuse: bool = True
    use_deform: bool = True
    atss_topk: int = 9
    reg_loss_weight: float = 2.0
    fusion_version: str = "v2"       # v1 | v2 | v3
    add_linear_layer: bool = False   # the tunable text prompt
    mlm_loss: bool = False
    mlm_loss_coef: float = 1.0
    mlm_loss_for_only_positives: bool = True
    mask_token_id: int = 50264       # RoBERTa's <mask>
    pad_token_id: int = 1
    use_token_loss: bool = False
    token_loss_weight: float = 1.0
    use_contrastive_align: bool = False
    contrastive_hdim: int = 64
    contrastive_align_loss_weight: float = 1.0
    use_shallow_contrastive: bool = False
    shallow_contrastive_hdim: int = 64
    shallow_max_positive_anchors: int = 100
    shallow_zero_pads: bool = False
    shallow_contrastive_loss_weight: float = 1.0
    remat: bool = False
    early_fuse: str = "none"         # "none" | "mha-b" (GLIP's early fusion)
    lang_model: str = "bert"         # the early-fusion text layer: bert | clip
    clamp_bertattn: bool = False
    use_fused_features_dot_product: bool = False
    compute_dtype: Any = torch.float32

    @classmethod
    def tiny_test(cls, **kw) -> "DetectorConfig":
        d = dict(image_size=(64, 64), embed_dim=16, depths=(1, 1, 3, 2),
                 num_heads=(2, 2, 2, 2), window_size=2, num_fuse_block=4,
                 out_channels=16, num_dyhead_convs=2, max_query_len=16,
                 vocab_size=99, lang_dim=32, num_text_heads=2,
                 anchor_sizes=(16, 32, 64, 128, 256),
                 use_deform=False)
        d.update(kw)
        return cls(**d)

    def feat_sizes(self, image_size=None) -> List[Tuple[int, int]]:
        H, W = self.image_size if image_size is None else image_size
        return [(-(-H // s), -(-W // s)) for s in self.anchor_strides]


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal cut at two of its std, scaled
    so that the drawn weights have std 1/sqrt(fan_in)."""
    fan_in = w[0].numel()
    trunc_normal_(w, gen, std=fan_in ** -0.5 / _TRUNC_NORMAL_STD)


class GroundingDetector(nn.Module):
    """Weights are drawn from `seed` on the host, as the JAX package's
    initializers draw them, and moved to `device`.

    Built to serve (the default), the parameters are cast to
    `cfg.compute_dtype` (the relative-position tables and the head's
    `log_scale`, `bias_lang`, `bias0` and `scales` stay fp32) and the model
    is in eval mode.  Built `for_training`, every parameter stays fp32, the
    optimizer's master copy, the model is in train mode, and the forward
    runs in `cfg.compute_dtype` inside `self.autocast()`.  Any input size
    that is a multiple of 32 runs on the one parameter set (the Swin blocks
    build their shift masks for the size they are given)."""

    def __init__(self, cfg: DetectorConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = c = cfg
        self.fusion_backbone = FusionSwinFPN(
            image_size=c.image_size, patch_size=c.patch_size,
            embed_dim=c.embed_dim, depths=c.depths, num_heads=c.num_heads,
            window_size=c.window_size, drop_path_rate=c.drop_path_rate,
            num_fuse_block=c.num_fuse_block, out_channels=c.out_channels,
            vocab_size=c.vocab_size, lang_dim=c.lang_dim,
            num_text_heads=c.num_text_heads,
            fusion_version=c.fusion_version,
            add_linear_layer=c.add_linear_layer, remat=c.remat)
        head = VLDyHead(
            num_convs=c.num_dyhead_convs, in_channels=c.out_channels,
            channels=c.out_channels, lang_dim=c.lang_dim,
            use_dyrelu=c.use_dyrelu, use_dyfuse=c.use_dyfuse,
            use_deform=c.use_deform, early_fuse=c.early_fuse,
            max_query_len=c.max_query_len, use_token_loss=c.use_token_loss,
            use_contrastive_align=c.use_contrastive_align,
            contrastive_hdim=c.contrastive_hdim, remat=c.remat,
            num_text_heads=c.num_text_heads, lang_model=c.lang_model,
            clamp_bertattn=c.clamp_bertattn,
            use_fused_features_dot_product=c.use_fused_features_dot_product)
        if c.mlm_loss:
            # BertLMPredictionHead on the embedded text, in the head module
            # as the reference keeps it
            head.mlm_head = MLMHead(c.lang_dim, c.vocab_size)
        self.rpn = nn.ModuleDict({"head": head})
        if c.use_shallow_contrastive:
            self.rpn["loss_evaluator"] = ShallowProjections(
                c.out_channels, c.lang_dim, c.shallow_contrastive_hdim)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        if not for_training:
            for name, p in self.named_parameters():
                if not name.endswith(_FP32_PARAMS):
                    p.data = p.data.to(c.compute_dtype)
        self.train(for_training)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's initializers: in the Swin body truncated normal
        (std 0.02) linears and relative-position tables and a lecun-normal
        patch embedding; in RoBERTa normal (std 0.02) linears and
        embeddings; the DyHead's 3x3 convs and its three heads normal (std
        0.01), the class and token heads' biases and `bias0` at the focal
        prior; the contrastive image projection normal (std 0.01), the MLM
        head normal (std 0.02); under early fusion the BERT language layers
        normal (std 0.02), MHA-B's four input projections xavier uniform,
        its gammas 1/8; flax's default lecun normal for every other kernel
        (FPN, offset convs, level attention, DyReLU, the text projections,
        the v1 image projections, the shallow projections, the CLIP
        layers); zero biases, fusion gates and prompt; unit norms and
        scales."""
        head = self.rpn["head"]
        bert_layers = tuple(f"rpn.head.dyhead_tower.{i}."
                            for i, m in enumerate(head.dyhead_tower)
                            if isinstance(m, RobertaLayer))
        for name, m in self.named_modules():
            if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, gen)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                if name.endswith("tunable_linear"):
                    nn.init.zeros_(m.weight)
                elif name.startswith("fusion_backbone.backbone.body.layers"):
                    trunc_normal_(m.weight, gen)
                elif name.startswith("fusion_backbone.language_backbone"):
                    normal_(m.weight, gen)
                elif (name.endswith((".conv", "cls_logits", "bbox_pred",
                                     "centerness", "token_logits",
                                     "contrastive_align_projection_image"))
                      and name.startswith("rpn")):
                    normal_(m.weight, gen, std=0.01)
                elif ".mlm_head." in name or name.startswith(bert_layers):
                    normal_(m.weight, gen)
                elif name.endswith(("attn.v_proj", "attn.l_proj",
                                    "attn.values_v_proj",
                                    "attn.values_l_proj")):
                    nn.init.xavier_uniform_(m.weight, generator=gen)
                else:
                    _lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(head.cls_logits.bias, head.bias_value)
        if self.cfg.use_token_loss:
            nn.init.constant_(head.token_logits.bias, head.bias_value)
        for name, p in self.named_parameters():
            if name.endswith("relative_position_bias_table"):
                trunc_normal_(p, gen)
            elif name.endswith(("alpha_i2t", "alpha_t2i", "log_scale",
                                "bias_lang")):
                nn.init.zeros_(p)
            elif name.endswith("bias0"):
                nn.init.constant_(p, head.bias_value)
            elif name.endswith(".scale"):
                nn.init.ones_(p)
            elif name.endswith("in_proj_weight"):
                _lecun_normal_(p, gen)
            elif name.endswith("in_proj_bias"):
                nn.init.zeros_(p)
            elif name.endswith(("gamma_v", "gamma_l", "gamma")):
                nn.init.constant_(p, 1.0 / 8)

    @property
    def device(self) -> torch.device:
        return self.rpn["head"].bias_lang.device

    def autocast(self) -> torch.autocast:
        """The context a forward on parameters wider than the compute dtype
        runs in (a no-op when they are the same)."""
        wide = self.rpn["head"].cls_logits.weight.dtype
        return torch.autocast(self.device.type, dtype=self.cfg.compute_dtype,
                              enabled=wide != self.cfg.compute_dtype)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, Any]:
        """images (B, H, W, 3) padded NHWC, H and W multiples of 32;
        input_ids / attention_mask (B, T).  Returns {"head_out": per-level
        box_cls, bbox_reg, centerness (B, H, W, A k), dot_product_logits
        (B, H W A, T) and the training heads' logits; "lang": the language
        dict}; with `mlm_loss` also "mlm_logits" (B, T, V), with
        `use_shallow_contrastive` "shallow_qi" (B, sum H W, h) over the raw
        FPN features, "shallow_qt" (B, T, h) and "shallow_log_scale"."""
        c = self.cfg
        feats, lang = self.fusion_backbone(
            images.to(c.compute_dtype), input_ids, attention_mask)
        head = self.rpn["head"]
        out = {"head_out": head(feats, lang["embedded"],
                                lang_mask=attention_mask),
               "lang": lang}
        if c.mlm_loss:
            out["mlm_logits"] = head.mlm_head(lang["embedded"])
        if c.use_shallow_contrastive:
            fpn_flat = torch.cat([f.flatten(2).transpose(1, 2) for f in feats],
                                 dim=1)
            qi, qt, ls = self.rpn["loss_evaluator"](fpn_flat,
                                                    lang["embedded"])
            out.update(shallow_qi=qi, shallow_qt=qt, shallow_log_scale=ls)
        return out


def detector_anchors(cfg: DetectorConfig, image_size=None, device="cpu"):
    """(all anchors (N, 4), the per-level counts, the per-level anchors),
    fp32 tensors on `device`; `image_size` overrides `cfg.image_size`."""
    per_level = fpn_anchors(tuple(cfg.feat_sizes(image_size)),
                            strides=cfg.anchor_strides,
                            sizes=cfg.anchor_sizes)
    sizes = tuple(a.shape[0] for a in per_level)
    per_level = [torch.from_numpy(a).to(device) for a in per_level]
    return torch.cat(per_level), sizes, per_level


def _on(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype).to(device)


# the batch fields `detection_loss` reads, with their dtypes
_LOSS_FIELDS = {"images": torch.float32, "input_ids": torch.long,
                "attention_mask": torch.long, "gt_boxes": torch.float32,
                "gt_valid": torch.bool, "positive_map": torch.float32,
                "greenlight_map": torch.long, "gt_od_labels": torch.long,
                "od_label_of_tokens": torch.long}


def detection_loss(model: GroundingDetector, batch: Mapping[str, Any], *,
                   train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   group=None) -> Dict[str, torch.Tensor]:
    """The losses of one batch and their sum `total_loss`, 0-dim fp32
    tensors on the model's device.  batch: images (B, H, W, 3),
    input_ids / attention_mask (B, T), gt_boxes (B, G, 4), gt_valid (B,
    G), positive_map (B, G, T); with `mlm_loss` optionally greenlight_map
    (B, T); with `use_shallow_contrastive` gt_od_labels (B, G) and
    od_label_of_tokens (B, T) (-1: no label).  Tensors or numpy arrays.

    With `train` and `mlm_loss`, words are masked with draws from
    `generator`.  The forward runs under the model's autocast; the losses
    are computed in fp32.

    Under a process `group` the batch is this rank's rows of the global
    batch: the masking is drawn for the global batch (seed `generator`
    alike on every rank) and every loss is this rank's partial, so that
    the sums over ranks are the global batch's losses."""
    cfg = model.cfg
    dev = model.device
    b = {k: _on(v, dev, _LOSS_FIELDS[k]) for k, v in batch.items()
         if k in _LOSS_FIELDS}
    input_ids, mlm_labels = b["input_ids"], None
    if cfg.mlm_loss and train:
        greenlight = (b.get("greenlight_map")
                      if cfg.mlm_loss_for_only_positives else None)
        draws = {}
        if group is not None:
            probs, rand_tokens = det_mlm.draw_mask_inputs(
                generator, input_ids, cfg.vocab_size, group)
            draws = dict(probs=probs, rand_tokens=rand_tokens)
        input_ids, mlm_labels = det_mlm.random_word_mask(
            generator, input_ids, cfg.mask_token_id, cfg.vocab_size,
            cfg.pad_token_id, greenlight, **draws)
    with model.autocast():
        out = model(b["images"], input_ids, b["attention_mask"])
    anchors, level_sizes, _ = detector_anchors(
        cfg, tuple(b["images"].shape[1:3]), device=dev)
    assign = None
    if cfg.use_shallow_contrastive:
        assign = batched_atss_assign(anchors, level_sizes, b["gt_boxes"],
                                     b["gt_valid"], topk=cfg.atss_topk)
    losses = atss_grounding_loss(
        out["head_out"], anchors, level_sizes, b["gt_boxes"], b["gt_valid"],
        b["positive_map"], b["attention_mask"],
        reg_loss_weight=cfg.reg_loss_weight, topk=cfg.atss_topk,
        assign=assign, group=group)
    if cfg.use_token_loss:
        losses["loss_token"] = losses["loss_token"] * cfg.token_loss_weight
    if cfg.use_contrastive_align:
        losses["loss_contrastive_align"] = (
            losses["loss_contrastive_align"]
            * cfg.contrastive_align_loss_weight)
    if cfg.use_shallow_contrastive:
        num_pos = global_count(assign.pos_mask.sum(),
                               group).float().clamp_min(1.0)
        sel_idx, sel_is_pos = select_shallow_anchors(
            assign.pos_mask, assign.assigned_gt,
            cfg.shallow_max_positive_anchors)
        losses["loss_shallow_contrastive"] = shallow_contrastive_loss(
            out["shallow_qi"], out["shallow_qt"], out["shallow_log_scale"],
            b["attention_mask"], sel_idx, sel_is_pos, assign.assigned_gt,
            b["positive_map"], b["gt_od_labels"], b["od_label_of_tokens"],
            num_pos, zero_pads=cfg.shallow_zero_pads, group=group,
        ) * cfg.shallow_contrastive_loss_weight
    if mlm_labels is not None:
        losses["mlm_loss"] = det_mlm.mlm_loss(out["mlm_logits"], mlm_labels,
                                              cfg.mlm_loss_coef, group=group)
    losses["total_loss"] = sum(losses.values())
    return losses


@torch.inference_mode()
def detection_inference(model: GroundingDetector, batch: Dict[str, Any],
                        agg_matrix, **pp_kwargs) -> Detections:
    """One detector pass and the ATSS postprocess.  batch: images (B, H,
    W, 3), input_ids / attention_mask (B, T), image_sizes (B, 2) (h, w),
    tensors or numpy arrays; agg_matrix (C, T) from
    `label_to_token_matrix`.  Everything runs on the model's device."""
    dev = model.device
    images = _on(batch["images"], dev, torch.float32)
    out = model(images, _on(batch["input_ids"], dev, torch.long),
                _on(batch["attention_mask"], dev, torch.long))
    _, _, per_level = detector_anchors(model.cfg, tuple(images.shape[1:3]),
                                       device=dev)
    return atss_postprocess(out["head_out"], per_level,
                            _on(agg_matrix, dev, torch.float32),
                            _on(batch["image_sizes"], dev, torch.float32),
                            **pp_kwargs)
