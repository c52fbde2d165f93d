"""The grounding detector: fusion backbone, VLDyHead, ATSS postprocess.

The PyTorch counterpart of `fiber_tpu/detection/detector.py`, inference
path: `GroundingDetector.forward` (FPN features and the language dict from
`FusionSwinFPN`, the head outputs from `VLDyHead`), `detector_anchors` and
`detection_inference`.  Captions are tokenized on the host.  Module names
are the reference's state_dict keys (`fusion_backbone.*`, `rpn.head.*`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from fiber_torch.detection.anchors import fpn_anchors
from fiber_torch.detection.dyhead import _NOT_PORTED, VLDyHead
from fiber_torch.detection.fusion_backbone import FusionSwinFPN
from fiber_torch.detection.postprocess import Detections, atss_postprocess
from fiber_torch.models.fiber import _TRUNC_NORMAL_STD, resolve_device
from fiber_torch.models.layers import normal_, trunc_normal_

# parameters kept in fp32 when the model is cast to its compute dtype
_FP32_PARAMS = ("relative_position_bias_table", "log_scale", "bias_lang",
                "bias0", ".scale")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """The JAX package's `DetectorConfig` fields that inference reads, with
    the same defaults and a torch `compute_dtype`.  Left out:
    `use_pallas_attention` (the device of the tensor picks the
    window-attention kernel), `remat` and the losses' weights and sizes
    (training: the detection training slice brings them).  The training
    options that switch a head or a loss on (`mlm_loss`, `use_token_loss`,
    `use_contrastive_align`, `use_shallow_contrastive`) and early fusion
    raise NotImplementedError in `GroundingDetector`."""

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
    fusion_version: str = "v2"       # v1 | v2 | v3
    add_linear_layer: bool = False   # the tunable text prompt
    # the training options and GLIP's early fusion (not ported: they raise)
    mlm_loss: bool = False
    use_token_loss: bool = False
    use_contrastive_align: bool = False
    use_shallow_contrastive: bool = False
    early_fuse: str = "none"
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
    initializers draw them, moved to `device` and cast to
    `cfg.compute_dtype` (the relative-position tables and the head's
    `log_scale`, `bias_lang`, `bias0` and `scales` stay fp32).  The model
    serves: it is built in eval mode."""

    def __init__(self, cfg: DetectorConfig, device="cuda", seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        for name in ("mlm_loss", "use_shallow_contrastive"):
            if getattr(cfg, name):
                raise NotImplementedError(f"{name} {_NOT_PORTED}")
        self.cfg = c = cfg
        self.fusion_backbone = FusionSwinFPN(
            image_size=c.image_size, patch_size=c.patch_size,
            embed_dim=c.embed_dim, depths=c.depths, num_heads=c.num_heads,
            window_size=c.window_size, drop_path_rate=c.drop_path_rate,
            num_fuse_block=c.num_fuse_block, out_channels=c.out_channels,
            vocab_size=c.vocab_size, lang_dim=c.lang_dim,
            num_text_heads=c.num_text_heads,
            fusion_version=c.fusion_version,
            add_linear_layer=c.add_linear_layer)
        self.rpn = nn.ModuleDict({"head": VLDyHead(
            num_convs=c.num_dyhead_convs, in_channels=c.out_channels,
            channels=c.out_channels, lang_dim=c.lang_dim,
            use_dyrelu=c.use_dyrelu, use_dyfuse=c.use_dyfuse,
            use_deform=c.use_deform, early_fuse=c.early_fuse,
            use_token_loss=c.use_token_loss,
            use_contrastive_align=c.use_contrastive_align)})
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        for name, p in self.named_parameters():
            if not name.endswith(_FP32_PARAMS):
                p.data = p.data.to(c.compute_dtype)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's initializers: in the Swin body truncated normal
        (std 0.02) linears and relative-position tables and a lecun-normal
        patch embedding; in RoBERTa normal (std 0.02) linears and
        embeddings; the DyHead's 3x3 convs and its three heads normal (std
        0.01), the class head's bias and `bias0` at the focal prior; flax's
        default lecun normal for every other kernel (FPN, offset convs,
        level attention, DyReLU, the text projection, the v1 image
        projections); zero biases, fusion gates and prompt; unit norms and
        scales."""
        head = self.rpn["head"]
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
                                     "centerness"))
                      and name.startswith("rpn")):
                    normal_(m.weight, gen, std=0.01)
                else:
                    _lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(head.cls_logits.bias, head.bias_value)
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

    @property
    def device(self) -> torch.device:
        return self.rpn["head"].bias_lang.device

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, Any]:
        """images (B, H, W, 3) padded NHWC at `cfg.image_size`; input_ids /
        attention_mask (B, T).  Returns {"head_out": per-level box_cls,
        bbox_reg, centerness (B, H, W, A k) and dot_product_logits (B, H W
        A, T); "lang": the language dict}."""
        feats, lang = self.fusion_backbone(
            images.to(self.cfg.compute_dtype), input_ids, attention_mask)
        head_out = self.rpn["head"](feats, lang["embedded"])
        return {"head_out": head_out, "lang": lang}


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
