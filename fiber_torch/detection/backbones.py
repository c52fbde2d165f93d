"""The detection backbone registry: a CONV_BODY name -> trunk and neck.

The PyTorch counterpart of `fiber_tpu/detection/backbones.py`, with the
same 14 names.  Two kinds of module:

* vision-only (`VisionFPN`, `VisionBiFPN`): module(images) -> [P3..P7];
* language-aware (`SwinVLFPN`, and the FIBER fusion backbone):
  module(images, text..., masks) -> (feats, language dict).

`build_backbone(name, image_size, out_channels)` returns (module,
language_aware) and raises KeyError on a name it does not know.  Images
are NHWC (B, H, W, 3); the levels leave NCHW.  Module names: the trunk
`body`, the neck `fpn` (or `bifpn`), as the reference names them.  The
Swin-T trunks take GLIP-T's widths (embed 96, depths 2 / 2 / 6 / 2, heads
3 / 6 / 12 / 24, window 7): their window attention runs K1 forward and K2
backward on a CUDA tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fiber_torch.detection.fpn import FPN
from fiber_torch.models import backbone_zoo, fbnet
from fiber_torch.models.alt_backbones import ResNetBackbone
from fiber_torch.models.backbone_zoo import BiFPN, EfficientNetBackbone
from fiber_torch.models.fbnet import FBNetTrunk
from fiber_torch.models.swin_v2 import SwinV2Backbone
from fiber_torch.models.swin_vl import SwinVLBackbone


class VisionFPN(nn.Module):
    """A trunk's last `take_last` taps through an FPN -> P3..P7."""

    def __init__(self, body: nn.Module, in_channels: Sequence[int],
                 out_channels: int = 256, take_last: int = 3):
        super().__init__()
        self.take_last = take_last
        self.body = body
        self.fpn = FPN(list(in_channels)[-take_last:], out_channels)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        taps = self.body(images)
        if isinstance(taps, tuple):      # (taps, None) of a Swin-VL trunk
            taps = taps[0]
        return self.fpn(taps[-self.take_last:])


class VisionBiFPN(nn.Module):
    """A trunk's last three taps through a stacked BiFPN -> P3..P7."""

    def __init__(self, body: nn.Module, in_channels: Sequence[int],
                 out_channels: int = 256, repeats: int = 3):
        super().__init__()
        self.body = body
        self.bifpn = BiFPN(out_channels, repeats, tuple(in_channels))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        return self.bifpn(self.body(images)[-3:])


class SwinVLFPN(nn.Module):
    """A language-aware Swin-T trunk (v1 or v2) and an FPN:
    forward(images, lang_hidden, lang_masks) -> (P3..P7, the language
    dict)."""

    def __init__(self, image_size: Tuple[int, int], version: str = "v1",
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, max_query_len: int = 256,
                 lang_dim: int = 768, out_channels: int = 256):
        super().__init__()
        self.body = SwinVLBackbone(
            image_size, embed_dim=embed_dim, depths=depths,
            num_heads=num_heads, window_size=window_size,
            max_query_len=max_query_len, lang_dim=lang_dim, version=version,
            out_indices=(1, 2, 3))
        self.fpn = FPN([embed_dim * 2 ** i for i in (1, 2, 3)], out_channels)

    def forward(self, images: torch.Tensor, lang_hidden: torch.Tensor,
                lang_masks: Optional[torch.Tensor] = None):
        outs, lang = self.body(images, lang_hidden, lang_masks)
        return self.fpn(outs), lang


_SWIN_T_TAPS = (192, 384, 768)


def _resnet(layers):
    def f(image_size, out_channels):
        return VisionFPN(ResNetBackbone(layers), (512, 1024, 2048),
                         out_channels), False
    return f


def _swint(version, vl):
    def f(image_size, out_channels):
        if vl:
            return SwinVLFPN(image_size, version,
                             out_channels=out_channels), True
        body = SwinVLBackbone(image_size, version=version, vl=False,
                              out_indices=(1, 2, 3))
        return VisionFPN(body, _SWIN_T_TAPS, out_channels), False
    return f


def _swint_v2_standalone(image_size, out_channels):
    body = SwinV2Backbone(image_size, out_indices=(1, 2, 3))
    return VisionFPN(body, _SWIN_T_TAPS, out_channels), False


def _effnet_bifpn(variant):
    def f(image_size, out_channels):
        return VisionBiFPN(EfficientNetBackbone(variant),
                           backbone_zoo.tap_channels(variant),
                           out_channels), False
    return f


def _fbnet(arch):
    def f(image_size, out_channels):
        return VisionFPN(FBNetTrunk(arch), fbnet.tap_channels(arch),
                         out_channels), False
    return f


def _fusion(image_size, out_channels):
    from fiber_torch.detection.fusion_backbone import FusionSwinFPN
    return FusionSwinFPN(image_size=image_size,
                         out_channels=out_channels), True


# the reference's CONV_BODY names -> constructor
BACKBONES: Dict[str, Callable] = {
    "R-50-FPN": _resnet((3, 4, 6, 3)),
    "R-101-FPN": _resnet((3, 4, 23, 3)),
    "R-50-FPN-RETINANET": _resnet((3, 4, 6, 3)),
    "R-101-FPN-RETINANET": _resnet((3, 4, 23, 3)),
    "SWINT-FPN": _swint("v1", vl=False),
    "SWINT-FPN-RETINANET": _swint("v1", vl=False),
    "SWINT-VL-FPN-RETINANET": _swint("v1", vl=True),
    "SWINT-V2-FPN-RETINANET": _swint_v2_standalone,
    "SWINT-V2-VL-FPN-RETINANET": _swint("v2", vl=True),
    "EFFICIENTNET-BIFPN": _effnet_bifpn("b0"),
    "EFFICIENTNET-B7-BIFPN": _effnet_bifpn("b7"),
    "FBNET-FPN-RETINANET": _fbnet("default"),
    "FBNET-C-FPN-RETINANET": _fbnet("fbnet_c"),
    # FIBER's detection default: fusion in the backbone
    "FUSION-SWINT-FPN-RETINANET": _fusion,
}


def build_backbone(name: str, image_size: Tuple[int, int],
                   out_channels: int = 256) -> Tuple[nn.Module, bool]:
    """Build a registered backbone on the CPU, in fp32.  Returns (module,
    language_aware)."""
    if name not in BACKBONES:
        raise KeyError(
            f"unknown backbone {name!r}; known: {sorted(BACKBONES)}")
    return BACKBONES[name](tuple(image_size), out_channels)
