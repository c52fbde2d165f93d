"""Fusion in the backbone for detection: Swin-B and RoBERTa interleaved,
with the stride-8/16/32 taps feeding an FPN.

The PyTorch counterpart of `fiber_tpu/detection/fusion_backbone.py::
FusionSwinFPN`, in its three versions:

* v2, the shipped forward: text layers 0-5 first; Swin stages 1-2 unfused;
  stage 3's last `num_fuse_block - depths[3]` blocks fused (i2t) and
  interleaved with text layers 6-9 (t2i); stage 4's blocks fused and
  interleaved with text layers 10-11.  Each text layer reads the image
  tokens from before the block beside it.  Stage 4 has no deferred norm,
  unlike the coarse stack;
* v1: stage 3 fuses i2t only, on its blocks from `v1_num_pre_block` on,
  and leaves the text alone (text layers 0-9 run first); stage 4's text
  layers 10-11 read the image tokens through the 1024 -> 768 projections
  `cross_modal_image_transform2/3`;
* v3: v2 with a LayerNorm on the i2t image queries (`i2t_query_norm`).

The taps are the LayerNorms `norm1..3` after stages 2-4 (no stride-4
tap).  `image_size` sets the size the blocks are built at; every block
takes any input size (its shift mask is built for the size it is given),
so that one parameter set serves every bucket of multi-scale training.
With `remat` every Swin block is checkpointed in training.  Module names are the reference's: `backbone.body.*` (the Swin body),
`backbone.fpn.*`, `language_backbone.body.model.*` (RoBERTa) and
`tunable_linear` (the zero-initialised prompt added to the text
embeddings, (1000, lang_dim)).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fiber_torch.detection.fpn import FPN
from fiber_torch.models.roberta import (RobertaEncoderModel,
                                        extended_attention_mask,
                                        make_lang_dict)
from fiber_torch.models.swin import PatchEmbed, SwinStage

FUSION_VERSIONS = ("v1", "v2", "v3")


def _holder(**modules: nn.Module) -> nn.Module:
    """A module that only names its children (the reference's nesting)."""
    m = nn.Module()
    for name, child in modules.items():
        setattr(m, name, child)
    return m


class FusionSwinFPN(nn.Module):
    def __init__(self, image_size: Tuple[int, int], patch_size: int = 4,
                 embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, drop_path_rate: float = 0.0,
                 num_fuse_block: int = 6, out_channels: int = 256,
                 vocab_size: int = 50265, lang_dim: int = 768,
                 num_text_layers: int = 12, num_text_heads: int = 12,
                 fusion_version: str = "v2", v1_num_pre_block: int = 9,
                 add_linear_layer: bool = False, remat: bool = False):
        super().__init__()
        if fusion_version not in FUSION_VERSIONS:
            raise ValueError(f"fusion_version must be one of "
                             f"{FUSION_VERSIONS}, got {fusion_version!r}")
        self.depths, self.fusion_version = tuple(depths), fusion_version
        self.v1 = fusion_version == "v1"
        self.num_text_layers = num_text_layers
        self.add_linear_layer = add_linear_layer
        H, W = image_size
        gh, gw = H // patch_size, W // patch_size
        dims = [embed_dim * 2 ** s for s in range(len(depths))]
        if self.v1:
            self.n_pre_block = v1_num_pre_block
            self.n_pre_text = 10
        else:
            n_tail = num_fuse_block - depths[3]
            self.n_pre_block = depths[2] - n_tail
            self.n_pre_text = num_text_layers - num_fuse_block
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
        stages = []
        for s, depth in enumerate(depths):
            if s < 2:
                fuse = (False,) * depth
            elif s == 2:
                fuse = tuple(i >= self.n_pre_block for i in range(depth))
            else:
                fuse = (True,) * depth
            lo = sum(depths[:s])
            stages.append(SwinStage(
                dim=dims[s], input_resolution=(-(-gh // 2 ** s),
                                               -(-gw // 2 ** s)),
                depth=depth, num_heads=num_heads[s], window_size=window_size,
                mlp_ratio=4.0, drop=0.0, attn_drop=0.0,
                drop_path=[float(d) for d in dpr[lo:lo + depth]],
                has_downsample=s < len(depths) - 1, fuse_flags=fuse,
                text_dim=lang_dim, i2t_query_norm=fusion_version == "v3",
                pad_to_window=True, remat=remat))
        body = _holder(patch_embed=PatchEmbed(patch_size, embed_dim),
                       layers=nn.ModuleList(stages))
        for s in range(1, len(depths)):
            setattr(body, f"norm{s}", nn.LayerNorm(dims[s], eps=1e-5))
        if self.v1:
            # stage 4's text layers read projected image tokens
            body.cross_modal_image_transform2 = nn.Linear(dims[3], lang_dim)
            body.cross_modal_image_transform3 = nn.Linear(dims[3], lang_dim)
        self.backbone = _holder(body=body,
                                fpn=FPN(dims[1:], out_channels))
        # the text layers that cross-attend, and the width of the image
        # tokens each reads (the last len(kv) layers)
        kv = ([lang_dim] * depths[3] if self.v1 else
              [dims[2]] * (num_fuse_block - depths[3]) + [dims[3]] * depths[3])
        text = RobertaEncoderModel(
            vocab_size=vocab_size, hidden_size=lang_dim,
            num_layers=num_text_layers, num_heads=num_text_heads,
            intermediate_size=4 * lang_dim, max_position_embeddings=514,
            image_kv_dims=kv, attn_drop=0.1, hidden_drop=0.1)
        self.language_backbone = _holder(body=_holder(model=text))
        if add_linear_layer:
            self.tunable_linear = nn.Linear(lang_dim, 1000, bias=False)

    @property
    def text(self) -> RobertaEncoderModel:
        return self.language_backbone.body.model

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """images (B, H, W, 3) padded NHWC; input_ids / attention_mask
        (B, T).  Returns (the five FPN levels, NCHW; the language dict)."""
        body, layers = self.backbone.body, self.text.layers
        x = body.patch_embed(images)
        text = self.text.embeddings(input_ids)
        if self.add_linear_layer:
            T = text.shape[1]
            text = text + self.tunable_linear.weight[None, :T].to(text.dtype)
        dt = text.dtype
        ext_mask = extended_attention_mask(attention_mask, dt)
        text_bias = ((1.0 - attention_mask.float()) * -10000.0).to(dt)
        for layer in layers[:self.n_pre_text]:
            text = layer(text, attn_mask=ext_mask)

        taps = []
        for s in range(2):
            stage = body.layers[s]
            for blk in stage.blocks:
                x = blk(x)
            if s >= 1:
                taps.append(body.norm1(x))
            x = stage.downsample(x)

        stage3 = body.layers[2]
        for bi, blk in enumerate(stage3.blocks):
            if bi < self.n_pre_block:
                x = blk(x)
            elif self.v1:
                x = blk(x, text, text_bias)
            else:
                B, H, W, C = x.shape
                img_tokens = x.reshape(B, H * W, C)
                fused_x = blk(x, text, text_bias)
                text = layers[self.n_pre_text + bi - self.n_pre_block](
                    text, attn_mask=ext_mask, image_feats=img_tokens)
                x = fused_x
        taps.append(body.norm2(x))
        x = stage3.downsample(x)

        n_text4 = self.num_text_layers - self.depths[3]
        for bi, blk in enumerate(body.layers[3].blocks):
            B, H, W, C = x.shape
            img_tokens = x.reshape(B, H * W, C)
            fused_x = blk(x, text, text_bias)
            if self.v1:
                proj = (body.cross_modal_image_transform2 if bi == 0
                        else body.cross_modal_image_transform3)
                img_tokens = proj(img_tokens)
            text = layers[n_text4 + bi](text, attn_mask=ext_mask,
                                        image_feats=img_tokens)
            x = fused_x
        taps.append(body.norm3(x))

        lang = make_lang_dict(text, attention_mask)
        feats = self.backbone.fpn([t.permute(0, 3, 1, 2) for t in taps])
        return feats, lang
