"""Fusion in the backbone for detection, Swin-B and RoBERTa interleaved,
the stride-8/16/32 taps feeding an FPN: the reference's frozen copy of the
port's `fiber_torch/detection/fusion_backbone.py::FusionSwinFPN` in
FIBER's version (v2): text layers 0-5 first; Swin stages 1-2 unfused;
stage 3's last fused blocks interleaved with text layers 6-9, stage 4's
with 10-11, each text layer reading the image tokens from before the
block beside it.  The port's module names.  Every block takes any input
size (padded to window multiples, with the shift mask of that size).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from portbench.reference.fpn import FPN
from portbench.reference.roberta import (RobertaEncoderModel,
                                         extended_attention_mask,
                                         make_lang_dict)
from portbench.reference.swin import PatchEmbed, SwinStage



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
                 num_text_layers: int = 12, num_text_heads: int = 12):
        super().__init__()
        self.depths = tuple(depths)
        self.num_text_layers = num_text_layers
        H, W = image_size
        gh, gw = H // patch_size, W // patch_size
        dims = [embed_dim * 2 ** s for s in range(len(depths))]
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
                text_dim=lang_dim, i2t_query_norm=False,
                pad_to_window=True))
        body = _holder(patch_embed=PatchEmbed(patch_size, embed_dim),
                       layers=nn.ModuleList(stages))
        for s in range(1, len(depths)):
            setattr(body, f"norm{s}", nn.LayerNorm(dims[s], eps=1e-5))
        self.backbone = _holder(body=body,
                                fpn=FPN(dims[1:], out_channels))
        # the text layers that cross-attend, and the width of the image
        # tokens each reads (the last len(kv) layers)
        kv = [dims[2]] * n_tail + [dims[3]] * depths[3]
        text = RobertaEncoderModel(
            vocab_size=vocab_size, hidden_size=lang_dim,
            num_layers=num_text_layers, num_heads=num_text_heads,
            intermediate_size=4 * lang_dim, max_position_embeddings=514,
            image_kv_dims=kv, attn_drop=0.1, hidden_drop=0.1)
        self.language_backbone = _holder(body=_holder(model=text))

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
            text = layers[n_text4 + bi](text, attn_mask=ext_mask,
                                        image_feats=img_tokens)
            x = fused_x
        taps.append(body.norm3(x))

        lang = make_lang_dict(text, attention_mask)
        feats = self.backbone.fpn([t.permute(0, 3, 1, 2) for t in taps])
        return feats, lang
