"""VLDyHead: the tower of dynamic convs and the grounding heads, in NCHW.

The PyTorch counterpart of `fiber_tpu/detection/dyhead.py` (DyReLU, DyFuse
and deformable convs; the dot-product token head).  Module names are the
reference's state_dict keys: `dyhead_tower.{i}.DyConv.{j}.conv|bn` (j: 0
the conv over the level above, 1 the level itself, 2 the stride-2 conv over
the level below), `dyhead_tower.{i}.AttnConv.1`, `dyhead_tower.{i}.relu.
fc.{0,2}`, `dyhead_tower.{i}.offset`, and the heads `cls_logits`,
`bbox_pred`, `centerness`, `dot_product_projection_text`, `log_scale`,
`bias_lang`, `bias0`, `scales.{l}.scale`.

With GLIP's early fusion (`early_fuse="mha-b"`; FIBER's own configs fuse in
the backbone) each of the `num_convs` steps runs a `VLFuse` (MHA-B), a
language layer and the DyConv.  The language layer is a BERT layer
(`RobertaLayer`, its scores clamped to +-50000 under `clamp_bertattn`) or a
`CLIPTransformerLayer` (`lang_model="clip"`); the last step has none
(`DummyLayer`) unless `use_fused_features_dot_product`.  The reference
keeps the three in one Sequential, so there the tower interleaves them:
`dyhead_tower.{3i}` the VLFuse, `{3i+1}` the language layer, `{3i+2}` the
DyConv; without early fusion the DyConvs are `dyhead_tower.{i}`.  After
the tower the text hidden states, their padded positions zeroed, are the
embedding the heads read.  The JAX package runs this fusion and these
layers deterministic, so they hold no dropout.

`VLDyHead.forward` returns the JAX package's layout: `box_cls`, `bbox_reg`
and `centerness` as (B, H, W, A k), `dot_product_logits` as (B, H W A, T).
The training heads add `token_logits` (GLIP's soft-token head, the 1x1
conv `token_logits`) and `contrastive_logits` (MDETR's alignment, the
projections `contrastive_align_projection_image` / `_text`), both (B, H W
A, T).  With `remat` each DyConv is checkpointed in training
(`torch.utils.checkpoint`; it draws no random numbers).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from fiber_torch.detection.contrastive import safe_l2_normalize
from fiber_torch.detection.deform_conv import modulated_deform_conv2d
from fiber_torch.detection.vlfuse import VLFuse
from fiber_torch.models.layers import matmul_fp32
from fiber_torch.models.roberta import RobertaLayer, extended_attention_mask

EARLY_FUSE = ("none", "mha-b")
LANG_MODELS = ("bert", "clip")


def h_sigmoid(x: torch.Tensor, h_max: float = 1.0) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) * h_max / 6.0


class DyReLU(nn.Module):
    """Dynamic ReLU-B: out = max(x a1 + b1, x a2 + b2), with (a, b)
    predicted from the global average of x (reduction 4, lambda_a 2.0)."""

    def __init__(self, channels: int, reduction: int = 4,
                 lambda_a: float = 2.0):
        super().__init__()
        self.channels, self.lambda_a = channels, lambda_a
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, 4 * channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, H, W)
        y = h_sigmoid(self.fc(x.mean(dim=(2, 3))))
        a1, b1, a2, b2 = y.split(self.channels, dim=-1)
        a1 = (a1 - 0.5) * self.lambda_a + 1.0
        a2 = (a2 - 0.5) * self.lambda_a
        b1, b2 = b1 - 0.5, b2 - 0.5
        a1, b1, a2, b2 = (t[:, :, None, None] for t in (a1, b1, a2, b2))
        return torch.maximum(x * a1 + b1, x * a2 + b2)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` that also takes a group of one value, as the JAX
    package's does (a 1x1 P7 level with a channel per group): the op
    itself, without `F.group_norm`'s check that a group holds more than one
    value."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)


class Conv3x3Norm(nn.Module):
    """A 3x3 conv (modulated-deformable when offsets are given) and a
    GroupNorm of 16 groups, eps 1e-5."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 deformable: bool = False, num_groups: int = 16):
        super().__init__()
        self.stride, self.deformable = stride, deformable
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                              padding=1)
        self.bn = GroupNorm(min(num_groups, out_channels), out_channels,
                            eps=1e-5)

    def forward(self, x: torch.Tensor, offset: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.deformable and offset is not None:
            x = modulated_deform_conv2d(x, offset, mask, self.conv.weight,
                                        self.conv.bias, stride=self.stride)
        else:
            x = self.conv(x)
        return self.bn(x)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's `F.upsample_bilinear` (align_corners=True)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def reinterpret(buf: Optional[torch.Tensor], hu: int, wu: int
                ) -> Optional[torch.Tensor]:
    """The level-l offset or mask buffer as the conv over level l + 1 reads
    it.  The reference hands the deformable kernel level l's buffer, and
    the kernel indexes it flat with level l + 1's output strides: the first
    C hu wu values of each image's NCHW buffer, not a spatial crop."""
    if buf is None:
        return None
    B, C = buf.shape[:2]
    return buf.reshape(B, -1)[:, :C * hu * wu].reshape(B, C, hu, wu)


class DyConv(nn.Module):
    """One dynamic-conv stage over all FPN levels: for level l, the conv of
    level l, the stride-2 conv of level l - 1 and the upsampled conv of
    level l + 1, weighted by a level attention (h_sigmoid of the pooled
    features through a 1x1 conv and a ReLU) and averaged, then DyReLU.
    One offset conv per level feeds all three convs of that level."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dyrelu: bool = True, use_dyfuse: bool = True,
                 use_deform: bool = True):
        super().__init__()
        self.use_dyfuse, self.use_deform = use_dyfuse, use_deform
        self.DyConv = nn.ModuleList([
            Conv3x3Norm(in_channels, out_channels, 1, use_deform),   # up
            Conv3x3Norm(in_channels, out_channels, 1, use_deform),   # same
            Conv3x3Norm(in_channels, out_channels, 2, use_deform)])  # down
        if use_dyfuse:
            # the level attention's 1x1 conv, under the reference's name
            self.AttnConv = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                          nn.Conv2d(in_channels, 1, 1))
        self.relu = DyReLU(out_channels) if use_dyrelu else nn.ReLU()
        if use_deform:
            self.offset = nn.Conv2d(in_channels, 27, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        offsets, masks = [None] * n, [None] * n
        if self.use_deform:
            for i, f in enumerate(feats):
                om = self.offset(f)                      # (B, 27, H, W)
                offsets[i] = om[:, :18]
                masks[i] = torch.sigmoid(om[:, 18:])
        conv_up, conv_same, conv_down = self.DyConv
        outs = []
        for l, feat in enumerate(feats):
            temp = [conv_same(feat, offsets[l], masks[l])]
            if l > 0:
                temp.append(conv_down(feats[l - 1], offsets[l], masks[l]))
            if l < n - 1:
                hu, wu = feats[l + 1].shape[-2:]
                up = conv_up(feats[l + 1], reinterpret(offsets[l], hu, wu),
                             reinterpret(masks[l], hu, wu))
                temp.append(resize_bilinear(up, *feat.shape[-2:]))
            stacked = torch.stack(temp)                  # (k, B, C, H, W)
            if self.use_dyfuse:
                attn = torch.stack([h_sigmoid(F.relu(self.AttnConv(t)))
                                    for t in temp])
                stacked = stacked * attn                 # attn (k, B, 1, 1, 1)
            outs.append(stacked.mean(dim=0))
        return [self.relu(o) for o in outs]


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class Scale(nn.Module):
    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value]))


class _InProjAttention(nn.Module):
    """The parameters of `nn.MultiheadAttention` under its state_dict
    names: the packed `in_proj_weight` / `in_proj_bias` and `out_proj`."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)


class CLIPTransformerLayer(nn.Module):
    """Pre-LN CLIP text layer: ln_1, self-attention with the padded keys
    masked, residual; ln_2, c_fc, QuickGELU, c_proj, residual.  The
    LayerNorms take flax's eps (1e-6), as the JAX package's do."""

    def __init__(self, width: int = 512, num_heads: int = 8):
        super().__init__()
        self.width, self.num_heads = width, num_heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = _InProjAttention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, 4 * width)
        self.mlp.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, width); mask (B, L) 1 = a real key, or attn_bias an
        additive (L, L) fp32 bias (CLIP's causal mask)."""
        B, L, _ = x.shape
        h = self.num_heads
        hd = self.width // h
        y = self.ln_1(x)
        qkv = F.linear(y, self.attn.in_proj_weight.to(y.dtype),
                       self.attn.in_proj_bias.to(y.dtype))
        q, k, v = (t.reshape(B, L, h, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        a = matmul_fp32(q, k.transpose(-1, -2)) * hd ** -0.5
        if attn_bias is not None:
            a = a + attn_bias
        if mask is not None:
            # key padding: a padded key is excluded from every query
            a = a.masked_fill(~mask.bool()[:, None, None, :], -1e9)
        a = torch.softmax(a, dim=-1).to(v.dtype)
        o = torch.matmul(a, v).transpose(1, 2).reshape(B, L, self.width)
        x = x + self.attn.out_proj(o)
        y = self.mlp.c_fc(self.ln_2(x))
        y = y * torch.sigmoid(1.702 * y)                      # QuickGELU
        return x + self.mlp.c_proj(y)


class DummyLayer(nn.Module):
    """The reference's place-holder after the last VLFuse: the identity."""

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x


class VLDyHead(nn.Module):
    """The tower of `num_convs` DyConvs (with early fusion, each behind a
    VLFuse and a language layer) and the prediction heads."""

    def __init__(self, num_convs: int = 6, in_channels: int = 256,
                 channels: int = 256, num_anchors: int = 1,
                 lang_dim: int = 768, log_scale_init: float = 0.0,
                 prior_prob: float = 0.01, use_dyrelu: bool = True,
                 use_dyfuse: bool = True, use_deform: bool = True,
                 early_fuse: str = "none", max_query_len: int = 256,
                 use_token_loss: bool = False,
                 use_contrastive_align: bool = False,
                 contrastive_hdim: int = 64, remat: bool = False,
                 num_text_heads: int = 12, lang_model: str = "bert",
                 clamp_bertattn: bool = False,
                 use_fused_features_dot_product: bool = False):
        super().__init__()
        if early_fuse not in EARLY_FUSE:
            raise ValueError(f"early_fuse must be one of {EARLY_FUSE}, got "
                             f"{early_fuse!r}")
        if lang_model not in LANG_MODELS:
            raise ValueError(f"lang_model must be one of {LANG_MODELS}, got "
                             f"{lang_model!r}")
        self.early_fuse = early_fuse
        self.channels, self.num_anchors = channels, num_anchors
        self.use_token_loss = use_token_loss
        self.use_contrastive_align = use_contrastive_align
        self.contrastive_hdim, self.remat = contrastive_hdim, remat
        # the first DyConv keeps DyReLU, DyFuse and deform only when its
        # input is as wide as the tower
        first = in_channels == channels
        tower = []
        for i in range(num_convs):
            if early_fuse == "mha-b":
                tower.append(VLFuse(v_dim=channels, l_dim=lang_dim))
                if i < num_convs - 1 or use_fused_features_dot_product:
                    tower.append(
                        CLIPTransformerLayer(lang_dim, num_text_heads)
                        if lang_model == "clip" else
                        RobertaLayer(lang_dim, num_text_heads, 4 * lang_dim,
                                     attn_drop=0.0, hidden_drop=0.0,
                                     score_clamp=(50000.0 if clamp_bertattn
                                                  else None)))
                else:
                    tower.append(DummyLayer())
            tower.append(DyConv(in_channels if i == 0 else channels,
                                channels,
                                use_dyrelu=use_dyrelu and (i > 0 or first),
                                use_dyfuse=use_dyfuse and (i > 0 or first),
                                use_deform=use_deform and (i > 0 or first)))
        self.dyhead_tower = nn.ModuleList(tower)
        self.bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)
        self.centerness = nn.Conv2d(channels, num_anchors, 1)
        self.dot_product_projection_text = nn.Linear(lang_dim,
                                                     num_anchors * channels)
        self.log_scale = nn.Parameter(torch.tensor([float(log_scale_init)]))
        self.bias_lang = nn.Parameter(torch.zeros(lang_dim))
        self.bias0 = nn.Parameter(torch.tensor([self.bias_value]))
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(5))
        if use_token_loss:
            # its bias starts at the focal prior, as cls_logits' does
            self.token_logits = nn.Conv2d(channels,
                                          num_anchors * max_query_len, 1)
        if use_contrastive_align:
            self.contrastive_align_projection_image = nn.Conv2d(
                channels, num_anchors * contrastive_hdim, 1)
            # the reference declares Linear(channels, hdim) and feeds it the
            # lang_dim-wide embedding; the input width here is lang_dim
            self.contrastive_align_projection_text = nn.Linear(
                lang_dim, contrastive_hdim)

    def _dyconv(self, dyconv: DyConv, x: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(dyconv, x, use_reentrant=False)
        return dyconv(x)

    def forward(self, feats: Sequence[torch.Tensor],
                lang_embedding: torch.Tensor,
                lang_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, List[torch.Tensor]]:
        """feats: the five FPN levels, NCHW; lang_embedding (B, T, lang_dim),
        padded positions zeroed; lang_mask (B, T) 1 = a real token, which
        early fusion reads."""
        x = list(feats)
        if self.early_fuse == "none":
            for dyconv in self.dyhead_tower:
                x = self._dyconv(dyconv, x)
        else:
            lang = {"hidden": lang_embedding, "masks": lang_mask}
            ext = (extended_attention_mask(lang_mask, lang_embedding.dtype)
                   if lang_mask is not None else None)
            steps = self.dyhead_tower
            for fuse, lang_layer, dyconv in zip(steps[0::3], steps[1::3],
                                                steps[2::3]):
                x, lang = fuse(x, lang)
                if isinstance(lang_layer, CLIPTransformerLayer):
                    lang["hidden"] = lang_layer(lang["hidden"],
                                                mask=lang_mask)
                else:
                    lang["hidden"] = lang_layer(lang["hidden"],
                                                attn_mask=ext)
                x = self._dyconv(dyconv, x)
            lang_embedding = lang["hidden"]
            if lang_mask is not None:
                lang_embedding = lang_embedding * lang_mask.to(
                    lang_embedding.dtype)[..., None]

        # the normalised text embedding, halved and projected; the token
        # bias emb . bias_lang + bias0, in fp32
        emb = lang_embedding.float()
        norm = torch.sqrt((emb * emb).sum(dim=-1, keepdim=True) + 1e-24)
        emb = emb / norm.clamp_min(1e-12)
        dtype = x[0].dtype
        proj = self.dot_product_projection_text((emb / 2.0).to(dtype))
        token_bias = emb @ self.bias_lang.float() + self.bias0.float()
        B, T = emb.shape[:2]
        A, C = self.num_anchors, self.channels
        pt = proj.reshape(B, T, A, C).permute(0, 2, 3, 1)   # (B, A, C, T)
        temperature = torch.exp(self.log_scale.float())

        out = {"box_cls": [], "bbox_reg": [], "centerness": [],
               "dot_product_logits": []}
        if self.use_token_loss:
            out["token_logits"] = []
        if self.use_contrastive_align:
            # the normalised projection of the raw text embedding
            hc = self.contrastive_hdim
            ct = safe_l2_normalize(self.contrastive_align_projection_text(
                lang_embedding.to(dtype)).float())             # (B, T, hc)
            out["contrastive_logits"] = []
        for l, f in enumerate(x):
            out["box_cls"].append(nhwc(self.cls_logits(f)))
            out["bbox_reg"].append(nhwc(self.bbox_pred(f)
                                        * self.scales[l].scale.to(dtype)))
            out["centerness"].append(nhwc(self.centerness(f)))
            H, W = f.shape[-2:]
            queries = f.flatten(2).transpose(1, 2)[:, None]  # (B, 1, HW, C)
            logit = matmul_fp32(queries, pt)                 # (B, A, HW, T)
            logit = logit / temperature
            logit = logit + token_bias[:, None, None, :]
            logit = logit.clamp(-50000.0, 50000.0)
            out["dot_product_logits"].append(
                logit.permute(0, 2, 1, 3).reshape(B, H * W * A, T))
            if self.use_token_loss:
                out["token_logits"].append(
                    nhwc(self.token_logits(f)).reshape(B, H * W * A, T))
            if self.use_contrastive_align:
                q = safe_l2_normalize(nhwc(
                    self.contrastive_align_projection_image(f)).reshape(
                        B, H * W * A, hc).float())
                cl = matmul_fp32(q, ct.transpose(1, 2)) / temperature
                out["contrastive_logits"].append(cl)
        return out
