"""GLIP-style early fusion in the detection head (VLFuse), in NCHW.

The PyTorch counterpart of `fiber_tpu/detection/vlfuse.py`, in plain
PyTorch as the JAX package writes it in jnp.  `VLFuse` fuses the five FPN
levels with the text before each DyConv of the early-fusion head, by one
of five types:

* MHA-B: `BiAttentionBlock`, one joint attention-weight matrix between all
  flattened FPN tokens and the text tokens, softmaxed both ways (a row
  softmax for image -> text with the padded text masked, a column softmax
  for text -> image), with layer-scale gammas on both residuals;
* MHA-S: `AttentionT2I`, image queries over the text, the visual stream
  only;
* SCAN: each pixel soft-attends the projected text, fused by a 1x1 conv a
  level;
* FILM: tanh gamma / beta from the aggregate text feature modulate the
  level's [features, `make_coord_features`] channels, then a 1x1 conv;
* NONE: the identity.

The scores and softmaxes are fp32; the reference's fp16 +-50000 clamps are
left out, as the JAX package leaves them out.  The JAX package runs the
head's fusion deterministic (its dropout never draws), so these modules
hold no dropout.  Module names are the reference's state_dict keys under
`b_attn` (`layer_norm_v`, `layer_norm_l`, `attn.{v,l,values_v,values_l,
out_v,out_l}_proj`, `gamma_v`, `gamma_l`) and `t2i_attn`; SCAN and FILM,
which the JAX package redesigned, keep its names (`scan.*`, `film.*`).
LayerNorms take flax's eps, 1e-6.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.models.layers import matmul_fp32

FUSE_TYPES = ("MHA-B", "MHA-S", "SCAN", "FILM", "NONE")
_MASK_NEG = -9e15
_LN_EPS = 1e-6


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) 0/1 -> (B, T) fp32 additive: 0 kept, -9e15 padded."""
    return (1.0 - mask.float()) * _MASK_NEG


class BiMultiHeadAttention(nn.Module):
    """Joint bidirectional cross attention: one q k^T between the image
    and the text tokens, a row softmax for image -> text and a column
    softmax for text -> image."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int,
                 num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.num_heads
        return x.reshape(B, -1, h, self.embed_dim // h).transpose(1, 2)

    def forward(self, v: torch.Tensor, l: torch.Tensor,
                attention_mask_l: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """v (B, Nv, v_dim), l (B, Nl, l_dim), attention_mask_l (B, Nl)
        1 = a real token.  Returns the two updates (B, Nv, v_dim) and
        (B, Nl, l_dim)."""
        B, Nv, Nl = v.shape[0], v.shape[1], l.shape[1]
        hd = self.embed_dim // self.num_heads
        q = self._heads(self.v_proj(v)) * hd ** -0.5       # (B, h, Nv, hd)
        k = self._heads(self.l_proj(l))                     # (B, h, Nl, hd)
        val_v = self._heads(self.values_v_proj(v))
        val_l = self._heads(self.values_l_proj(l))
        attn = matmul_fp32(q, k.transpose(-1, -2))          # (B, h, Nv, Nl)
        # text -> image: softmax over the image tokens
        attn_l = torch.softmax(attn.transpose(-1, -2), dim=-1)
        # image -> text: the padded text masked, softmax over the text
        if attention_mask_l is not None:
            attn = attn + _mask_bias(attention_mask_l)[:, None, None, :]
        attn_v = torch.softmax(attn, dim=-1)
        out_v = torch.matmul(attn_v.to(val_l.dtype), val_l)
        out_l = torch.matmul(attn_l.to(val_v.dtype), val_v)
        out_v = out_v.transpose(1, 2).reshape(B, Nv, self.embed_dim)
        out_l = out_l.transpose(1, 2).reshape(B, Nl, self.embed_dim)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """LayerNorms, `BiMultiHeadAttention` and layer-scale residuals."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int,
                 num_heads: int, init_gamma: float = 1.0 / 8):
        super().__init__()
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=_LN_EPS)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=_LN_EPS)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_gamma))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_gamma))

    def forward(self, v: torch.Tensor, l: torch.Tensor,
                attention_mask_l: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dv, dl = self.attn(self.layer_norm_v(v), self.layer_norm_l(l),
                           attention_mask_l)
        return (v + self.gamma_v.to(dv.dtype) * dv,
                l + self.gamma_l.to(dl.dtype) * dl)


class AttentionT2I(nn.Module):
    """Text -> image attention with a layer-scale residual: the image
    queries attend the text keys and values; only the visual stream is
    updated."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int,
                 num_heads: int, init_gamma: float = 1.0 / 8):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.layer_norm_q = nn.LayerNorm(v_dim, eps=_LN_EPS)
        self.layer_norm_k = nn.LayerNorm(l_dim, eps=_LN_EPS)
        self.q_proj = nn.Linear(v_dim, embed_dim)
        self.k_proj = nn.Linear(l_dim, embed_dim)
        self.v_proj = nn.Linear(l_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, v_dim)
        self.gamma = nn.Parameter(torch.full((v_dim,), init_gamma))

    def forward(self, v: torch.Tensor, l: torch.Tensor,
                attention_mask_l: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, Nv = v.shape[:2]
        h = self.num_heads
        hd = self.embed_dim // h
        heads = lambda x: x.reshape(B, -1, h, hd).transpose(1, 2)
        vn, ln = self.layer_norm_q(v), self.layer_norm_k(l)
        q = heads(self.q_proj(vn)) * hd ** -0.5
        k, val = heads(self.k_proj(ln)), heads(self.v_proj(ln))
        attn = matmul_fp32(q, k.transpose(-1, -2))
        if attention_mask_l is not None:
            attn = attn + _mask_bias(attention_mask_l)[:, None, None, :]
        attn = torch.softmax(attn, dim=-1).to(val.dtype)
        out = torch.matmul(attn, val).transpose(1, 2).reshape(
            B, Nv, self.embed_dim)
        out = self.out_proj(out)
        return v + self.gamma.to(out.dtype) * out


def make_coord_features(B: int, H: int, W: int,
                        device: Any = "cpu") -> torch.Tensor:
    """(B, 8, H, W) relative-position encoding, the reference's
    `_make_coord` with its swapped meshgrid axes kept (the "x" channels
    follow the rows)."""
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    xv, yv = ys.expand(H, W), xs.expand(H, W)
    xv_min, yv_min = (xv * 2 - W) / W, (yv * 2 - H) / H
    xv_max, yv_max = ((xv + 1) * 2 - W) / W, ((yv + 1) * 2 - H) / H
    feats = torch.stack([
        xv_min, yv_min, xv_max, yv_max,
        (xv_min + xv_max) / 2, (yv_min + yv_max) / 2,
        torch.full((H, W), 1.0 / H, device=device),
        torch.full((H, W), 1.0 / W, device=device)])
    return feats[None].expand(B, 8, H, W)


def _masked_mean(lang: Dict[str, Any]) -> torch.Tensor:
    """The aggregate text feature: the given one, else the masked mean."""
    agg = lang.get("aggregate")
    if agg is not None:
        return agg
    m = lang["masks"].float()[..., None]
    hidden = lang["hidden"]
    return (hidden * m.to(hidden.dtype)).sum(1) / m.sum(1).clamp_min(
        1.0).to(hidden.dtype)


class ScanFuse(nn.Module):
    """SCAN-style fusion: each pixel soft-attends the projected text
    tokens; the attended text vector joins the level's features through a
    1x1 conv and a ReLU."""

    def __init__(self, v_dim: int, l_dim: int = 768, joint_emb: int = 256,
                 joint_out: int = 256, num_levels: int = 5):
        super().__init__()
        self.joint_emb = joint_emb
        self.mapping_lang = nn.Linear(l_dim, joint_emb)
        self.query_proj = nn.ModuleList(nn.Linear(v_dim, joint_emb)
                                        for _ in range(num_levels))
        self.joint_fusion = nn.ModuleList(
            nn.Conv2d(v_dim + joint_emb, joint_out, 1)
            for _ in range(num_levels))

    def forward(self, visual: Sequence[torch.Tensor], lang: Dict[str, Any]
                ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        text = self.mapping_lang(lang["hidden"])                # (B, T, E)
        mask = lang.get("masks")
        outs = []
        for i, feat in enumerate(visual):
            B, C, H, W = feat.shape
            q = self.query_proj[i](feat.flatten(2).transpose(1, 2))
            attn = matmul_fp32(q, text.transpose(1, 2))         # (B, HW, T)
            if mask is not None:
                attn = attn + _mask_bias(mask)[:, None, :]
            attn = torch.softmax(attn, dim=-1).to(text.dtype)
            att_text = torch.matmul(attn, text)                 # (B, HW, E)
            att_text = att_text.transpose(1, 2).reshape(B, self.joint_emb,
                                                        H, W)
            joint = torch.cat([feat, att_text.to(feat.dtype)], dim=1)
            outs.append(F.relu(self.joint_fusion[i](joint)))
        return outs, lang


class FilmFuse(nn.Module):
    """FiLM conditioning: per-level tanh gamma and beta from the aggregate
    text feature modulate [features, coordinates], then a ReLU, a 1x1 conv
    and a ReLU."""

    def __init__(self, v_dim: int, l_dim: int = 768, joint_emb: int = 256,
                 joint_out: int = 256, num_levels: int = 5):
        super().__init__()
        joint = v_dim + 8
        self.mapping_lang = nn.Linear(l_dim, joint_emb)
        self.gamma = nn.ModuleList(nn.Linear(joint_emb, joint)
                                   for _ in range(num_levels))
        self.beta = nn.ModuleList(nn.Linear(joint_emb, joint)
                                  for _ in range(num_levels))
        self.joint_fusion = nn.ModuleList(nn.Conv2d(joint, joint_out, 1)
                                          for _ in range(num_levels))

    def forward(self, visual: Sequence[torch.Tensor], lang: Dict[str, Any]
                ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        agg = F.relu(self.mapping_lang(_masked_mean(lang)))     # (B, E)
        outs = []
        for i, feat in enumerate(visual):
            B, _, H, W = feat.shape
            coord = make_coord_features(B, H, W, feat.device).to(feat.dtype)
            joint = torch.cat([feat, coord], dim=1)
            g = torch.tanh(self.gamma[i](agg))[:, :, None, None]
            b = torch.tanh(self.beta[i](agg))[:, :, None, None]
            mod = F.relu(g * joint + b)
            outs.append(F.relu(self.joint_fusion[i](mod)))
        return outs, lang


class VLFuse(nn.Module):
    """Cross-modality fusion over all FPN levels, of `fuse_type` (one of
    `FUSE_TYPES`).  forward(visual, lang): visual the levels (B, v_dim, H,
    W), lang a dict with "hidden" (B, T, l_dim) and "masks" (B, T) or None;
    returns the fused levels and the language dict, its "hidden" updated by
    MHA-B."""

    def __init__(self, v_dim: int = 256, l_dim: int = 768,
                 embed_dim: int = 2048, num_heads: int = 8,
                 fuse_type: str = "MHA-B", num_levels: int = 5):
        super().__init__()
        self.kind = fuse_type.upper()
        if self.kind not in FUSE_TYPES:
            raise ValueError(f"unknown fuse_type {fuse_type!r}")
        if self.kind == "MHA-B":
            self.b_attn = BiAttentionBlock(v_dim, l_dim, embed_dim, num_heads)
        elif self.kind == "MHA-S":
            self.t2i_attn = AttentionT2I(v_dim, l_dim, embed_dim, num_heads)
        elif self.kind == "SCAN":
            self.scan = ScanFuse(v_dim, l_dim, joint_out=v_dim,
                                 num_levels=num_levels)
        elif self.kind == "FILM":
            self.film = FilmFuse(v_dim, l_dim, joint_out=v_dim,
                                 num_levels=num_levels)

    def forward(self, visual: Sequence[torch.Tensor], lang: Dict[str, Any]
                ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        if self.kind == "NONE":
            return list(visual), lang
        if self.kind == "SCAN":
            return self.scan(visual, lang)
        if self.kind == "FILM":
            return self.film(visual, lang)
        shapes = [f.shape for f in visual]
        flat = torch.cat([f.flatten(2).transpose(1, 2) for f in visual],
                         dim=1)                                 # (B, sum HW, C)
        if self.kind == "MHA-S":
            v = self.t2i_attn(flat, lang["hidden"], lang.get("masks"))
            l = lang["hidden"]
        else:
            v, l = self.b_attn(flat, lang["hidden"], lang.get("masks"))
        outs, start = [], 0
        for (B, C, H, W) in shapes:
            outs.append(v[:, start:start + H * W].transpose(1, 2).reshape(
                B, C, H, W))
            start += H * W
        return outs, dict(lang, hidden=l)
