"""Language-aware Swin trunks (GLIP's "swint_vl" and "swint_v2_vl").

The PyTorch counterpart of `fiber_tpu/models/swin_vl.py`.  Stages 1-3 are
plain Swin: v1 the detection-flavor `SwinBlock` (padded to window
multiples), PatchEmbed and PatchMerging; v2 `SwinV2Block`, `ConvEmbed`
and conv downsamples.  Their attention goes through
`fiber_torch.ops.window_attention.window_attention` (K1 forward and K2
backward on a CUDA tensor).  The last stage runs `SwinBlockVL`: the text
tokens join every window's attention as extra keys and values, and the
text is updated by attending every image token and itself, with learned
i2t (2, h, ntext) and t2t (h, ntext, ntext) biases.  That joint attention
has N + ntext keys and is plain PyTorch, as the JAX package writes it in
jnp; the text K / V broadcast over the windows (no copy per window).
Scores and softmaxes are fp32.

Images come in NHWC; the taps leave NCHW, after their LayerNorms `norm{i}`.
With `vl=False` the last stage is plain too and the trunk ignores text.
Module names: `patch_embed.*`, `layers.{s}.blocks.{b}.*` (a VL block adds
`norm1_text`, `norm2_text`, `mlp_text.*`, `attn.qkv_text`,
`attn.proj_text`, `attn.i2t_relative_position_bias`,
`attn.t2t_relative_position_bias`, and under v2's layer scale `gamma`,
`gamma_text`), `layers.{s}.downsample.*`, `norm{i}`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.models.layers import DropPath, Dropout, Mlp, matmul_fp32
from fiber_torch.models.roberta import make_lang_dict
from fiber_torch.models.swin import (PatchEmbed, PatchMerging, SwinBlock,
                                     _shift_mask_on, relative_position_index,
                                     window_partition, window_reverse)
from fiber_torch.models.swin_v2 import (ConvEmbed, SwinV2Block, SwinV2Stage,
                                        drop_path_rates)

NEG_INF = -1e30  # the additive mask of a padded text key


class JointWindowAttention(nn.Module):
    """W-MSA in which the text tokens join every window.

    Image rows: per window q k^T + the relative-position bias (+ the shift
    mask), and ntext more columns q k_text^T + i2t_bias[0] + the text mask;
    one softmax over the N + ntext keys; values [v, v_text].  Text rows:
    q_text over every image token of the map (+ i2t_bias[1], a scalar per
    head and text token) and over the text (+ t2t_bias + the text mask);
    one softmax; values [v_all, v_text]; then `proj_text`."""

    def __init__(self, dim: int, window: int, num_heads: int, ntext: int,
                 dim_text: int, proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.qkv_text = nn.Linear(dim_text, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.proj_text = nn.Linear(dim, dim_text)
        self.proj_drop = Dropout(proj_drop)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.i2t_relative_position_bias = nn.Parameter(
            torch.zeros(2, num_heads, ntext))
        self.t2t_relative_position_bias = nn.Parameter(
            torch.zeros(num_heads, ntext, ntext))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window).astype(np.int64)),
            persistent=False)

    def forward(self, x: torch.Tensor, shift_mask: Optional[torch.Tensor],
                text: torch.Tensor, text_mask_add: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, nW, N, C) windows; text (B, Lt, C_text); text_mask_add
        (B, Lt) fp32 additive (0 / NEG_INF) or None.  Returns the windows
        (B, nW, N, C) and the text (B, Lt, C_text)."""
        B, nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        Lt = text.shape[1]
        scale = hd ** -0.5
        qkv = self.qkv(x).reshape(B, nW, N, 3, h, hd).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]                    # (B, nW, h, N, hd)
        qkv_t = self.qkv_text(text).reshape(B, Lt, 3, h, hd).permute(
            2, 0, 3, 1, 4)
        q_t, k_t, v_t = qkv_t[0], qkv_t[1], qkv_t[2]        # (B, h, Lt, hd)

        table = self.relative_position_bias_table.float()
        rpb = table[self.relative_position_index.reshape(-1)].reshape(
            N, N, h).permute(2, 0, 1)                       # (h, N, N)
        i2t = self.i2t_relative_position_bias.float()
        t2t = self.t2t_relative_position_bias.float()

        # image rows: one softmax over the N window keys and the Lt text keys
        qs = q * scale
        a_ii = matmul_fp32(qs, k.transpose(-1, -2)) + rpb
        if shift_mask is not None:                          # (nW, N, N)
            a_ii = a_ii + shift_mask.float()[None, :, None]
        a_it = matmul_fp32(qs, k_t.transpose(-1, -2)[:, None])
        it_add = i2t[0, :, :Lt][None, None, :, None, :]     # (1, 1, h, 1, Lt)
        if text_mask_add is not None:
            it_add = it_add + text_mask_add[:, None, None, None, :]
        a = torch.softmax(torch.cat([a_ii, a_it + it_add], dim=-1), dim=-1)
        a = a.to(v.dtype)
        out = (torch.matmul(a[..., :N], v)
               + torch.matmul(a[..., N:], v_t[:, None]))
        out = out.permute(0, 1, 3, 2, 4).reshape(B, nW, N, C)
        out = self.proj_drop(self.proj(out))

        # text rows: the keys are all nW N image tokens and the text
        k_all = k.permute(0, 2, 1, 3, 4).reshape(B, h, nW * N, hd)
        v_all = v.permute(0, 2, 1, 3, 4).reshape(B, h, nW * N, hd)
        qts = q_t * scale
        a_ti = matmul_fp32(qts, k_all.transpose(-1, -2)) + i2t[1, :, :Lt,
                                                               None]
        a_tt = matmul_fp32(qts, k_t.transpose(-1, -2)) + t2t[:, :Lt, :Lt]
        if text_mask_add is not None:
            a_tt = a_tt + text_mask_add[:, None, None, :]
        a_t = torch.softmax(torch.cat([a_ti, a_tt], dim=-1), dim=-1)
        a_t = a_t.to(v.dtype)
        t_out = (torch.matmul(a_t[..., :nW * N], v_all)
                 + torch.matmul(a_t[..., nW * N:], v_t))
        t_out = t_out.transpose(1, 2).reshape(B, Lt, C)
        return out, self.proj_drop(self.proj_text(t_out))


class SwinBlockVL(nn.Module):
    """A Swin block whose (S)W-MSA is the joint image <-> text attention;
    both streams get a residual and an MLP.  The map is padded to window
    multiples and the shift is always kept (the reference rolls even a
    map of one window); the padded tokens join the joint attention as the
    reference's zero-padded ones do."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 ntext: int, dim_text: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, drop_path: float = 0.0,
                 layer_scale: bool = False):
        super().__init__()
        self.window, self.shift = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm1_text = nn.LayerNorm(dim_text, eps=1e-5)
        self.attn = JointWindowAttention(dim, window_size, num_heads, ntext,
                                         dim_text, proj_drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2_text = nn.LayerNorm(dim_text, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop_rate=drop)
        self.mlp_text = Mlp(dim_text, int(dim_text * mlp_ratio), dim_text,
                            drop_rate=drop)
        self.drop_path = DropPath(drop_path)
        if layer_scale:
            self.gamma = nn.Parameter(torch.full((dim,), 1e-4))
            self.gamma_text = nn.Parameter(torch.full((dim_text,), 1e-4))
        else:
            self.gamma = self.gamma_text = None

    @staticmethod
    def _scale(x: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        return x if g is None else x * g.to(x.dtype)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                text_mask_add: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C), text (B, Lt, C_text)."""
        H, W = x.shape[1:3]
        win, shift = self.window, self.shift
        Hp, Wp = -(-H // win) * win, -(-W // win) * win
        shortcut, shortcut_t = x, text
        x = self.norm1(x)
        t = self.norm1_text(text)
        if (Hp, Wp) != (H, W):
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = _shift_mask_on(Hp, Wp, win, shift, x.device)
        xw, t_out = self.attn(window_partition(x, win), mask, t,
                              text_mask_add)
        x = window_reverse(xw, win, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if (Hp, Wp) != (H, W):
            x = x[:, :H, :W]
        x = shortcut + self.drop_path(self._scale(x, self.gamma))
        x = x + self.drop_path(self._scale(self.mlp(self.norm2(x)),
                                           self.gamma))
        text = shortcut_t + self.drop_path(self._scale(t_out,
                                                       self.gamma_text))
        text = text + self.drop_path(self._scale(
            self.mlp_text(self.norm2_text(text)), self.gamma_text))
        return x, text


class SwinVLBackbone(nn.Module):
    """The 4-stage language-aware Swin trunk, version "v1" (PatchEmbed,
    PatchMerging) or "v2" (ConvEmbed stem and downsamples, optional layer
    scale).  forward(images, lang_hidden, lang_masks) -> (the NCHW taps of
    `out_indices`, the language dict with the updated hidden states; None
    when `vl` is False)."""

    def __init__(self, image_size: Tuple[int, int], embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, max_query_len: int = 256,
                 lang_dim: int = 768, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.2,
                 version: str = "v1", vl: bool = True,
                 layer_scale: bool = False,
                 out_indices: Sequence[int] = (1, 2, 3),
                 remat: bool = False):
        super().__init__()
        if version not in ("v1", "v2"):
            raise ValueError(f"version must be v1 or v2, got {version!r}")
        H, W = image_size
        self.vl, self.out_indices = vl, tuple(out_indices)
        self.patch_embed = (PatchEmbed(4, embed_dim) if version == "v1"
                            else ConvEmbed(3, embed_dim, 7, 4, 2))
        dpr = drop_path_rates(depths, drop_path_rate)
        n = len(depths)
        res = (-(-H // 4), -(-W // 4))
        stages = []
        for s, depth in enumerate(depths):
            dim = embed_dim * 2 ** s
            lo = sum(depths[:s])
            blocks = []
            for b in range(depth):
                shift = 0 if b % 2 == 0 else window_size // 2
                if s == n - 1 and vl:
                    blocks.append(SwinBlockVL(
                        dim, res, num_heads[s], window_size, shift,
                        ntext=max_query_len, dim_text=lang_dim,
                        mlp_ratio=mlp_ratio, drop=drop_rate,
                        drop_path=dpr[lo + b],
                        layer_scale=layer_scale and version == "v2"))
                elif version == "v1":
                    blocks.append(SwinBlock(
                        dim, res, num_heads[s], window_size, shift,
                        mlp_ratio=mlp_ratio, drop=drop_rate,
                        drop_path=dpr[lo + b], pad_to_window=True,
                        remat=remat))
                else:
                    blocks.append(SwinV2Block(
                        dim, res, num_heads[s], window_size, shift,
                        mlp_ratio=mlp_ratio, drop=drop_rate,
                        drop_path=dpr[lo + b], layer_scale=layer_scale,
                        remat=remat))
            down = None
            if s < n - 1:
                down = (PatchMerging(dim) if version == "v1"
                        else ConvEmbed(dim, 2 * dim, 3, 2, 1))
            stages.append(SwinV2Stage(blocks, down))
            res = (-(-res[0] // 2), -(-res[1] // 2))
        self.layers = nn.ModuleList(stages)
        for i in self.out_indices:
            setattr(self, f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i,
                                                   eps=1e-5))

    def forward(self, images: torch.Tensor,
                lang_hidden: Optional[torch.Tensor] = None,
                lang_masks: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], Optional[Dict]]:
        """images (B, H, W, 3); lang_hidden (B, Lt, lang_dim); lang_masks
        (B, Lt) 1 = a real token."""
        x = self.patch_embed(images)
        text = lang_hidden
        mask_add = None
        if lang_masks is not None:
            mask_add = torch.where(lang_masks.bool(), 0.0, NEG_INF).float()
        outs = []
        last = len(self.layers) - 1
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                if s == last and self.vl:
                    x, text = blk(x, text, mask_add)
                else:
                    x = blk(x)
            if s in self.out_indices:
                outs.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        if not self.vl:
            return outs, None
        return outs, make_lang_dict(text, lang_masks)
