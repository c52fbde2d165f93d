"""Swin transformer backbone with image-to-text (i2t) fusion hooks.

The PyTorch counterpart of `fiber_tpu/models/swin.py`.  Feature maps are
NHWC (B, H, W, C) at every public function, as in the JAX package; only
`PatchEmbed` goes through NCHW for its convolution.  Module names are the
reference checkpoint's `vit_model.*` state_dict keys.

The attention core of every block goes through
`fiber_torch.ops.window_attention.window_attention` (the CUDA kernels on
the card, the plain version on the CPU).  The i2t cross-attention runs over
flat tokens in plain PyTorch.  With `remat` each block is checkpointed in
training (`torch.utils.checkpoint`), as the JAX package wraps its blocks in
`nn.remat`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fiber_torch.models.layers import DropPath, Dropout, Mlp, matmul_fp32
from fiber_torch.ops.window_attention import window_attention


# --------------------------------------------------------------------------
# Static helpers
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """(N, N) int32 index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # (2, w, w)
    flat = coords.reshape(2, -1)                            # (2, N)
    rel = flat[:, :, None] - flat[:, None, :]               # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)           # (N, N, 2)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)                     # (N, N)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask for SW-MSA (0 allowed / -100 blocked)."""
    img_mask = np.zeros((H, W), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, H - window), slice(H - window, H - shift),
               slice(H - shift, H)):
        for ws in (slice(0, W - window), slice(W - window, W - shift),
                   slice(W - shift, W)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(H // window, window, W // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)  # (nW, N)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _shift_mask_on(Hp: int, Wp: int, window: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    """`shifted_window_mask` on `device`, made once for each padded map
    size: the blocks of a detection backbone fed another input size than
    they were built at share it."""
    return torch.from_numpy(shifted_window_mask(Hp, Wp, window,
                                                shift)).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // window) * (W // window), window * window, C)


def window_reverse(x: torch.Tensor, window: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B, nW, window*window, C) -> (B, H, W, C)."""
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------
class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding (conv + LayerNorm), NHWC in/out."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        p = patch_size
        self.proj = nn.Conv2d(3, embed_dim, p, stride=p)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x)  # (B, H/p, W/p, C)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias + optional i2t text cross-attention,
    on pre-partitioned windows (B, nW, N, C)."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 fuse_text: bool = False, text_dim: Optional[int] = None,
                 i2t_query_norm: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if attn_drop != 0.0:
            # the kernel has no dropout on the attention probabilities; the
            # reference's Swin configs run with attn_drop 0
            raise ValueError("window attention requires attn_drop == 0")
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.fuse_text, self.i2t_query_norm = fuse_text, i2t_query_norm
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        # stays fp32 when the rest of the model is cast to a compute dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window).astype(np.int64)),
            persistent=False)
        if fuse_text:
            if text_dim is None:
                raise ValueError("fuse_text needs text_dim")
            self.qkv_text_i2t = nn.Linear(text_dim, 2 * dim)
            # the LayerNorm on the i2t image queries: in the coarse stack and
            # detection fusion v3, absent in detection fusion v1 and v2
            if i2t_query_norm:
                self.norm_i2t_i = nn.LayerNorm(dim, eps=1e-5)
            self.qkv_i2t = nn.Linear(dim, dim)
            self.proj_i2t = nn.Linear(dim, dim)
            self.alpha_i2t = nn.Parameter(torch.zeros(1))

    def attention_bias(self, nW: int,
                       shift_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(nW, h, N, N) fp32: relative position bias (+ shift mask).  Without
        a mask the window axis is a stride-0 broadcast."""
        N, h = self.window * self.window, self.num_heads
        table = self.relative_position_bias_table.float()
        bias = table[self.relative_position_index.reshape(-1)].reshape(N, N, h)
        bias = bias.permute(2, 0, 1)[None]                    # (1, h, N, N)
        if shift_mask is not None:
            return (bias + shift_mask.float()[:, None]).contiguous()
        return bias.contiguous().expand(nW, h, N, N)

    def forward(self, x: torch.Tensor,
                shift_mask: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                text_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        scale = hd ** -0.5

        qkv = self.qkv(x)
        out = window_attention(qkv, self.attention_bias(nW, shift_mask), h)
        out = self.proj_drop(self.proj(out))

        if self.fuse_text and text is not None:
            # image-to-text cross attention over flat tokens
            Lt = text.shape[1]
            kv_t = self.qkv_text_i2t(text).reshape(B, Lt, 2, h, hd)
            k_t = kv_t[:, :, 0].transpose(1, 2)               # (B, h, Lt, hd)
            v_t = kv_t[:, :, 1].transpose(1, 2)
            q_t = self.qkv_i2t(self.norm_i2t_i(out) if self.i2t_query_norm
                               else out)
            q_t = q_t.reshape(B, nW * N, h, hd).transpose(1, 2)

            a = matmul_fp32(q_t * scale, k_t.transpose(-1, -2))
            if text_bias is not None:  # (B, Lt) additive (0 / -1e4)
                a = a + text_bias[:, None, None, :].float()
            a = torch.softmax(a, dim=-1).to(out.dtype)
            y = torch.matmul(a, v_t)                          # (B, h, L, hd)
            y = y.transpose(1, 2).reshape(B, nW, N, C)
            y = self.proj_drop(self.proj_i2t(y))
            out = out + self.alpha_i2t.to(out.dtype) * y
        return out


class SwinBlock(nn.Module):
    """One Swin block: (S)W-MSA (+ optional i2t fusion) + MLP, NHWC.

    With `remat`, in training with grad enabled, the block keeps only its
    inputs and recomputes the rest in the backward.  Its dropout and
    drop-path masks come from `generator`, whose state the block saves
    before the forward and restores for the recompute (and then puts
    back), so that the recompute draws the masks of the forward:
    `checkpoint` restores only PyTorch's default generators.

    A detection-flavor block (`pad_to_window`) takes any input size: it
    pads the map it is given to window multiples, with the shift mask of
    that size (the one built with the block at `input_resolution`, another
    from a cache shared by the blocks)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 fuse_text: bool = False, text_dim: Optional[int] = None,
                 i2t_query_norm: bool = True, pad_to_window: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat, self.pad_to_window = remat, pad_to_window
        self.generator: Optional[torch.Generator] = None
        H, W = input_resolution
        window, shift = window_size, shift_size
        # Coarse flavor: a window larger than the map becomes one global
        # window with no shift.  The detection flavor (pad_to_window) never
        # clamps: it pads the map to window multiples and keeps the shift.
        if not pad_to_window and min(H, W) <= window:
            window, shift = min(H, W), 0
        self.dim, self.input_resolution = dim, (H, W)
        self.window, self.shift = window, shift

        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads,
                                    fuse_text=fuse_text, text_dim=text_dim,
                                    i2t_query_norm=i2t_query_norm,
                                    attn_drop=attn_drop, proj_drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop_rate=drop)
        self.drop_path = DropPath(drop_path)
        self.Hp = -(-H // window) * window
        self.Wp = -(-W // window) * window
        mask = (torch.from_numpy(shifted_window_mask(self.Hp, self.Wp,
                                                     window, shift))
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, text: Optional[torch.Tensor] = None,
                text_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return self._checkpointed(x, text, text_bias)
        return self._forward(x, text, text_bias)

    def _checkpointed(self, x, text, text_bias) -> torch.Tensor:
        gen = self.generator
        state = gen.get_state() if gen is not None else None
        calls = [0]

        def run(*args):
            calls[0] += 1
            if state is None or calls[0] == 1:
                return self._forward(*args)
            now = gen.get_state()            # the recompute replays the
            gen.set_state(state)             # forward's draws, then hands
            try:                             # the generator back as it was
                return self._forward(*args)
            finally:
                gen.set_state(now)

        return checkpoint(run, x, text, text_bias, use_reentrant=False)

    def _geometry(self, x: torch.Tensor):
        """(H, W, Hp, Wp, shift mask) of the input `x`."""
        if not self.pad_to_window:
            return (*self.input_resolution, self.Hp, self.Wp, self.attn_mask)
        H, W = x.shape[1:3]
        Hp = -(-H // self.window) * self.window
        Wp = -(-W // self.window) * self.window
        mask = self.attn_mask
        if self.shift > 0 and (Hp, Wp) != (self.Hp, self.Wp):
            mask = _shift_mask_on(Hp, Wp, self.window, self.shift, x.device)
        return H, W, Hp, Wp, mask

    def _forward(self, x: torch.Tensor, text: Optional[torch.Tensor],
                 text_bias: Optional[torch.Tensor]) -> torch.Tensor:
        H, W, Hp, Wp, mask = self._geometry(x)
        shortcut = x
        x = self.norm1(x)
        # pad to window multiples (detection flavor; a no-op when the
        # resolution already divides the window)
        if (Hp, Wp) != (H, W):
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        if self.shift > 0:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))

        xw = window_partition(x, self.window)                 # (B, nW, N, C)
        xw = self.attn(xw, shift_mask=mask, text=text,
                       text_bias=text_bias)
        x = window_reverse(xw, self.window, Hp, Wp)

        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        if (Hp, Wp) != (H, W):
            x = x[:, :H, :W]

        x = shortcut + self.drop_path(self._scale(x))
        return x + self.drop_path(self._scale(self.mlp(self.norm2(x))))

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        """The residual branch's layer scale: none here (Swin-v2 blocks
        scale by a learned gamma)."""
        return x


class PatchMerging(nn.Module):
    """2x2 patch merging: concat 4 neighbours -> LN -> linear 4C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        # order [(0,0), (1,0), (0,1), (1,1)], as the reference concatenates
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        x = x.permute(0, 1, 3, 4, 2, 5).reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """One stage: a list of blocks + optional downsample."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop: float, attn_drop: float,
                 drop_path: Sequence[float], has_downsample: bool,
                 fuse_flags: Sequence[bool] = (),
                 text_dim: Optional[int] = None, i2t_query_norm: bool = True,
                 pad_to_window: bool = False, remat: bool = False):
        super().__init__()
        fuse = tuple(fuse_flags) or (False,) * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      shift_size=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, drop=drop, attn_drop=attn_drop,
                      drop_path=drop_path[i], fuse_text=fuse[i],
                      text_dim=text_dim, i2t_query_norm=i2t_query_norm,
                      pad_to_window=pad_to_window, remat=remat)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if has_downsample else None

    def forward(self, x, text=None, text_bias=None):
        for blk in self.blocks:
            x = blk(x, text, text_bias)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class SwinTransformer(nn.Module):
    """Swin backbone (coarse-grained flavor: fixed square input resolution).

    Stage-3 blocks of the fused tail (the last num_fuse_block - depths[3])
    and all stage-4 blocks carry i2t fusion parameters, reading text of
    width `text_dim`."""

    def __init__(self, image_size: int, patch_size: int = 4,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: Optional[int] = None, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, num_fuse_block: int = 6,
                 text_dim: int = 768, remat: bool = False):
        super().__init__()
        window = window_size if window_size is not None else image_size // 32
        grid = image_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_drop = Dropout(drop_rate)
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
        stages = []
        for s, depth in enumerate(depths):
            if s < 2:
                fuse = (False,) * depth
            elif s == 2:
                n_tail = num_fuse_block - depths[3]
                fuse = tuple(i >= depth - n_tail for i in range(depth))
            else:
                fuse = (True,) * depth
            lo = sum(depths[:s])
            stages.append(SwinStage(
                dim=embed_dim * (2 ** s),
                input_resolution=(grid // (2 ** s), grid // (2 ** s)),
                depth=depth, num_heads=num_heads[s], window_size=window,
                mlp_ratio=mlp_ratio, drop=drop_rate, attn_drop=attn_drop_rate,
                drop_path=[float(d) for d in dpr[lo:lo + depth]],
                has_downsample=(s < len(depths) - 1), fuse_flags=fuse,
                text_dim=text_dim, remat=remat))
        self.layers = nn.ModuleList(stages)
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(num_features, eps=1e-5)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """img NHWC (B, S, S, 3) -> (B, G, G, C) patch tokens."""
        return self.pos_drop(self.patch_embed(img))

    def forward(self, img: torch.Tensor, text=None, text_bias=None
                ) -> torch.Tensor:
        """Full forward; returns final (B, L, num_features) after norm."""
        x = self.embed(img)
        for stage in self.layers:
            x = stage(x, text, text_bias)
        B, H, W, C = x.shape
        return self.norm(x.reshape(B, H * W, C))
