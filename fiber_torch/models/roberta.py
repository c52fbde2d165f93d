"""RoBERTa text encoder with text-to-image (t2i) fusion hooks.

The PyTorch counterpart of `fiber_tpu/models/roberta.py`.  Module names
are the reference checkpoint's `text_transformer.*` state_dict keys
(`encoder.layer.{i}.attention.self.query`, `...attention.output.dense`,
`...attention.output.LayerNorm`, `...crossattention_t2i.self.key`, ...).

Post-LN layer with the fusion gate inserted before the attention
residual + LayerNorm:
    a   = SelfOut(SelfAttn(h))                 # dense + dropout, no norm
    a   = alpha_t2i * CrossOut(CrossAttn(a, img)) + a   (fused layers only)
    a   = LN_attn(a + h)
    out = LN_out(a + Drop(Dense(GELU(Dense(a)))))   # LN_out skipped when
                                                    # last_norm=False
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.models.layers import Dropout, matmul_fp32

NEG_INF = -1e9


def create_position_ids(input_ids: torch.Tensor, padding_idx: int
                        ) -> torch.Tensor:
    """Pad-offset position ids: cumsum(ids != pad) * (ids != pad) + pad."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def extended_attention_mask(mask: torch.Tensor,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(B, L) 0/1 -> (B, 1, 1, L) additive (0 kept / -10000 masked)."""
    return ((1.0 - mask.float()) * -10000.0).to(dtype)[:, None, None, :]


def make_lang_dict(text: torch.Tensor,
                   masks: Optional[torch.Tensor]) -> dict:
    """The language features the detection head reads: {hidden, embedded =
    hidden with the padded positions zeroed, aggregate = their masked mean,
    masks}."""
    if masks is None:
        masks = torch.ones(text.shape[:2], dtype=torch.int32,
                           device=text.device)
    mf = masks.float()[..., None]
    embedded = text * mf.to(text.dtype)
    aggregate = embedded.sum(dim=1) / mf.sum(dim=1).clamp_min(1.0).to(
        text.dtype)
    return {"hidden": text, "embedded": embedded, "aggregate": aggregate,
            "masks": masks}


def causal_attention_mask(mask: torch.Tensor,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(B, L) 0/1 -> (B, 1, L, L) additive causal + padding mask."""
    L = mask.shape[-1]
    causal = torch.triu(torch.full((L, L), NEG_INF, dtype=torch.float32,
                                   device=mask.device), diagonal=1)
    pad = (1.0 - mask.float())[:, None, None, :] * NEG_INF
    return (causal[None, None] + pad).to(dtype)


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int, type_vocab_size: int = 1,
                 pad_token_id: int = 1, layer_norm_eps: float = 1e-5,
                 drop_rate: float = 0.1):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size,
                                                  hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.dropout = Dropout(drop_rate)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = create_position_ids(input_ids, self.pad_token_id)
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids))
             + self.position_embeddings(position_ids))
        return self.dropout(self.LayerNorm(x))


class QKVProjection(nn.Module):
    """The `self` part of a BERT attention: query, key and value denses."""

    def __init__(self, hidden_size: int, kv_in_dim: Optional[int] = None):
        super().__init__()
        kv_in = hidden_size if kv_in_dim is None else kv_in_dim
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(kv_in, hidden_size)
        self.value = nn.Linear(kv_in, hidden_size)


class DenseOutput(nn.Module):
    """A dense (+ dropout) with an optional LayerNorm that its owner
    applies: `attention.output`, `intermediate`, `output` of a layer."""

    def __init__(self, in_features: int, out_features: int,
                 layer_norm_eps: Optional[float] = None,
                 drop_rate: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features)
        if layer_norm_eps is not None:
            self.LayerNorm = nn.LayerNorm(out_features, eps=layer_norm_eps)
        self.dropout = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.dense(x))


class MultiHeadAttention(nn.Module):
    """BERT-style attention: Q from x, K/V from x or an encoder memory.

    Emits context through the output dense + dropout; the residual and the
    output LayerNorm (when built) are applied by the layer."""

    def __init__(self, hidden_size: int, num_heads: int,
                 kv_in_dim: Optional[int] = None, attn_drop: float = 0.1,
                 hidden_drop: float = 0.1,
                 layer_norm_eps: Optional[float] = None,
                 score_clamp: Optional[float] = None):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        # clamps the scaled scores to +-score_clamp before the additive
        # mask (GLIP's clamped BERT attention in the early-fusion head)
        self.score_clamp = score_clamp
        self.self = QKVProjection(hidden_size, kv_in_dim)
        self.output = DenseOutput(hidden_size, hidden_size, layer_norm_eps,
                                  hidden_drop)
        self.attn_dropout = Dropout(attn_drop)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, L = x.shape[0], x.shape[1]
        h = self.num_heads
        return x.reshape(B, L, h, self.hidden_size // h).transpose(1, 2)

    def project_kv(self, src: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Head-shaped (B, h, L, hd) key/value projections of a memory."""
        return self._split(self.self.key(src)), self._split(self.self.value(src))

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Q from x over precomputed head-shaped K/V."""
        hd = self.hidden_size // self.num_heads
        q = self._split(self.self.query(x))
        B, Lq = x.shape[0], x.shape[1]
        scores = matmul_fp32(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if self.score_clamp is not None:
            scores = scores.clamp(-self.score_clamp, self.score_clamp)
        if attn_mask is not None:
            scores = scores + attn_mask.float()
        probs = self.attn_dropout(torch.softmax(scores, dim=-1).to(x.dtype))
        ctx = torch.matmul(probs, v)
        ctx = ctx.transpose(1, 2).reshape(B, Lq, self.hidden_size)
        return self.output(ctx)

    def decode_step(self, x_t: torch.Tensor,
                    kv_cache: Tuple[torch.Tensor, torch.Tensor],
                    index: int) -> Tuple[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
        """One cached self-attention step: x_t (B, 1, D), kv_cache a (k, v)
        pair of (B, h, L_max, hd) buffers, `index` the write position.
        Writes this token's k and v at `index` in place, masks the keys
        past it, and returns (out (B, 1, D), the cache)."""
        k_cache, v_cache = kv_cache
        k_t, v_t = self.project_kv(x_t)                 # (B, h, 1, hd)
        k_cache[:, :, index:index + 1] = k_t.to(k_cache.dtype)
        v_cache[:, :, index:index + 1] = v_t.to(v_cache.dtype)
        live = torch.arange(k_cache.shape[2], device=x_t.device) <= index
        mask = torch.where(live, 0.0, NEG_INF)[None, None, None, :]
        return self.attend(x_t, k_cache, v_cache, attn_mask=mask), kv_cache

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.project_kv(x if memory is None else memory)
        return self.attend(x, k, v, attn_mask=attn_mask)


class RobertaLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, fuse_t2i: bool = False,
                 image_kv_dim: Optional[int] = None, attn_drop: float = 0.1,
                 hidden_drop: float = 0.1, layer_norm_eps: float = 1e-5,
                 score_clamp: Optional[float] = None):
        super().__init__()
        self.fuse_t2i = fuse_t2i
        self.attention = MultiHeadAttention(
            hidden_size, num_heads, attn_drop=attn_drop,
            hidden_drop=hidden_drop, layer_norm_eps=layer_norm_eps,
            score_clamp=score_clamp)
        if fuse_t2i:
            if image_kv_dim is None:
                raise ValueError("a t2i-fused layer needs image_kv_dim")
            self.crossattention_t2i = MultiHeadAttention(
                hidden_size, num_heads, kv_in_dim=image_kv_dim,
                attn_drop=attn_drop, hidden_drop=hidden_drop)
            self.alpha_t2i = nn.Parameter(torch.zeros(1))
        self.intermediate = DenseOutput(hidden_size, intermediate_size)
        self.output = DenseOutput(intermediate_size, hidden_size,
                                  layer_norm_eps, hidden_drop)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                image_feats: Optional[torch.Tensor] = None,
                last_norm: bool = True) -> torch.Tensor:
        a = self.attention(x, attn_mask=attn_mask)
        if image_feats is not None:
            if not self.fuse_t2i:
                raise ValueError("layer was not built with t2i fusion")
            # image K/V are unmasked (all image tokens valid)
            c = self.crossattention_t2i(a, memory=image_feats)
            a = self.alpha_t2i.to(a.dtype) * c + a
        a = self.attention.output.LayerNorm(a + x)
        i = F.gelu(self.intermediate(a), approximate="none")
        o = self.output(i) + a
        if last_norm:
            o = self.output.LayerNorm(o)
        return o

    def decode_step(self, x_t: torch.Tensor,
                    self_cache: Tuple[torch.Tensor, torch.Tensor], index: int,
                    image_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One KV-cached decoder step: x_t (B, 1, D) the new token's hidden
        state, self_cache the layer's (k, v) buffers (written in place at
        `index`), image_kv the cross-attention's image K and V, projected
        once per decode.  Returns (out (B, 1, D), the cache)."""
        a, cache = self.attention.decode_step(x_t, self_cache, index)
        if image_kv is not None:
            c = self.crossattention_t2i.attend(a, *image_kv)
            a = self.alpha_t2i.to(a.dtype) * c + a
        a = self.attention.output.LayerNorm(a + x_t)
        i = F.gelu(self.intermediate(a), approximate="none")
        o = self.output(i) + a
        return self.output.LayerNorm(o), cache


class RobertaEncoder(nn.Module):
    """The `encoder` container: `layer.{i}`."""

    def __init__(self, layers: Sequence[RobertaLayer]):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class RobertaEncoderModel(nn.Module):
    """Embeddings + stack of layers, with stepwise access (`layers`) for the
    fusion interleave.  The last `len(image_kv_dims)` layers are t2i-fused;
    `image_kv_dims[k]` is the width of the image features that fused layer
    k reads (stage-3 width for the stage-3 tail, stage-4 for the rest)."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_heads: int, intermediate_size: int,
                 max_position_embeddings: int,
                 image_kv_dims: Sequence[int] = (),
                 pad_token_id: int = 1, type_vocab_size: int = 1,
                 attn_drop: float = 0.1, hidden_drop: float = 0.1,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.embeddings = RobertaEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size=type_vocab_size, pad_token_id=pad_token_id,
            layer_norm_eps=layer_norm_eps, drop_rate=hidden_drop)
        n_pre = num_layers - len(image_kv_dims)
        self.encoder = RobertaEncoder([
            RobertaLayer(hidden_size, num_heads, intermediate_size,
                         fuse_t2i=i >= n_pre,
                         image_kv_dim=(image_kv_dims[i - n_pre]
                                       if i >= n_pre else None),
                         attn_drop=attn_drop, hidden_drop=hidden_drop,
                         layer_norm_eps=layer_norm_eps)
            for i in range(num_layers)])

    @property
    def layers(self) -> nn.ModuleList:
        return self.encoder.layer

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """Text-only full forward (the ITC text tower)."""
        x = self.embeddings(input_ids)
        mask = extended_attention_mask(attention_mask, x.dtype)
        for layer in self.layers:
            x = layer(x, attn_mask=mask)
        return x
