"""Operations and bytes, counted from a configuration's shapes.

Model FLOPs are the products that the forward and backward passes need
(2 M N K a product, convolutions alike), counted as PyTorch's
`FlopCounterMode` counts them; recompute under activation checkpointing is
not counted.  The kernels' operations and bytes are those of one launch
(K1: `fiber_torch/utils/profiling.py::window_attention_flops` and the byte
count of `chip_smoke.py::kernel_timing`; K2: `window_attention_bwd_flops`
and `chip_smoke.py::bwd_timing`'s bytes).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, NamedTuple, Tuple


class Block(NamedTuple):
    stage: int
    index: int          # within the stage
    C: int              # channels
    T: int              # tokens an image
    N: int              # tokens a window
    nW: int             # windows an image
    heads: int
    shifted: bool
    fused: bool


def swin_blocks(m: Mapping) -> Iterator[Block]:
    """Every Swin block of the coarse configuration `m`, in order."""
    depths, grid = m["swin_depths"], m["image_size"] // m["patch_size"]
    n_tail = m["num_fuse_block"] - depths[3]
    for s, depth in enumerate(depths):
        g = grid // 2 ** s
        w = m["window_size"]
        shift = w // 2
        if g <= w:                       # one global window, no shift
            w, shift = g, 0
        for i in range(depth):
            fused = s == 3 or (s == 2 and i >= depth - n_tail)
            yield Block(s, i, m["swin_embed_dim"] * 2 ** s, g * g, w * w,
                        (g // w) ** 2, m["swin_num_heads"][s],
                        shift > 0 and i % 2 == 1, fused)


def _swin_block_flops(b: Block, text_len: int, text_dim: int,
                      with_text: bool) -> int:
    """One block's forward products for one image: qkv, attention, proj,
    MLP (ratio 4); with text, the i2t cross-attention."""
    T, C = b.T, b.C
    f = 2 * T * C * 3 * C + 4 * T * b.N * C + 2 * T * C * C + 16 * T * C * C
    if with_text and b.fused:
        L = text_len
        f += (2 * L * text_dim * 2 * C + 2 * T * C * C + 4 * T * L * C
              + 2 * T * C * C)
    return f


def _text_layer_flops(L: int, D: int, image: Tuple[int, int] = None) -> int:
    """One RoBERTa layer's products for one text of L tokens; with
    `image` (tokens, channels) its t2i cross-attention."""
    f = 24 * L * D * D + 4 * L * L * D
    if image is not None:
        Ti, Ci = image
        f += 2 * L * D * D + 4 * Ti * Ci * D + 4 * L * Ti * D + 2 * L * D * D
    return f


def _embed_flops(m: Mapping) -> int:
    g = m["image_size"] // m["patch_size"]
    return 2 * g * g * 3 * m["patch_size"] ** 2 * m["swin_embed_dim"]


def _merge_flops(m: Mapping, s: int) -> int:
    """Patch merging after stage s: 4C -> 2C over the next stage's tokens."""
    g = m["image_size"] // m["patch_size"] // 2 ** (s + 1)
    C = m["swin_embed_dim"] * 2 ** s
    return 2 * g * g * 4 * C * 2 * C


def _n_trunk(m: Mapping) -> int:
    return m["swin_depths"][2] - (m["num_fuse_block"] - m["swin_depths"][3])


def trunk_flops(m: Mapping) -> int:
    """`encode_image_trunk` for one image: patch embed, stages 1-2, the
    unfused stage-3 blocks."""
    f = _embed_flops(m) + _merge_flops(m, 0) + _merge_flops(m, 1)
    for b in swin_blocks(m):
        if b.stage < 2 or (b.stage == 2 and b.index < _n_trunk(m)):
            f += _swin_block_flops(b, 0, 0, False)
    return f


def text_pre_flops(m: Mapping) -> int:
    """`encode_text_pre` for one text: the unfused layers."""
    L, D = m["max_text_len"], m["text_hidden_size"]
    return (m["num_text_layers"] - m["num_fuse_block"]) * _text_layer_flops(L, D)


def fused_tail_parts(m: Mapping) -> Dict[str, int]:
    """`infer_fused_tail` for one pair, by part: the fused Swin blocks,
    the fused text layers, the merge, the transforms and poolers."""
    L, D, hs = m["max_text_len"], m["text_hidden_size"], m["hidden_size"]
    blocks = [b for b in swin_blocks(m) if b.fused]
    swin = {b: _swin_block_flops(b, L, D, True) for b in blocks}
    text = [_text_layer_flops(L, D, (b.T, b.C)) for b in blocks]
    C4, T4 = blocks[-1].C, blocks[-1].T
    heads = (2 * T4 * C4 * hs + 2 * L * D * hs + 2 * 2 * hs * hs)
    return {"swin": sum(swin.values()), "text": sum(text),
            "merge": _merge_flops(m, 2), "heads": heads,
            "last_block": swin[blocks[-1]], "last_heads_image":
            2 * T4 * C4 * hs + 2 * hs * hs, "text_pool": 2 * hs * hs}


def fused_flops(m: Mapping) -> int:
    """`infer` for one pair: trunk, text prefix, fused tail."""
    p = fused_tail_parts(m)
    return (trunk_flops(m) + text_pre_flops(m) + p["swin"] + p["text"]
            + p["merge"] + p["heads"])


def rerank_call_flops(m: Mapping, n_img: int, n_txt: int,
                      n_pairs: int) -> int:
    """`rank_pairs_pipeline` over n_img images, n_txt texts and n_pairs
    pairs: trunks, text prefixes, fused tails and the rank head."""
    p = fused_tail_parts(m)
    tail = p["swin"] + p["text"] + p["merge"] + p["heads"]
    return (n_img * trunk_flops(m) + n_txt * text_pre_flops(m)
            + n_pairs * (tail + 2 * 2 * m["hidden_size"]))


def itc_tower_flops(m: Mapping) -> Tuple[int, int]:
    """(image tower, text tower) for one image and one text: the unfused
    Swin with its ITC transform and pooler; the unfused text encoder with
    its transform and pooler."""
    hs, L, D = m["hidden_size"], m["max_text_len"], m["text_hidden_size"]
    blocks = list(swin_blocks(m))
    img = (_embed_flops(m) + sum(_merge_flops(m, s) for s in range(3))
           + sum(_swin_block_flops(b, 0, 0, False) for b in blocks)
           + 2 * blocks[-1].T * blocks[-1].C * hs + 2 * hs * hs)
    txt = (m["num_text_layers"] * _text_layer_flops(L, D)
           + 2 * L * D * hs + 2 * hs * hs)
    return img, txt


def pretrain_step_flops(m: Mapping, B: int) -> int:
    """One MLM + ITC (queue) + hard-negative ITM step on B pairs, forward
    and backward (twice the forward's products where they have a
    gradient; once for the patch embedding's weight alone)."""
    L, D, hs = m["max_text_len"], m["text_hidden_size"], m["hidden_size"]
    V, Q = m["vocab_size"], m["itc_queue_size"]
    p = fused_tail_parts(m)
    embed = _embed_flops(m)
    mlm_head = 2 * L * D * D + 2 * L * D * V
    # MLM: the fused forward and the MLM head; the last Swin block, the
    # image transform and both poolers reach no loss
    mlm_fwd = B * (fused_flops(m) + mlm_head)
    mlm_dead = B * (p["last_block"] + p["last_heads_image"] + p["text_pool"])
    img, txt = itc_tower_flops(m)
    sims = 2 * 2 * B * (B + Q) * hs
    itc_fwd = B * (img + txt) + sims
    itm_fwd = 3 * B * (fused_flops(m) + 2 * 2 * hs * 2)
    fwd = mlm_fwd + itc_fwd + itm_fwd
    bwd = (2 * (mlm_fwd - mlm_dead + B * (img + txt) + itm_fwd) + sims
           - 5 * B * embed)
    return fwd + bwd


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------
class Launch(NamedTuple):
    B: int
    nW: int
    N: int
    h: int
    hd: int
    shifted: bool


def k1_flops(x: Launch) -> int:
    return 4 * x.B * x.nW * x.h * x.N * x.N * x.hd


def k2_flops(x: Launch) -> int:
    return 8 * x.B * x.nW * x.h * x.N * x.N * x.hd


def _bias_bytes(x: Launch) -> int:
    """fp32 bias, counted once where it is broadcast over the windows."""
    return (x.nW if x.shifted else 1) * x.h * x.N * x.N * 4


def k1_bytes(x: Launch, esz: int = 2) -> int:
    """qkv read, the output written, the bias read."""
    C = x.h * x.hd
    return (x.B * x.nW * x.N * 3 * C + x.B * x.nW * x.N * C) * esz + _bias_bytes(x)


def k2_bytes(x: Launch, esz: int = 2) -> int:
    """qkv and dout read, dqkv written, the bias read and dbias written."""
    C = x.h * x.hd
    return ((2 * x.B * x.nW * x.N * 3 * C + x.B * x.nW * x.N * C) * esz
            + _bias_bytes(x) + x.nW * x.h * x.N * x.N * 4)


def block_launch(b: Block, B: int) -> Launch:
    return Launch(B, b.nW, b.N, b.heads, b.C // b.heads, b.shifted)


def pretrain_step_launches(m: Mapping, B: int, remat: bool
                           ) -> Tuple[List[Launch], List[Launch]]:
    """(K1, K2) launches of one pretraining step: K1 in every block of the
    MLM (B), ITC image tower (B) and ITM (3 B) forwards, and again in each
    block's recompute under remat; K2 in every block whose output reaches
    a loss (all but the MLM forward's last)."""
    blocks = list(swin_blocks(m))
    fwd = [block_launch(b, n) for n in (B, B, 3 * B) for b in blocks]
    bwd = list(fwd)
    bwd.remove(block_launch(blocks[-1], B))
    return fwd + (bwd if remat else []), bwd


def rerank_call_launches(m: Mapping, n_img: int, trunk_batch: int,
                         n_pairs: int, pair_batch: int) -> List[Launch]:
    """K1 launches of one `rank_pairs_pipeline` call."""
    out = []
    for b in swin_blocks(m):
        if b.fused:
            out += [block_launch(b, pair_batch)] * (n_pairs // pair_batch)
        else:
            out += [block_launch(b, trunk_batch)] * (n_img // trunk_batch)
    return out


# ---------------------------------------------------------------------------
# Detection (the fusion backbone's blocks pad their maps to windows)
# ---------------------------------------------------------------------------
def det_levels(m: Mapping) -> List[Tuple[int, int]]:
    """(H, W) of the five FPN levels."""
    H, W = m["image_size"]
    return [(-(-H // s), -(-W // s)) for s in m["anchor_strides"]]


def det_swin_blocks(m: Mapping) -> Iterator[Tuple[Block, int]]:
    """Every block of the detection body with its map's unpadded tokens:
    (block with T the padded tokens, unpadded tokens)."""
    H, W = m["image_size"]
    h, w = -(-H // m["patch_size"]), -(-W // m["patch_size"])
    depths, win = m["depths"], m["window_size"]
    n_pre = depths[2] - (m["num_fuse_block"] - depths[3])
    for s, depth in enumerate(depths):
        hp, wp = -(-h // win) * win, -(-w // win) * win
        for i in range(depth):
            fused = s == 3 or (s == 2 and i >= n_pre)
            yield (Block(s, i, m["embed_dim"] * 2 ** s, hp * wp, win * win,
                         hp * wp // (win * win), m["num_heads"][s],
                         i % 2 == 1, fused), h * w)
        h, w = h // 2, w // 2


def detect_pass_flops(m: Mapping) -> int:
    """One image's forward through the detector (fusion backbone, FPN,
    DyHead, heads) and the postprocess's aggregation to C classes."""
    L, D, C0 = m["max_query_len"], m["lang_dim"], m["out_channels"]
    f = 2 * (m["image_size"][0] // m["patch_size"]) * \
        (m["image_size"][1] // m["patch_size"]) * 3 * m["patch_size"] ** 2 \
        * m["embed_dim"]
    taps = []
    for b, T in det_swin_blocks(m):
        C, Tp = b.C, b.T
        f += 2 * Tp * C * 3 * C + 4 * Tp * b.N * C + 2 * Tp * C * C \
            + 16 * T * C * C
        if b.fused:
            f += 2 * L * D * 2 * C + 4 * Tp * C * C + 4 * Tp * L * C
            f += _text_layer_flops(L, D, (T, C))
        if b.index == m["depths"][b.stage] - 1:
            if b.stage >= 1:
                taps.append((T, C))
            if b.stage < 3:                      # patch merging
                f += 2 * (T // 4) * 4 * C * 2 * C
    f += (m["num_text_layers"] - m["num_fuse_block"]) * _text_layer_flops(L, D)
    levels = [h * w for h, w in det_levels(m)]
    for (T, C), hw in zip(taps, levels):          # FPN laterals and outputs
        f += 2 * hw * C * C0 + 2 * hw * C0 * C0 * 9
    f += 2 * (levels[3] + levels[4]) * C0 * C0 * 9     # P6, P7
    conv = 2 * 9 * C0 * C0
    for _ in range(m["num_dyhead_convs"]):
        for l, hw in enumerate(levels):
            f += 2 * hw * C0 * 9 * 27 + conv * hw          # offsets, same
            temps = 1
            if l > 0:
                f += conv * hw                             # down
                temps += 1
            if l < len(levels) - 1:
                f += conv * levels[l + 1]                  # up
                temps += 1
            f += temps * 2 * C0 + 2 * (C0 * C0 // 4 + C0 // 4 * 4 * C0)
    C = m["chunk_classes"]
    f += 2 * L * D * C0
    for hw in levels:
        f += 2 * hw * C0 * 6 + 2 * hw * C0 * L + 2 * hw * L * C
    return f


def detect_pass_launches(m: Mapping, B: int) -> List[Launch]:
    """K1's launches of one pass of B images."""
    return [block_launch(b, B) for b, _ in det_swin_blocks(m)]
