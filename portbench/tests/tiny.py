"""Tiny versions of the cells' files, for runs on the host's CPU."""

from __future__ import annotations

import copy

from portbench.harness import core

TINY_MODEL = dict(
    image_size=64, patch_size=4, swin_embed_dim=16, swin_depths=[1, 1, 3, 2],
    swin_num_heads=[2, 2, 2, 2], window_size=2, input_image_embed_size=128,
    vocab_size=99, text_hidden_size=32, num_text_layers=12, num_text_heads=2,
    max_text_len=12, max_position_embeddings=64, hidden_size=32,
    input_text_embed_size=32, num_fuse_block=4, itc_queue_size=16)

TINY_DET_MODEL = dict(
    image_size=[64, 96], embed_dim=16, depths=[1, 1, 3, 2],
    num_heads=[2, 2, 2, 2], window_size=3, num_fuse_block=4, out_channels=16,
    num_dyhead_convs=2, max_query_len=16, vocab_size=99, lang_dim=32,
    num_text_heads=2, anchor_sizes=[16, 32, 64, 128, 256])

TINY_TRAFFIC = {
    "pretrain-b64": dict(batch=4, batches=4, text_len=[3, 12]),
    "rerank-i2t-16x128": dict(images=2, candidates=4, pair_batch=8,
                             trunk_batch=2, corpus_images=6, corpus_texts=20,
                             text_len=[3, 12], checked_calls=2),
    "coco80-b8": dict(batch=2, pool=4, chunk_size=3, sizes=[[48, 64], [64, 40]],
                      checked_calls=1,
                      classes={"1": "person", "2": "bicycle", "3": "traffic light",
                               "5": "airplane", "7": "train"}),
}


def tiny_files(name: str, compute_dtype: str = "float32", limits=None):
    """(cell, config, traffic, limits) of cell `name` at tiny sizes, the
    program computing in `compute_dtype` (no remat)."""
    cell, config, traffic, lim = copy.deepcopy(core.find_cell(name))
    if "postprocess" in config:
        config["model"].update(TINY_DET_MODEL)
        config["postprocess"].update(pre_nms_top_n=50, post_nms_top_n=10)
    else:
        config["model"].update(TINY_MODEL)
    config["numerics"].update(compute_dtype=compute_dtype, remat=False)
    traffic.update(TINY_TRAFFIC[cell["traffic"]])
    return cell, config, traffic, dict(lim if limits is None else limits)
