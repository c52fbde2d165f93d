"""Model / task configuration for the PyTorch port of FIBER.

Field for field the same frozen dataclass as the JAX package's
`FiberConfig`, with torch dtypes.  One field is left out on purpose:
`use_pallas_attention`.  In the port the device of the tensor alone picks
the window-attention path (the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor), so there is no knob that could keep the
kernel off the card.

Two numerics fields are read in training: `param_dtype` by
`FiberCoarse(for_training=True)` (`models/fiber.py`), which keeps every
parameter in it (the fp32 master copy) and runs the forward in
`compute_dtype` under autocast; `remat` by `SwinBlock`
(`models/swin.py`), which checkpoints each block in training mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FiberConfig:
    # ---- image / Swin backbone -------------------------------------------
    image_size: int = 384
    patch_size: int = 4
    swin_embed_dim: int = 128
    swin_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin_num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    # None -> derived from the resolution: window = image_size / 32
    window_size: Optional[int] = None
    swin_mlp_ratio: float = 4.0
    swin_drop_path_rate: float = 0.1
    input_image_embed_size: int = 1024  # Swin-B final dim

    # ---- text / RoBERTa backbone -----------------------------------------
    vocab_size: int = 50265
    text_hidden_size: int = 768
    num_text_layers: int = 12
    num_text_heads: int = 12
    text_mlp_ratio: int = 4
    max_text_len: int = 40
    max_position_embeddings: int = 514  # roberta-base
    pad_token_id: int = 1
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    input_text_embed_size: int = 768

    # ---- fusion -----------------------------------------------------------
    # Top `num_fuse_block` Swin blocks (stage-3 tail + all stage-4) fuse with
    # the top `num_fuse_block` RoBERTa layers.
    num_fuse_block: int = 6

    # ---- cross-modal head dims -------------------------------------------
    hidden_size: int = 768
    vqav2_label_size: int = 3129
    itc_pooler: bool = True
    itc_queue_size: int = 4096
    itc_temp_init: float = 0.07

    # ---- regularization ---------------------------------------------------
    drop_rate: float = 0.1  # text dropout (hidden + attention probs)

    # ---- loss switches ----------------------------------------------------
    loss_names: Tuple[str, ...] = ("itm", "mlm", "itc")

    # ---- optimizer --------------------------------------------------------
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    adam_eps: float = 1e-8
    decay_power: str | float = 1  # 1 = linear (poly power 1), "cosine"
    max_steps: int = 100000
    warmup_steps: float = 10000  # int steps, or float fraction of max_steps
    end_lr: float = 0.0
    lr_mult_head: float = 5.0
    lr_mult_cross_modal: float = 5.0

    # ---- numerics ---------------------------------------------------------
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Activation checkpointing of every Swin block in training.
    remat: bool = True
    # Run the hard-negative ITM triple batch as three B-image forwards.
    itm_hardneg_chunk: bool = False

    # ------------------------------------------------------------------ api
    @property
    def derived_window_size(self) -> int:
        return self.window_size if self.window_size is not None else self.image_size // 32

    @property
    def patch_grid(self) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g, g)

    @property
    def text_intermediate_size(self) -> int:
        return self.text_hidden_size * self.text_mlp_ratio

    def stage_dim(self, stage: int) -> int:
        return self.swin_embed_dim * (2 ** stage)

    def stage_resolution(self, stage: int) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g // (2 ** stage), g // (2 ** stage))

    def replace(self, **kw) -> "FiberConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------- presets ---
    @classmethod
    def base(cls, image_size: int = 384, **kw) -> "FiberConfig":
        """FIBER-Base: Swin-B + RoBERTa-base (the released model)."""
        return cls(image_size=image_size, **kw)

    @classmethod
    def tiny_test(cls, **kw) -> "FiberConfig":
        """Miniature config for fast unit tests (CPU-friendly).

        Keeps the structural invariants (4 Swin stages, stage-3 longer than
        the fuse window, 12 text layers) at tiny widths.
        """
        defaults = dict(
            image_size=64,
            patch_size=4,
            swin_embed_dim=16,
            swin_depths=(1, 1, 3, 2),
            swin_num_heads=(2, 2, 2, 2),
            window_size=2,
            vocab_size=99,
            text_hidden_size=32,
            num_text_layers=12,
            num_text_heads=2,
            max_text_len=12,
            max_position_embeddings=64,
            hidden_size=32,
            input_image_embed_size=128,
            input_text_embed_size=32,
            num_fuse_block=4,
            itc_queue_size=16,
            vqav2_label_size=7,
            drop_rate=0.0,
            swin_drop_path_rate=0.0,
            compute_dtype=torch.float32,
            remat=False,
        )
        defaults.update(kw)
        return cls(**defaults)


# Named task presets.
def task_pretrain_mlm_itm_itc(**kw) -> FiberConfig:
    return FiberConfig.base(loss_names=("itm", "mlm", "itc"), **kw)


def task_finetune_vqa(**kw) -> FiberConfig:
    kw.setdefault("image_size", 576)
    kw.setdefault("learning_rate", 5e-6)
    kw.setdefault("lr_mult_head", 50.0)
    kw.setdefault("lr_mult_cross_modal", 5.0)
    return FiberConfig.base(loss_names=("vqa",), **kw)


def task_finetune_nlvr2(**kw) -> FiberConfig:
    kw.setdefault("learning_rate", 1e-5)
    kw.setdefault("lr_mult_head", 10.0)
    return FiberConfig.base(loss_names=("nlvr2",), **kw)


def task_finetune_irtr_itm_itc(**kw) -> FiberConfig:
    kw.setdefault("image_size", 384)
    return FiberConfig.base(loss_names=("itm", "itc"), **kw)


def task_finetune_caption_mle(**kw) -> FiberConfig:
    kw.setdefault("image_size", 576)
    kw.setdefault("max_text_len", 50)
    return FiberConfig.base(loss_names=("caption_mle",), **kw)


def task_finetune_caption_gold(**kw) -> FiberConfig:
    kw.setdefault("image_size", 576)
    kw.setdefault("max_text_len", 50)
    return FiberConfig.base(loss_names=("caption_gold",), **kw)


def task_finetune_caption_cider(**kw) -> FiberConfig:
    kw.setdefault("image_size", 576)
    kw.setdefault("max_text_len", 50)
    kw.setdefault("learning_rate", 1e-6)
    return FiberConfig.base(loss_names=("caption_cider",), **kw)


def task_finetune_irtr_itc(**kw) -> FiberConfig:
    """ITC-only retrieval finetuning."""
    kw.setdefault("image_size", 576)
    return FiberConfig.base(loss_names=("itc",), **kw)


TASK_PRESETS: Dict[str, Callable[..., FiberConfig]] = {
    "pretrain_mlm_itm_itc": task_pretrain_mlm_itm_itc,
    "finetune_vqa": task_finetune_vqa,
    "finetune_nlvr2": task_finetune_nlvr2,
    "finetune_irtr_itm_itc": task_finetune_irtr_itm_itc,
    "finetune_irtr_itc": task_finetune_irtr_itc,
    "finetune_caption_mle": task_finetune_caption_mle,
    "finetune_caption_gold": task_finetune_caption_gold,
    "finetune_caption_cider": task_finetune_caption_cider,
}
