"""FIBER coarse-grained model: Swin-B + RoBERTa with fusion in the backbone.

The PyTorch counterpart of `fiber_tpu/models/fiber.py::FiberCoarse`.  The
fused forward interleaves the top Swin blocks with the top RoBERTa layers;
the ITC towers run each backbone unfused.  The forward is split the way
serving caches it: `encode_image_trunk` (text-independent),
`encode_text_pre` (image-independent) and `infer_fused_tail`.  The
captioning decoder (`encode_image_caption`, `infer_caption`, and the
KV-cached `init_caption_cache` / `decode_caption_step` that
`fiber_torch/objectives/caption.py` drives) runs every text layer with a
causal mask and cross-attends to the final Swin features.

Module names are the reference checkpoint's state_dict keys, so
`state_dict()` holds exactly the reference's parameters that the model
uses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from fiber_torch.config import FiberConfig
from fiber_torch.models import heads
from fiber_torch.models.layers import (init_linear, lecun_normal_, normal_,
                                       trunc_normal_)
from fiber_torch.models.roberta import (RobertaEncoderModel,
                                        causal_attention_mask,
                                        extended_attention_mask)
from fiber_torch.models.swin import SwinTransformer

_CAPTION_LOSSES = {"caption_mle", "caption_gold", "caption_cider"}
# parameters kept in fp32 when the model is cast to its compute dtype
_FP32_PARAMS = ("relative_position_bias_table", "temp")

def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("FiberCoarse was asked for a CUDA device but CUDA "
                           "is not available; pass device='cpu' to run the "
                           "plain PyTorch path on the host")
    return dev


class FiberCoarse(nn.Module):
    """Weights are drawn from `seed` on the host with a `torch.Generator`,
    so one seed gives the same model on every device, then moved to
    `device`.  For serving they are cast to `cfg.compute_dtype`
    (relative-position-bias tables and the ITC temperature stay fp32).
    Built `for_training`, every parameter stays in `cfg.param_dtype`, the
    optimizer's master copy, and the forward runs in `cfg.compute_dtype`
    inside `self.autocast()`: the split flax's `dtype` / `param_dtype`
    gives the JAX package."""

    def __init__(self, cfg: FiberConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        dev = resolve_device(device)
        super().__init__()
        c = self.cfg = cfg
        losses = set(c.loss_names)
        self.vit_model = SwinTransformer(
            image_size=c.image_size, patch_size=c.patch_size,
            embed_dim=c.swin_embed_dim, depths=c.swin_depths,
            num_heads=c.swin_num_heads, window_size=c.window_size,
            mlp_ratio=c.swin_mlp_ratio, drop_path_rate=c.swin_drop_path_rate,
            num_fuse_block=c.num_fuse_block, text_dim=c.text_hidden_size,
            remat=c.remat)
        n_tail = c.num_fuse_block - c.swin_depths[3]
        self.text_transformer = RobertaEncoderModel(
            vocab_size=c.vocab_size, hidden_size=c.text_hidden_size,
            num_layers=c.num_text_layers, num_heads=c.num_text_heads,
            intermediate_size=c.text_intermediate_size,
            max_position_embeddings=c.max_position_embeddings,
            image_kv_dims=([c.stage_dim(2)] * n_tail
                           + [c.stage_dim(3)] * c.swin_depths[3]),
            pad_token_id=c.pad_token_id, type_vocab_size=c.type_vocab_size,
            attn_drop=c.drop_rate, hidden_drop=c.drop_rate,
            layer_norm_eps=c.layer_norm_eps)

        hs = c.hidden_size
        img_w, txt_w = c.stage_dim(len(c.swin_depths) - 1), c.text_hidden_size
        self.cross_modal_text_transform = nn.Linear(txt_w, hs)
        self.cross_modal_image_transform = nn.Linear(img_w, hs)
        self.cross_modal_text_transform_itc = nn.Linear(txt_w, hs)
        self.cross_modal_image_transform_itc = nn.Linear(img_w, hs)
        self.cross_modal_text_pooler = heads.Pooler(hs)
        self.cross_modal_image_pooler = heads.Pooler(hs)
        if c.itc_pooler:
            self.cross_modal_text_pooler_itc = heads.Pooler(hs)
            self.cross_modal_image_pooler_itc = heads.Pooler(hs)
        if losses & ({"mlm"} | _CAPTION_LOSSES):
            self.mlm_score = heads.MLMHead(hs, c.vocab_size, c.layer_norm_eps)
        if "itm" in losses:
            self.itm_score = heads.ITMHead(2 * hs)
            # starts as the ITM head's positive row at irtr finetuning
            # (init_rank_from_itm)
            self.rank_output = nn.Linear(2 * hs, 1)
        if "itc" in losses:
            self.temp = nn.Parameter(torch.tensor(float(c.itc_temp_init)))
        if "vqa" in losses:
            self.vqa_classifier = heads.MLPClassifier(2 * hs, 2 * hs,
                                                      c.vqav2_label_size)
        if "nlvr2" in losses:
            self.nlvr2_classifier = heads.MLPClassifier(4 * hs, 2 * hs, 2)
        if losses & _CAPTION_LOSSES:
            # the stage-4 features projected to the stage-3 width for the
            # fused text layers [n_pre, L - 2) when captioning
            n_pre = c.num_text_layers - c.num_fuse_block
            self.cross_modal_att_layers = nn.ModuleDict({
                str(i): nn.Linear(c.input_image_embed_size,
                                  c.input_image_embed_size // 2)
                for i in range(n_pre, c.num_text_layers - 2)})

        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        dtype = c.param_dtype if for_training else c.compute_dtype
        for name, p in self.named_parameters():
            if not name.endswith(_FP32_PARAMS):
                p.data = p.data.to(dtype)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """Draws as the JAX package does: truncated normal (std 0.02) in the
        Swin backbone, normal (std 0.02) elsewhere, zero biases, unit
        LayerNorm scales, zero fusion gates.  The patch-embed conv, which
        flax's `nn.Conv` gives its default `lecun_normal`, is a normal cut
        at two of its std and scaled so that the drawn weights have std
        1/sqrt(fan_in) (fan_in = 3 * patch * patch)."""
        for name, m in self.named_modules():
            swin = name.startswith("vit_model")
            if isinstance(m, nn.Linear):
                init_linear(m, gen, trunc=swin)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, gen)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for name, p in self.named_parameters():
            if name.endswith("relative_position_bias_table"):
                trunc_normal_(p, gen)
            elif name.endswith(("alpha_i2t", "alpha_t2i", "mlm_score.bias")):
                nn.init.zeros_(p)

    @property
    def device(self) -> torch.device:
        return self.cross_modal_text_transform.weight.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.cfg.compute_dtype

    def autocast(self) -> torch.autocast:
        """The context a forward on parameters wider than the compute
        dtype runs in (a no-op when they are the same)."""
        wide = self.cross_modal_text_transform.weight.dtype
        return torch.autocast(self.device.type, dtype=self.compute_dtype,
                              enabled=wide != self.compute_dtype)

    # ------------------------------------------------------------------
    # ITC towers (unfused single-modality encoders)
    # ------------------------------------------------------------------
    @staticmethod
    def _l2_normalize(cls: torch.Tensor) -> torch.Tensor:
        return cls / torch.linalg.norm(cls.float(), dim=-1,
                                       keepdim=True).to(cls.dtype)

    def encode_image_itc(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full unfused Swin + ITC transform + pool + normalize."""
        x = self.vit_model(img.to(self.compute_dtype))   # (B, L, C4) normed
        x = self.cross_modal_image_transform_itc(x)      # (B, L, hs)
        avg = x.mean(dim=1, keepdim=True)
        cls = (self.cross_modal_image_pooler_itc(avg) if self.cfg.itc_pooler
               else avg[:, 0])
        return {"image_feats": x, "cls_feats": self._l2_normalize(cls)}

    def encode_text_itc(self, text_ids: torch.Tensor,
                        text_masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Unfused text encoder + ITC transform + pool + normalize."""
        x = self.text_transformer(text_ids, text_masks)
        x = self.cross_modal_text_transform_itc(x)
        cls = (self.cross_modal_text_pooler_itc(x) if self.cfg.itc_pooler
               else x[:, 0])
        return {"text_feats": x, "cls_feats": self._l2_normalize(cls)}

    # ------------------------------------------------------------------
    # Fused forward: trunk (image only) + prefix (text only) + fused tail
    # ------------------------------------------------------------------
    def encode_image_trunk(self, img: torch.Tensor) -> torch.Tensor:
        """Patch embed + stages 1-2 + the unfused stage-3 blocks.
        img (B, S, S, 3) NHWC -> (B, H3, W3, C3), the input of the first
        fused block."""
        c = self.cfg
        swin = self.vit_model
        x = swin.embed(img.to(self.compute_dtype))
        for s in range(2):
            x = swin.layers[s](x)
        n_tail = c.num_fuse_block - c.swin_depths[3]
        for blk in swin.layers[2].blocks[:c.swin_depths[2] - n_tail]:
            x = blk(x)
        return x

    def encode_text_pre(self, text_ids: torch.Tensor,
                        text_masks: torch.Tensor) -> torch.Tensor:
        """Embeddings + the first (num_text_layers - num_fuse_block)
        layers -> (B, Lt, ht), the text entering the first fused block."""
        c = self.cfg
        text = self.text_transformer.embeddings(text_ids)
        ext_mask = extended_attention_mask(text_masks, c.compute_dtype)
        for layer in self.text_transformer.layers[
                :c.num_text_layers - c.num_fuse_block]:
            text = layer(text, attn_mask=ext_mask)
        return text

    def infer_fused_tail(self, trunk: torch.Tensor, text: torch.Tensor,
                         text_masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fused interleave from cached (trunk, text prefix): stage-3 fused
        tail + stage 4 + transforms and poolers."""
        c = self.cfg
        dt = c.compute_dtype
        swin, layers = self.vit_model, self.text_transformer.layers
        x = trunk
        ext_mask = extended_attention_mask(text_masks, dt)
        text_bias = ((1.0 - text_masks.float()) * -10000.0).to(dt)

        n_pre_text = c.num_text_layers - c.num_fuse_block
        n_tail = c.num_fuse_block - c.swin_depths[3]
        n_pre_block = c.swin_depths[2] - n_tail
        stage3, stage4 = swin.layers[2], swin.layers[3]
        for k, blk in enumerate(stage3.blocks[n_pre_block:]):
            B, H, W, C3 = x.shape
            img_tokens = x.reshape(B, H * W, C3)
            fused_x = blk(x, text, text_bias)
            text = layers[n_pre_text + k](text, attn_mask=ext_mask,
                                          image_feats=img_tokens)
            x = fused_x
        x = stage3.downsample(x)

        for bi, blk in enumerate(stage4.blocks):
            B, H, W, C4 = x.shape
            img_tokens = x.reshape(B, H * W, C4)
            fused_x = blk(x, text, text_bias)
            # last_norm deferred on the final text layers
            text = layers[n_pre_text + n_tail + bi](
                text, attn_mask=ext_mask, image_feats=img_tokens,
                last_norm=(bi == 0))
            x = fused_x

        B, H, W, C4 = x.shape
        image_feats = self.cross_modal_image_transform(x.reshape(B, H * W, C4))
        text_feats = self.cross_modal_text_transform(text)
        cls_text = self.cross_modal_text_pooler(text_feats)
        cls_image = self.cross_modal_image_pooler(
            image_feats.mean(dim=1, keepdim=True))
        return {"text_feats": text_feats, "image_feats": image_feats,
                "cls_feats": torch.cat([cls_text, cls_image], dim=-1)}

    def infer(self, img: torch.Tensor, text_ids: torch.Tensor,
              text_masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Interleaved fusion forward.  img (B, S, S, 3) NHWC.  Returns
        text_feats (B, Lt, hs), image_feats (B, Li, hs), cls_feats
        (B, 2 hs)."""
        trunk = self.encode_image_trunk(img)
        text = self.encode_text_pre(text_ids, text_masks)
        return self.infer_fused_tail(trunk, text, text_masks)

    # ------------------------------------------------------------------
    # Captioning decoder
    # ------------------------------------------------------------------
    def encode_image_caption(self, img: torch.Tensor) -> torch.Tensor:
        """All four Swin stages, unfused, without the final norm (as the
        reference's captioning skips it).  img (B, S, S, 3) NHWC ->
        (B, L, C4)."""
        swin = self.vit_model
        x = swin.embed(img.to(self.compute_dtype))
        for stage in swin.layers:
            x = stage(x)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)

    def _caption_image_feats(self, i: int, image_embeds: torch.Tensor
                             ) -> Optional[torch.Tensor]:
        """What text layer i cross-attends to when captioning: nothing
        below the fused layers, the projected features up to the last two,
        the features as they are in the last two."""
        c = self.cfg
        if i < c.num_text_layers - c.num_fuse_block:
            return None
        if i < c.num_text_layers - 2:
            return self.cross_modal_att_layers[str(i)](image_embeds)
        return image_embeds

    def infer_caption(self, text_ids: torch.Tensor, text_masks: torch.Tensor,
                      image_embeds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The causal text decoder over image features: every text layer
        with a causal + padding mask, the fused ones cross-attending to
        `_caption_image_feats`."""
        text = self.text_transformer.embeddings(text_ids)
        mask = causal_attention_mask(text_masks, self.compute_dtype)
        for i, layer in enumerate(self.text_transformer.layers):
            text = layer(text, attn_mask=mask,
                         image_feats=self._caption_image_feats(i, image_embeds))
        text_feats = self.cross_modal_text_transform(text)
        return {"text_feats": text_feats,
                "cls_feats": self.cross_modal_text_pooler(text_feats)}

    def init_caption_cache(self, image_embeds: torch.Tensor, max_len: int
                           ) -> List[dict]:
        """Per-layer decode state: zeroed (B, h, max_len, hd) self-attention
        caches, which `decode_caption_step` writes in place, and the image
        cross-attention K and V, projected once per decode."""
        c = self.cfg
        B, h = image_embeds.shape[0], c.num_text_heads
        shape = (B, h, max_len, c.text_hidden_size // h)
        caches = []
        for i, layer in enumerate(self.text_transformer.layers):
            feats = self._caption_image_feats(i, image_embeds)
            caches.append({
                "self_kv": tuple(torch.zeros(shape, dtype=self.compute_dtype,
                                             device=image_embeds.device)
                                 for _ in range(2)),
                "image_kv": (None if feats is None else
                             layer.crossattention_t2i.project_kv(feats))})
        return caches

    def decode_caption_step(self, token_ids: torch.Tensor, pos: int,
                            caches: List[dict]
                            ) -> Tuple[torch.Tensor, List[dict]]:
        """One decode step: token_ids (B, 1) at sequence position `pos`
        (0-based).  Returns (next-token logits (B, V), the caches)."""
        # a live prefix holds no PAD, so its position id is pos + 1 + pad
        # (create_position_ids)
        position_ids = torch.full_like(token_ids,
                                       pos + 1 + self.cfg.pad_token_id)
        x = self.text_transformer.embeddings(token_ids,
                                             position_ids=position_ids)
        new_caches = []
        for layer, cache in zip(self.text_transformer.layers, caches):
            x, kv = layer.decode_step(x, cache["self_kv"], pos,
                                      image_kv=cache["image_kv"])
            new_caches.append({"self_kv": kv, "image_kv": cache["image_kv"]})
        logits = self.mlm_score(self.cross_modal_text_transform(x))
        return logits[:, 0, :], new_caches

    # ------------------------------------------------------------------
    # Heads
    # ------------------------------------------------------------------
    def mlm_logits(self, text_feats: torch.Tensor) -> torch.Tensor:
        return self.mlm_score(text_feats)

    def itm_logits(self, cls_feats: torch.Tensor) -> torch.Tensor:
        return self.itm_score(cls_feats)

    def rank_scores(self, cls_feats: torch.Tensor) -> torch.Tensor:
        return self.rank_output(cls_feats)

    def vqa_logits(self, cls_feats: torch.Tensor) -> torch.Tensor:
        return self.vqa_classifier(cls_feats)

    def nlvr2_logits(self, cls_feats_pair: torch.Tensor) -> torch.Tensor:
        return self.nlvr2_classifier(cls_feats_pair)

    def itc_temperature(self) -> torch.Tensor:
        return self.temp.clamp(0.001, 1.0)

    def forward(self, img: torch.Tensor, text_ids: torch.Tensor,
                text_masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.infer(img, text_ids, text_masks)
        if "itm" in self.cfg.loss_names:
            out["itm"] = self.itm_logits(out["cls_feats"])
        if "mlm" in self.cfg.loss_names:
            out["mlm"] = self.mlm_logits(out["text_feats"])
        return out


@torch.no_grad()
def init_rank_from_itm(model: FiberCoarse) -> FiberCoarse:
    """Copy the ITM head's positive-class row into the rank head, so rerank
    scores begin as the ITM match logit.  In place; a no-op if either head
    is absent."""
    if hasattr(model, "itm_score") and hasattr(model, "rank_output"):
        model.rank_output.weight.copy_(model.itm_score.fc.weight[1:2])
        model.rank_output.bias.copy_(model.itm_score.fc.bias[1:2])
    return model
