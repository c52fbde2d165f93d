"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from `fiber_torch/csrc/`, one
   nvcc per source, all started together;
3. K1 (window attention forward) against its plain PyTorch version on the
   card at every FIBER-Base 384^2 stage shape at B = 2, 16 and the train
   step's 24, fp32 (TF32 off) and bf16, with kernel, plain and library
   (SDPA) times (`cuda_time_ms`: device time, the calls queued behind a
   spin kernel), the card's bound and TFLOP/s; each row names K1's route
   (bf16 on the tensor cores, fp32 on the register-tiled CUDA-core route
   `f32_tiled`) and its batch splits; then K1 at the four detection
   stages' shapes (800x1344: 17 x
   28, 9 x 14, 5 x 7 and 3 x 4 windows after padding, shifted, B = 2;
   `k1_check_detection`); then K1 at the four FIBER-Base 576^2 stages
   (18 x 18 windows, N = 324) at B = 4 (`k1_check_long`: bf16 on the
   long-window tensor-core route, with its rows a block, warps a slab and
   splits, within one ulp of each row's max-abs plus the move of one
   probability rounded the other way at a tie (`within_ulp_or_flip`) and
   at least 99.9% of the outputs bit-equal; fp32 on `f32_tiled` within
   K1_LONG_FP32_ATOL), and bf16 stages 1 and 3 timed at each (rows a
   block, warps a slab) that fits against `_long_rows`' choice, and at one
   split against the batch (`k1_long_rows`); then the same checks untimed
   on the draws they took before the detection stages shared the
   generator (`k1_check_long_old_draws`);
4. K2 (its backward) likewise, at batch 2 and at the train step's largest
   batch (the 3B images of the hard-negative ITM forward), the library
   yardstick being SDPA's backward with the bias as a mask that needs grad;
   each row names K2's route (bf16 on the tensor cores, fp32 on `tc_f32`)
   and its batch splits, and holds two calls to the same bits;
   then K2 at B = 24 timed at each batch split S = 1, 2, 4, 8, against
   which the split `_bwd_splits` chooses is read; then K2 at the four
   576^2 stages (N = 324) at the VQA step's B = 8 in both dtypes
   (`k2_check_long`: bf16 on the long-window tensor-core route within one
   ulp of each row's max-abs plus the move of one dS or P rounded the
   other way at a midpoint (`within_ulp_or_flip_bwd`), dbias within
   K2_LONG_DBIAS_RTOL of its max-abs; fp32 on `tc_f32` within
   K2_LONG_FP32_ATOL), with its plan,
   two calls bit-equal, and kernel,
   plain and SDPA-backward times, the bf16 row and column kernels also
   timed apart with their TFLOP/s as run; and bf16 stages 1 and 3 with
   each kernel timed apart at each (parts, stages) of the row kernel and
   (Rc, stages) of the column kernel that fits, against the plan's
   (`k2_long_rows`);
5. the serving path: FIBER-Base 384^2 bf16 ITM rerank (`itm_rerank_matrix`
   -> `rank_pairs_pipeline`) on seeded weights with non-zero fusion gates,
   4 images x 8 texts; the launch count shows K1 ran in every Swin block,
   every launch on the tensor-core route, and the cached scores are held
   against the full-forward oracle;
6. the forward kernel inside the model: full width in fp32, kernel path on
   the card against the plain path on the host;
7. the training path: `CoarseTrainer` on FIBER-Base 384^2 (full width and
   depth, bf16 compute, fp32 parameters, the 4096-slot queue, remat as the
   config sets it), MLM + ITC + hard-negative ITM, B = 8, `STEPS` steps on
   one batch; losses, step time, peak memory and the K1 / K2 launches of
   every step, held to the counts the model implies (every K1 and K2
   launch on the tensor-core route); then one step under the profiler
   (K1's and K2's device time and share, the kernel time and the
   device's busy share);
8. the backward kernel inside the model: full width in fp32, gradients of
   MLM + ITM on fixed negatives on the card (K1 + K2) against the host's
   plain path;
9. K3 (a run of Swin blocks in one launch) against its plain version at
   every FIBER-Base 384^2 stage run (2, 2, 14 and 2 blocks), B = 4 and 16,
   fp32 and bf16, with kernel, plain and per-block-path times, the card's
   bound and TFLOP/s; each row names K3's route (bf16 on the tensor cores,
   fp32 on them as split-TF32 products, `tc_f32`, with its registers, two
   calls bit-equal and, timed, each phase's device ms), its grid and its
   tile plan (each product's tile, the attention's batch splits); then
   bf16 K3 at stage 3 (B = 4 and 16) and stage 4 (B = 4) timed under the
   plan and with each tile forced on every product, the check on
   `_k3_tile`'s model; then K3 at hd = 128 (the CUDA-core route, which no
   model runs) in both dtypes (`k3_check_hd128`);
10. K3 on the model: the rerank's 4 images through the trunk composed from
   the model's own modules with one K3 launch per stage run, against
   `encode_image_trunk` (per block, K1), the rerank scores of both through
   the fused tail, and both trunks' wall and device time; then the ITC
   image tower (all four stages, 4 launches) against `vit_model`; fp32 and
   bf16, every launch on K3's route for the dtype (`tc_f32`, `tc`);
11. K4 (per-head window attention) against its plain version at every
   stage shape at B = 2 and 16 and at profile_tail's batch, fp32 and
   bf16, with kernel, plain and SDPA times, route and splits;
12. `fiber_torch.tools.profile_tail` at batch 64: the rerank tail's
   per-component device times, K4 among them (every bf16 K1 and K4
   launch on the tensor-core route), and K4's output on the profile's
   own operands against the plain version;
13. captioning, FIBER-Base at 576^2 (`task_finetune_caption_mle`): bf16
   `caption_images` of 4 images, beam 5, max_len 20, its token ids, wall
   time and device busy share, and K1's 24 launches per encode on the
   long-window route; in fp32 the cached greedy tokens against the
   full-prefix oracle's on the card, and the first decode step's logits
   on the card against the host's plain path at B = 1;
14. the VQA preset's fused forward at 576^2 once in bf16: finite logits,
   every K1 launch on the long-window route;
15. VQA finetuning at 576^2 (`task_finetune_vqa`, full width and depth,
   bf16 autocast over fp32 parameters, remat as the preset sets it):
   VQA_STEPS `CoarseTrainer.train_step`s at micro-batch VQA_B on one
   seeded batch, each with its step time, peak memory and K1 / K2
   launches by route (K2 in all 24 blocks on the long-window route, K1
   again in each recompute), a falling VQA loss, finite non-zero
   gradients, then one step under the profiler (`vqa_576_train`); and in
   fp32 at B = 1 the VQA loss's gradients on the card (K1 on `f32_tiled`,
   K2 on `tc_f32`) against the host's plain path (`fp32_grad_576`);
17. K3 and K4 at FIBER's 576^2 windows (N = 324; bf16 K3 on the tensor
   cores with K1's long-window attention routine at K3's rounding, fp32 K3
   on `tc_f32` with the fp32 forward's 11-chunk routine, bf16 K4 on K1's
   long-window tensor-core routine) against their plain versions in fp32
   and bf16: K3 over two stage-3 blocks (the second shifted) and one
   stage-4 block at B = K3_LONG_B, with the per-block path's time, in bf16
   its plan (tiles, rows, parts, splits), one block an SM and two calls
   bit-equal, in fp32 its plan, two calls bit-equal and the registers,
   local bytes and blocks an SM the card reports, the grid held to them
   (`k3_check_long`); bf16 K3 at stage 3
   against its twin in 12 x 12 windows (the same GEMM phases) and the
   per-block path's cuBLAS products and K1 (`k3_long_breakdown`); the
   576^2 ITC image tower through one K3 launch per stage against the
   per-block tower, every K3 launch on `tc_long`, each stage's K3 timed
   beside its blocks (`k3_itc_tower_576`);
   K4 at stages 1 and 3 at B = K4_LONG_B with SDPA's time, its plan
   (rows, parts, splits), bf16 within one ulp or a flip
   (`within_ulp_or_flip`) and two calls bit-equal (`k4_check_long`); K1
   and K4 bit-equal on the same inputs (`k1_k4_long_identity`);
   `profile_tail` on the 576^2 preset, every K4 launch on `tc_long`
   (`profile_tail_576`);
18. caption-MLE finetuning at 576^2 (`task_finetune_caption_mle`, full
   width and depth, max_text_len 50, bf16 over fp32 parameters, remat):
   CAPTION_STEPS `CoarseTrainer.train_step`s at CAPTION_TRAIN_B on one
   seeded batch, each with its K1 / K2 launches by route (all on the
   long-window route), a falling caption-MLE loss; a `CheckpointManager`
   save after CKPT_AFTER steps, restored into a fresh trainer, whose next
   step gives the same losses bit for bit (`caption_checkpoint`); one
   profiled step (`caption_mle_576_train`, `caption_mle_576_profile`);
19. GOLD_STEPS `compute_caption_gold` steps at 576^2, the gold copy a
   frozen `FiberCoarse` copied from the student and refreshed once, each
   step's backward and the trainer's AdamW update (`caption_gold_576`);
20. one SCST step (`compute_caption_cider`, SCST_B images x SCST_SAMPLES
   samples of SCST_MAX_LEN tokens, rewards from the port's CiderD on
   seeded references), its backward and update (`scst_576`);
21. fp32 caption-MLE gradients at B = 1, card against host
   (`fp32_grad_caption_576`);
23. the on-device preprocessing (`fiber_torch/data/device_transforms.py`)
   on PP_B seeded numpy images of mixed sizes staged by `stage_host_batch`
   (no PIL) at 384^2 from 576 and 576^2 from 864: the eval and the
   training pipeline (draws made once on the card) card against host in
   fp32 within PP_ATOL_255 on the 0-255 scale, and each one's device time
   for a batch in bf16 (`device_preprocess`);
24. the training CLI as a user runs it, `fiber_torch.cli.main` on
   `pretrain_mlm_itm_itc` at FIBER-Base 384^2 (synthetic data, B = CLI_B):
   CLI_STEPS steps saving a checkpoint every CLI_CKPT_EVERY, the last one
   profiled, then `--resume` to CLI_RESUME_STEPS, which starts at step
   CLI_STEPS; every step's losses, seconds and 143 K1 / 71 K2 launches on
   `tc`, the save and restore seconds, the peak memory (`cli_pretrain`,
   `cli_pretrain_resume`, `cli_pretrain_checkpoints`);
25. two train steps on images staged on the host and finished on the card
   by the CLI's `finish_batch`, with the preprocessing's share of the step
   and one profiled step (`cli_staged_step`);
26. CLI_IRTR_STEPS CLI steps of `finetune_irtr_itm_itc` at 384^2 (96 K1 /
   48 K2 on `tc`) and of `finetune_irtr_itc` at 576^2 with its 4096-slot
   queue (48 K1 / 24 K2 on `tc_long`) (`cli_irtr_384`, `cli_irtr_576`);
27. NLVR2_STEPS `CoarseTrainer.train_step`s of `task_finetune_nlvr2` at
   384^2 on two-image batches, 96 K1 / 48 K2 on `tc` (`nlvr2_train`);
28. zero-shot grounding detection, FIBER-B at full width and depth
   (`GroundingDetector`: Swin-B, RoBERTa-base, fusion v2, FPN 256, 6
   DyConvs with deform) at 800x1344 in bf16, B = DET_B, seeded weights,
   two seeded images of other sizes staged on the host into the bucket, a
   five-class prompt: `detection_inference` with its 24 K1 launches on
   `tc` and 78 of the deformable sampling kernel (`deform_im2col`), no
   host-to-device copy or synchronisation launched inside `det.head`,
   wall ms, peak memory, a profiled call, every head output finite
   (`det_infer_800`); the sampling kernel at the five levels' 13 convs,
   B = 8, bit-equal to its plain twin, its ms beside the bound and the
   plain twin's (`det_infer_800_deform`);
29. the chunked evaluation: `evaluate_detection` on that model (8 images,
   10 classes in chunks of 5, s per image) (`det_eval`); 29b, `python -m
   fiber_torch.tools.eval_det` as a user runs it, runs with phases 35 and
   37 (`det_eval_tool`);
30. `GroundingDemo` on one image staged without PIL and a free caption
   (`det_demo`);
31. the detector in fp32 at 320x480, B = 1: every head output at every
   level on the card against the host's plain path, within DET_RTOL of
   each tensor's max-abs (`det_fp32_card_vs_host`);
32. K2 at the four detection stages of 800x1344 (17 x 28, 9 x 14, 5 x 7
   and 3 x 4 windows of 12 x 12 after padding, B = 2) against its plain
   version: bf16 on the tensor cores shifted at every stage and unshifted
   at stage 1, fp32 on `tc_f32` at stage 1, within the `k2_check`
   bounds, two calls bit-equal, with kernel, plain and SDPA-backward
   times, the bound and the batch split (`k2_check_detection`; a
   generator of its own);
33. detection training, FIBER-B at full width and depth (deform on), bf16
   autocast over fp32 parameters, `DetectionTrainer` (clip 1, EMA 0.999,
   no warmup) at 800x1344, B = DET_B: DET_TRAIN_STEPS steps on one seeded
   synthetic batch, each with its wall ms, peak memory and K1 / K2
   launches (24 and 24, all on `tc`; 78 of the sampling kernel), a
   falling total loss, a profiled step; then one step with remat on (48
   K1, 24 K2, 156 sampling launches, a lower peak)
   (`det_train_800`, `det_train_profile`, `det_train_remat`);
34. the detection loss's gradients in fp32 at DET_GRAD_SIZE, B = 1, full
   width and deform on: every parameter's gradient on
   the card (its convs without cuDNN) against the host's plain path
   within GRAD_RTOL of its max-abs, or twice the host's own spread (on
   one thread, and on weights moved by one rounding) where the gradient
   is so ill-conditioned that is larger; every loss within
   DET_LOSS_RTOL; the cuDNN run's errors beside
   (`det_grads_card_vs_host`; it runs while phase 35's subprocesses run);
35. `python -m fiber_torch.tools.train_det` at 800x1344 and `python -m
   fiber_torch.tools.finetune_det --tuning language_prompt_v2` at its
   default size, DET_CLI_STEPS steps each, in subprocesses: exit 0, finite
   losses, the frozen parameters moved by no more than the weight decay
   (`det_train_cli`); after phase 36, with 29b and 37, five processes
   started at once on the card (`subprocess_round`);
36. `MultiScaleDetectionTrainer` alternating the landscape and portrait
   buckets (DET_MULTISCALE), two steps each on one parameter set, 24 K1
   and 24 K2 launches a step (`det_multiscale`);
37. data parallel across processes (`fiber_torch/parallel/`), each rank
   this script again (`--ddp-worker`): `python -m fiber_torch.cli` on
   `pretrain_mlm_itm_itc` at 384^2, B = CLI_B, DDP_STEPS steps under an
   NCCL process group of one rank and with none, each in a subprocess
   (with 29b and 35):
   every step's losses and the parameters after the run bit-equal, 143 K1
   and 71 K2 a step on `tc`, step and all-reduce ms (`ddp_world1_pretrain`);
38. two ranks of `CoarseTrainer` with gloo on the one card (gloo's
   collectives take CUDA tensors through the host: a check, not a speed),
   FIBER-Base 384^2: one fp32 step (TF32 off, no dropout, EMA, fixed
   negatives) of two rows a rank against one process's step on the four
   rows, losses within DDP_LOSS_RTOL and each summed gradient within
   GRAD_RTOL of its tensor's max-abs; the ranks' parameters, EMA, feature
   rings, `ptr` and `total` bit-equal, each rank holding half the queue's
   input rings (its bytes reported) and its block bit-equal to the same
   slots of the one process's queue; DDP_STEPS bf16 steps of DDP_BF16_B
   rows a rank, 143 K1 and 71 K2 a rank a step on `tc`, a falling MLM
   loss (`ddp_2rank_pretrain`);
39. two ranks of `DetectionTrainer` with gloo, FIBER-B at 800x1344, bf16,
   one image a rank (1 and 8 boxes): the global ATSS positives equal one
   process's, parameters and EMA bit-equal across the ranks, 24 K1 and 24
   K2 a rank on `tc`; fp32 gradients at DET_GRAD_SIZE against one
   process's within GRAD_RTOL of each tensor's max-abs or twice its own
   spread (`ddp_2rank_det`);
40. `eval_det`'s loop at 800x1344, one image a pass, DDP_EVAL_IMAGES images
   split over two ranks and merged: bit-equal to one process's
   predictions (`ddp_2rank_eval_det`); phases 38-40 run in one pair of
   ranks (`ddp_2rank`), and phase 45 in this process while they run;
56. in the same two ranks, tensor parallelism (`fiber_torch/parallel/
   tp.py`) on a (data 1, model 2) mesh: phase 38's fp32 step on all four
   rows against phase 38's one-process step (losses within DDP_LOSS_RTOL,
   every gathered gradient within GRAD_RTOL of its tensor's max-abs), the
   replicated parameters, EMA and queue bit-equal across the model ranks;
   each rank's parameter, gradient and AdamW elements as `tp_sharding`
   reckons them; TP_STEPS bf16 steps of DDP_BF16_B rows, finite losses,
   143 K1 and 71 K2 a rank a step on `tc`, step ms and the model group's
   all-gathers and bytes a step (`tp_2rank_pretrain`);
41. K1 at the backbone registry's Swin-T shapes at 800x1344 (window 7, N =
   49: 29 x 48, 15 x 24, 8 x 12 and 4 x 6 windows after padding, heads 3,
   6, 12, 24, shifted, B = DET_B), fp32 and bf16, against its plain
   version (bf16 within one ulp or one flipped probability), with kernel,
   plain, SDPA and bound ms (`k1_check_swint`; a generator of its own);
42. K2 there likewise, within `k2_check`'s bounds (`k2_check_swint`);
43. GLIP's early fusion in the head (`early_fuse="mha-b"`: VLFuse MHA-B
   over the five levels and a BERT layer before each DyConv) on FIBER-B
   at 800x1344, B = DET_B, T = 256, bf16: `detection_inference` as in
   phase 28, GLIP_REPS timed calls, 24 K1 on `tc`, a profiled call
   (`glip_infer_800`);
44. that model under `DetectionTrainer`, DET_TRAIN_STEPS steps on one
   batch: finite losses, the last total below the first, 24 K1 and 24 K2
   a step on `tc`, step ms and peak memory (`glip_train_800`);
45. the early-fusion detector in fp32 at DET_GRAD_SIZE, B = 1, with BERT
   and then CLIP language layers: head outputs card vs host within
   DET_RTOL, gradients within GRAD_RTOL or twice the host's own spread,
   losses within DET_LOSS_RTOL (`glip_fp32_card_vs_host`; it runs while
   phases 38-40's ranks run);
46. the four Swin-T registry backbones (`build_backbone`) at 800x1344,
   B = DET_B, bf16: forward ms, K1 launches by route (10 a forward for the
   VL trunks, 12 for the others, on `tc`), one backward of
   SWINT-VL-FPN-RETINANET (10 K2 on `tc`, finite gradients), each in fp32
   card vs host at REGISTRY_FP32_SIZE within REGISTRY_RTOL
   (`registry_swint_800`);
47. the ResNet-50 / 101, EfficientNet-B0 / B7 BiFPN and FBNet registry
   backbones likewise: forward ms, peak memory, fp32 card vs host
   (`registry_conv_800`);
48. the modulated deformable conv's fp32 backward at the first DyConv's
   shapes at DET_GRAD_SIZE (five FPN levels, 256 channels, its same,
   stride-2 and reinterpreted convs), on the card through the sampling
   kernel's Function (13 launches a run): two card runs against each
   other, the card and the host's fp32 against the host's fp64; it fails
   where the card alone is off (`deform_bwd_card_vs_host`);
49. right after phase 28, on its model: the fusion backbone's five FPN
   levels of its two images (24 K1 on `tc`), then in fp32 at full width
   the dense heads of `build_head` (RPN, RETINA with 81 classes, FCOS,
   ATSS) with their losses and backwards, `rpn_proposals` (1000 / 512),
   `sample_proposals` (512 at 0.25), the box, mask and keypoint heads
   with their losses, backwards and inference, the detections' masks
   pasted on the host and scored (`coco_map`, segm), `deform_psroi_pool`
   (512 ROIs, 7x7 groups) and `set_criterion` (100 queries, Hungarian);
   `im_detect_bbox_aug` over `detection_inference` (scales 0.75 and 1.0,
   flipped: four calls); forward ms, ROIAlign ms, peak memory, seconds
   (`roi_heads_800`);
50. the same suite at 320x480, B = 1, fp32 on the card and on the host
   from the same weights, inputs and draws: forwards within 1e-3 of
   max-abs, gradients within it or twice the host's error to fp64, the
   integer outputs equal (`roi_fp32_card_vs_host`);
51. right after phase 29, on its model: `eval_predictions` (4 images, ten
   classes in chunks of 5, 24 K1 a forward on `tc`) scored by every
   evaluator of `fiber_torch/detection/evaluation.py` against seeded
   ground truths with crowd, ignore and difficult flags, LVIS frequency
   groups over 1203 categories, negative and not-exhaustive ids, Flickr
   phrases and two refexp datasets, each timed on the host: every metric
   in [0, 1], and the ground truths fed back at score 1 giving 1.0 at
   every metric (`det_evaluators_800`);
52. while phases 53-54's tools run: the port's seeded FIBER-Base 384^2 VQA
   state_dict saved as a .pth under `module.` and fuzzy-loaded
   (`utils/fuzzy_load.py`) into the 576^2 VQA preset, every bias table
   resized from 529 to 1225 rows, no key left but `alpha_t2i`; one bf16
   VQA forward (24 K1 on `tc_long`), its logits bit-equal to a model
   given the tables resized on the host (`fuzzy_load_576`);
53. inside phase 24's directory: `python -m fiber_torch.tools.eval_all`
   over its checkpoints, one JSON line a step, the last equal to
   `eval_step` of a trainer restored in this process (`eval_all_ckpts`);
54. at once with 53: a full-width 384^2 batch with one NaN image dumped
   (`utils/nan_debug.dump_training_state`) and replayed by `python -m
   fiber_torch.tools.debug_nan` under fp32 and bf16, the terms that read
   the image non-finite in both (`debug_nan_replay`);
55. inside phase 5, on its model: `utils/profiling.py::summarize_model` on
   the rerank (params, FLOPs, K1's reported FLOPs against the analytic
   window-attention count), and a narrower FIBER at 192^2 in fp32 on the
   card and on the host, the same FLOPs (`summarize_model_384`);
22. one JSON line of kernel results, then the result line.

Every phase fails loudly; the last line is printed only when all passed.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from fiber_torch import cli
from fiber_torch.config import (FiberConfig, task_finetune_caption_cider,
                                task_finetune_caption_gold,
                                task_finetune_caption_mle,
                                task_finetune_irtr_itc,
                                task_finetune_irtr_itm_itc,
                                task_finetune_nlvr2, task_finetune_vqa,
                                task_pretrain_mlm_itm_itc)
import fiber_torch.ops.swin_stage as k3_ops
import fiber_torch.ops.window_attention as wa_ops
from fiber_torch.data import device_transforms as dtf
from fiber_torch.data.od_to_grounding import (build_detection_prompt,
                                              build_label_to_token_map)
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.detection import (alt_heads, box_aug, evaluation, matcher,
                                   roi_heads, set_loss, structures)
from fiber_torch.detection.anchors import fpn_anchors
from fiber_torch.detection.backbones import build_backbone
from fiber_torch.detection.boxes import box_iou_legacy
from fiber_torch.detection import deform_conv
from fiber_torch.detection.deform_conv import (deform_im2col,
                                               deform_psroi_pool,
                                               modulated_deform_conv2d)
from fiber_torch.detection.evaluation import coco_map
from fiber_torch.detection.demo import GroundingDemo, find_noun_phrases
from fiber_torch.detection.detector import (DetectorConfig, GroundingDetector,
                                            detection_inference,
                                            detection_loss)
from fiber_torch.detection.postprocess import label_to_token_matrix
from fiber_torch.kernels import _build
from fiber_torch.native import CiderD
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.models.layers import set_generator
from fiber_torch.models.swin import (SwinBlock, relative_position_index,
                                     shifted_window_mask)
from fiber_torch.objectives import caption, coarse, retrieval
from fiber_torch.ops.swin_stage import (fused_swin_blocks,
                                        fused_swin_blocks_reference,
                                        run_stacks, stack_stage, stack_swin)
from fiber_torch.ops.window_attention import (
    split_heads_qkv, window_attention, window_attention_bwd,
    window_attention_bwd_reference, window_attention_heads,
    window_attention_heads_reference, window_attention_reference)
from fiber_torch.tools import eval_all, eval_det, profile_tail
from fiber_torch.tools.train_det import synthetic_batches
from fiber_torch.train.checkpoint import CheckpointManager
from fiber_torch.train.detection_trainer import (DetectionTrainer,
                                                 MultiScaleDetectionTrainer)
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils import fuzzy_load, profiling
from fiber_torch.utils.nan_debug import dump_training_state

SEED = 0
# the fp32 kernels' shared headers: the forward's routine, the backward's
# split-TF32 pieces
F32_SHARED = ["fiber_torch/csrc/window_attention_f32.cuh",
              "fiber_torch/csrc/window_attention_tf32.cuh",
              "fiber_torch/csrc/mma_tf32.cuh",
              "fiber_torch/csrc/window_attention_bwd_common.cuh"]
# published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and fp32
# CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the fp32 routes on the TF32 tensor cores (495 TFLOP/s), by route: three
# TF32 products for each fp32 one
PEAK_FLOPS_ROUTE = {"tc_f32": 495e12 / 3}
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the kernel rows of the result line: K1 at the fused-tail stage-3 shape of
# the rerank (pair batch 16), the shape the rerank launches most; K2 at
# stage 3 (18 of the 24 blocks) and the train step's largest batch
REPORT_SHAPE = (torch.bfloat16, 16, 2)
TRAIN_B = 8                     # images per train step; ITM forwards 3 B
STEPS = 5
REPORT_SHAPE_BWD = (torch.bfloat16, 3 * TRAIN_B, 2)
# K2's route by dtype at FIBER's 384^2 windows (N = 144, hd = 32:
# fiber_torch/ops/window_attention.py::_bwd_route), and at its 576^2
# windows (N = 324); K1's and K4's at 384^2: `_fwd_route`.  fp32 K1, K2
# and K4 at hd <= 64 run one route each at every N: K1 and K4 the
# register-tiled CUDA-core forward (FP32_FWD_ROUTE), K2 the split-TF32
# tensor-core kernels (FP32_ROUTE)
FP32_FWD_ROUTE = "f32_tiled"
FP32_ROUTE = "tc_f32"
BWD_ROUTE = {torch.float32: FP32_ROUTE, torch.bfloat16: "tc"}
BWD_LONG_ROUTE = {torch.float32: FP32_ROUTE, torch.bfloat16: "tc_long"}
K1_BATCHES = (2, 16, 3 * TRAIN_B)
# K1 at FIBER's 576^2 windows (18 x 18, N = 324): the batch of its rows, the
# fp32 limit (absolute), and the row of the result line (stage 1, bf16)
K1_LONG_B = 4
K1_LONG_FP32_ATOL = 1e-5
K1_LONG_BIT_EQUAL = 0.999
REPORT_SHAPE_LONG = (torch.bfloat16, 0)
# K2 at FIBER's 576^2 windows: the VQA step's batch, the fp32 limit
# (absolute), bf16 dbias's limit over its max-abs, the result line's row
VQA_B, VQA_STEPS = 8, 4
K2_LONG_FP32_ATOL = 1e-5
K2_LONG_DBIAS_RTOL = 1e-5
REPORT_SHAPE_BWD_LONG = (torch.bfloat16, 0)
# captioning: RoBERTa's ids, the decode's length and beams (caption_images'
# defaults), the images per batch
BOS, EOS, PAD = 0, 2, 1
CAPTION_B, CAPTION_MAX_LEN, CAPTION_BEAM = 4, 20, 5
# fp32 gradients, card against host: max |diff| <= GRAD_RTOL * max |host|
GRAD_RTOL = 1e-3
# K3 against its plain version: max |diff| <= K3_RTOL * max |plain|
K3_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
K3_BATCHES = (4, 16)
# K3's row in the result line: stage 3 (its 14 trunk blocks) at the
# rerank's trunk batch; K4's: the fused tail's stage-3 shape at batch 16
REPORT_SHAPE_K3 = (torch.bfloat16, 4, 2)
REPORT_SHAPE_K4 = (torch.bfloat16, 16, 2)
# the model through K3 against the per-block path: fp32 max |diff| <=
# MODEL_RTOL * max |per block|; bf16 rerank and ITC scores within 5e-2
MODEL_RTOL = 1e-3
PROFILE_BATCH = 64
# K3 and K4 at FIBER's 576^2 windows (N = 324): K3 at stage 3 (two blocks,
# the second shifted), K4 at stage 1; the batches
K3_LONG_B, K4_LONG_B = 2, 4
# the long-window K3's attention block shapes (rows a block, warps a slab)
# timed against its plan's at stage 3 (its header weighs these three)
K3_LONG_BLOCKS = ((48, 3), (64, 2), (64, 3))
# caption finetuning at 576^2: the MLE step's batch and steps (the
# checkpoint saved after CKPT_AFTER steps, the next step taken again by a
# trainer restored from it), the gold steps, SCST's images, samples, length
# and the reference captions per image
CAPTION_TRAIN_B, CAPTION_STEPS, CKPT_AFTER = 8, 5, 3
GOLD_STEPS = 3
SCST_B, SCST_SAMPLES, SCST_MAX_LEN, SCST_REFS = 4, 5, 50, 5
# the on-device preprocessing: images a batch, (output, staging) sizes of
# the 384^2 and 576^2 presets, the card-vs-host limit on the 0-255 scale
PP_B = 8
PP_SIZES = ((384, 576), (576, 864))
PP_ATOL_255 = 1e-3
# the CLI: batch, steps, checkpoint period, the resumed run's last step; the
# retrieval presets' steps; the NLVR2 steps
CLI_B, CLI_STEPS, CLI_CKPT_EVERY, CLI_RESUME_STEPS = 8, 2, 2, 3
CLI_IRTR_STEPS = 3
NLVR2_STEPS = 3
# detection: the 800x1344 bucket, its batch, the sizes of the seeded images
# staged into it, the calls timed, the prompt's classes; the fp32 card-vs-
# host size and limit (over each tensor's max-abs); the evaluation's images
# and chunk
DET_SIZE, DET_B = (800, 1344), 2
# the detection stages' windows at DET_SIZE (12 x 12, shifted) and heads:
# 200 x 336 tokens padded to 204 x 336, 100 x 168 to 108 x 168, 50 x 84 to
# 60 x 84, 25 x 42 to 36 x 48
DET_WINDOWS = ((17, 28, 4), (9, 14, 8), (5, 7, 16), (3, 4, 32))
DET_IMAGE_SIZES = ((800, 1066), (600, 800))
DET_REPS = 5
DET_CLASSES = {1: "person", 2: "bicycle", 3: "car", 4: "dog", 5: "bus"}
DET_FP32_SIZE, DET_RTOL = (320, 480), 1e-3
DET_EVAL_IMAGES, DET_EVAL_CHUNK = 8, 5
# detection training: the steps on one batch and their learning rate; the
# fp32 card-vs-host gradients' size and the losses' limit (relative); the
# CLIs' steps; the multi-scale buckets (landscape, portrait)
DET_TRAIN_STEPS, DET_TRAIN_LR = 5, 1e-4
DET_GRAD_SIZE, DET_LOSS_RTOL = (320, 480), 1e-4
DET_CLI_STEPS = 6
DET_MULTISCALE = ((800, 1344), (1344, 800))


_T0 = time.perf_counter()


def info(**kw) -> None:
    """One JSON line, with the seconds since the script started (t_s)."""
    print(json.dumps(dict(kw, t_s=round(time.perf_counter() - _T0, 1))),
          flush=True)


def ptxas_lines(names) -> dict:
    """The compiler's register and spill lines of each library built."""
    return {n: [ln.strip() for ln in _build.build_logs.get(n, "").splitlines()
                if "registers" in ln or "spill" in ln][:40] for n in names}


def reset_counts() -> None:
    """Every kernel launch count, by route too, set to 0."""
    for op in (window_attention, window_attention_bwd,
               window_attention_heads, fused_swin_blocks,
               modulated_deform_conv2d):
        op.launches = 0
        routes = getattr(op, "route_launches", {})
        routes.update({k: 0 for k in routes})


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of `fn`: CUDA events around `iters` calls,
    enqueued while a spin kernel (about 10 ms) holds the stream, so that
    the calls run back to back on the device and the time is the device's,
    not the host's launch overhead (as long as the host enqueues them
    within the spin)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def swin_bias(gen: torch.Generator, window: int, h: int, H: int, W: int,
              shifted: bool) -> torch.Tensor:
    """(nW, h, N, N) fp32 bias as a Swin block builds it: a seeded RPB table
    gathered by the relative position index, plus the -100 shift mask, or
    without a mask broadcast over the windows (stride 0)."""
    N = window * window
    nW = (H // window) * (W // window)
    table = torch.randn((2 * window - 1) ** 2, h, generator=gen) * 0.02
    idx = torch.from_numpy(relative_position_index(window).astype(np.int64))
    rpb = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)[None]
    if shifted:
        mask = torch.from_numpy(shifted_window_mask(H, W, window, window // 2))
        return (rpb + mask[:, None]).contiguous().cuda()
    return rpb.contiguous().cuda().expand(nW, h, N, N)


def bound(nbytes: int, flops: int, dtype: torch.dtype,
          route: str = None) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak for the type (for the route, where it runs
    on other units than the type's, `PEAK_FLOPS_ROUTE`), whichever is
    larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS_ROUTE.get(route, PEAK_FLOPS[dtype]) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bias_bytes(bias: torch.Tensor) -> int:
    """fp32 bias bytes, counted once even when broadcast over windows."""
    return (bias.numel() if bias.stride(0) else bias[0].numel()) * 4


def kernel_timing(qkv: torch.Tensor, bias: torch.Tensor, h: int) -> dict:
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    esz = qkv.element_size()
    nbytes = qkv.numel() * esz + B * nW * N * C * esz + bias_bytes(bias)
    flops = fwd_flops(B, nW, N, h, hd)
    # the library yardstick: SDPA on the same q, k, v with the bias as a
    # float mask, its inputs laid out for it outside the timed call
    x = qkv.view(B * nW, N, 3, h, hd)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    mask = bias.expand(B, nW, h, N, N).reshape(B * nW, h, N, N).to(qkv.dtype)
    return dict(
        ms=cuda_time_ms(lambda: window_attention(qkv, bias, h)),
        plain_ms=cuda_time_ms(lambda: window_attention_reference(qkv, bias, h)),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        **bound(nbytes, flops, qkv.dtype))


def bwd_timing(qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor,
               h: int, route: str, iters: int = 20) -> dict:
    B, nW, N, C3 = qkv.shape
    hd = C3 // 3 // h
    esz = qkv.element_size()
    # qkv and dout read, dqkv written, the bias read and dbias written
    nbytes = ((2 * qkv.numel() + dout.numel()) * esz + bias_bytes(bias)
              + nW * h * N * N * 4)
    flops = B * nW * h * 10 * N * N * hd         # five products
    # the library yardstick: the backward alone of SDPA, windows and heads
    # folded into one axis, the bias a (1, nW h, N, N) mask that needs grad
    # (its gradient summed over the batch, as dbias is)
    x = qkv.view(B, nW, N, 3, h, hd)
    q, k, v = (x[:, :, :, i].permute(0, 1, 3, 2, 4).reshape(B, nW * h, N, hd)
               .detach().requires_grad_(True) for i in range(3))
    mask = (bias.to(qkv.dtype).reshape(1, nW * h, N, N).detach().clone()
            .requires_grad_(True))
    g = dout.view(B, nW, N, h, hd).permute(0, 1, 3, 2, 4).reshape(
        B, nW * h, N, hd)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (q, k, v, mask), g, retain_graph=True), iters)
    return dict(
        ms=cuda_time_ms(lambda: window_attention_bwd(qkv, bias, dout, h),
                        iters),
        plain_ms=cuda_time_ms(
            lambda: window_attention_bwd_reference(qkv, bias, dout, h),
            iters),
        library_ms=library_ms, library=out.grad_fn.name(),
        **bound(nbytes, flops, qkv.dtype, route))


# products of N^2 hd each kernel of K2's row and column routes runs (bf16
# "tc_long", fp32 "tc_f32", each product there three TF32 products), for
# its TFLOP/s as run (the algorithm needs five in all)
K2_LONG_PRODUCTS = {"rows": 5, "cols": 4}


def bwd_long_kernel_ms(qkv: torch.Tensor, bias: torch.Tensor,
                       dout: torch.Tensor, h: int, iters: int = 20) -> dict:
    """K2's row and column kernels (bf16 "tc_long", fp32 "tc_f32"), each
    timed alone on CUDA events (`cuda_time_ms`; the column kernel on the
    statistics of a row launch), with their TFLOP/s as run and the
    plan."""
    launch, plan = wa_ops.window_attention_bwd_kernels(
        qkv, bias, dout, h)
    launch(wa_ops._BWD_ROW_KERNEL)      # the statistics the columns read
    B, nW, N, C3 = qkv.shape
    per_product = 2 * B * nW * h * N * N * (C3 // 3 // h)
    row = dict(
        rows_ms=cuda_time_ms(lambda: launch(wa_ops._BWD_ROW_KERNEL), iters),
        cols_ms=cuda_time_ms(lambda: launch(wa_ops._BWD_COL_KERNEL), iters))
    for k in ("rows", "cols"):
        row[f"{k}_tflops_as_run"] = (K2_LONG_PRODUCTS[k] * per_product
                                     / row[f"{k}_ms"] / 1e9)
    row["kernel_plan"] = list(plan)
    return row


def within_ulp(got: torch.Tensor, ref: torch.Tensor, parts: int = 1) -> bool:
    """|got - ref| within one bf16 ulp of each row's largest magnitude,
    the rows cut into `parts` equal pieces along the last axis (dq, dk and
    dv of a dqkv row)."""
    w = ref.shape[-1] // parts
    for i in range(parts):
        r, g = (t[..., i * w:(i + 1) * w].float() for t in (ref, got))
        ulp = 2.0 ** (torch.floor(torch.log2(
            r.abs().amax(-1, keepdim=True).clamp_min(1e-30))) - 7)
        if not bool(((g - r).abs() <= ulp).all()):
            return False
    return True


def consume_draws(gen: torch.Generator, B, H, W, window, h, hd,
                  shifted: bool) -> None:
    """Advance `gen` as `check_kernel`'s draws at this shape advance it
    (the bias table, then qkv)."""
    del shifted                  # the mask draws nothing
    N, nW = window * window, (H // window) * (W // window)
    torch.randn((2 * window - 1) ** 2, h, generator=gen)
    torch.randn(B, nW, N, 3 * h * hd, generator=gen)


def within_ulp_or_flip(got: torch.Tensor, ref: torch.Tensor,
                       qkv: torch.Tensor, bias: torch.Tensor, h: int) -> bool:
    """K1's bf16 bound: |got - ref| within one bf16 ulp of each row's
    largest magnitude plus, for each head and channel, the largest |v| of
    that channel times one bf16 ulp of the row's largest probability.  The
    second term is the move of one probability rounded to bf16 the other
    way: where a P lies at a rounding midpoint the plain version's fp32
    softmax and the kernel's round it apart, and a large v carries that
    past one ulp of the output."""
    B, nW, N, C3 = qkv.shape
    hd = C3 // 3 // h
    q, k, v = (t.float() for t in split_heads_qkv(qkv, h))  # (B, nW, h, N, hd)
    p = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5
                      + bias.float()[None], dim=-1)
    p_ulp = 2.0 ** (torch.floor(torch.log2(p.amax(-1).clamp_min(1e-30))) - 7)
    flip = (p_ulp[..., None] * v.abs().amax(-2)[:, :, :, None, :])
    flip = flip.transpose(2, 3).reshape(B, nW, N, h * hd)
    r, g = ref.float(), got.float()
    ulp = 2.0 ** (torch.floor(torch.log2(
        r.abs().amax(-1, keepdim=True).clamp_min(1e-30))) - 7)
    return bool(((g - r).abs() <= ulp + flip).all())


def within_ulp_or_flip_bwd(got: torch.Tensor, ref: torch.Tensor,
                           qkv: torch.Tensor, bias: torch.Tensor,
                           dout: torch.Tensor, h: int) -> bool:
    """K2's bf16 bound at the long windows, K1's (`within_ulp_or_flip`)
    carried to the backward: |got - ref| within one bf16 ulp of each dq /
    dk / dv row's largest magnitude plus the move of one dS or P rounded
    to bf16 the other way at a midpoint.  dq row i: scale times one bf16
    ulp of the row's largest |dS_ij| times the channel's largest |k_jd|;
    dk row j: scale times one ulp of column j's largest |dS_ij| times the
    channel's largest |q_id|; dv row j: one ulp of column j's largest P_ij
    times the channel's largest |dO_id|.  On 20 fresh seeds of
    `check_bwd_kernel`'s draws at the four 576^2 stages every element past
    one ulp was one such flip against fp64 (PERF.md §6)."""
    B, nW, N, C3 = qkv.shape
    hd = C3 // 3 // h
    scale = hd ** -0.5
    q, k, v = split_heads_qkv(qkv, h)
    do = dout.view(B, nW, N, h, hd).transpose(2, 3).float()
    p = torch.softmax((q * scale).float() @ k.float().transpose(-1, -2)
                      + bias.float()[None], dim=-1)
    dp = do @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del dp
    ulp = lambda x: 2.0 ** (torch.floor(torch.log2(x.clamp_min(1e-30))) - 7)
    # (B, nW, h, N, hd) bounds of one flip, for dq, dk and dv
    flips = (scale * ulp(ds.abs().amax(-1))[..., None]
             * k.float().abs().amax(-2)[:, :, :, None, :],
             scale * ulp(ds.abs().amax(-2))[..., None]
             * q.float().abs().amax(-2)[:, :, :, None, :],
             ulp(p.amax(-2))[..., None] * do.abs().amax(-2)[:, :, :, None, :])
    del p, ds
    C = h * hd
    for i, flip in enumerate(flips):
        r = ref[..., i * C:(i + 1) * C].float()
        g = got[..., i * C:(i + 1) * C].float()
        row = ulp(r.abs().amax(-1, keepdim=True))
        flip = flip.transpose(2, 3).reshape(B, nW, N, C)
        if not bool(((g - r).abs() <= row + flip).all()):
            return False
    return True


def routed(op, fn):
    """fn(), the routes of the kernel op `op` (K1's, K3's or K4's) that it
    launched, and the batch splits of its last launch (None for K3)."""
    before = dict(op.route_launches)
    out = fn()
    return out, [k for k, v in op.route_launches.items()
                 if v != before[k]], getattr(op, "last_splits", None)


def fwd_flops(B, nW, N, h, hd) -> int:
    return B * nW * h * 4 * N * N * hd           # q.k^T and p.v


def check_kernel(gen, B, H, W, window, h, hd, dtype, shifted, timed,
                 phase="k1_check") -> dict:
    """K1 against its plain version at one shape, on the route
    `_fwd_route` gives; optionally timed."""
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    out, route, splits = routed(window_attention,
                                lambda: window_attention(qkv, bias, h))
    rows, parts = window_attention.last_rows, window_attention.last_parts
    ref = window_attention_reference(qkv, bias, h)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    expect = wa_ops._fwd_route(dtype, N, hd)
    bit_equal = (out == ref).float().mean().item()
    ulp_ok = dtype != torch.bfloat16 or within_ulp(out, ref)
    # the long route's bound: one ulp, or one probability rounded apart at
    # a tie (ROADMAP queue 2 item 2)
    # and at the Swin-T shapes (k1_check_swint) bf16's
    flip_bound = expect == "tc_long" or (phase == "k1_check_swint"
                                         and dtype == torch.bfloat16)
    flip_ok = not flip_bound or within_ulp_or_flip(out, ref, qkv, bias, h)
    ok = (torch.allclose(out.float(), ref.float(), **TOL[dtype])
          and route == [expect] and flip_ok
          and (dtype != torch.float32 or phase != "k1_check_long"
               or err <= K1_LONG_FP32_ATOL)
          and (expect != "tc_long" or bit_equal >= K1_LONG_BIT_EQUAL))
    row = dict(phase=phase, B=B, nW=nW, N=N, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), shift_mask=shifted,
               route=route, splits=splits, rows=rows, parts=parts,
               max_abs_err=err, max_abs_out=scale, rel_err=err / scale,
               within_one_ulp=ulp_ok, within_ulp_or_flip=flip_ok,
               bit_equal_share=bit_equal, ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K1 disagrees with its plain version or its "
                             f"route ({expect}): {row}")
    if timed:
        row.update(kernel_timing(qkv, bias, h))
        row["tflops"] = fwd_flops(B, nW, N, h, hd) / row["ms"] / 1e9
    info(**row)
    return row


def long_row_times(gen, cfg: FiberConfig, stage: int, B: int) -> dict:
    """bf16 K1 on the long-window route at one 576^2 stage, timed at the
    (rows a block, warps a slab) `_long_rows` chooses and at each pair
    that fits (forced in its place, the splits then `_bwd_splits`' for
    it), in the order plan, pairs ascending, pairs descending, plan: two
    times for each; then at the plan's pair with one split at B = 1, 2, 4,
    8, 16."""
    g, win = cfg.stage_resolution(stage)[0], cfg.derived_window_size
    h, hd = cfg.swin_num_heads[stage], 32
    bias = swin_bias(gen, win, h, g, g, shifted=g > win)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to(
        "cuda", torch.bfloat16)
    policy = wa_ops._long_rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = wa_ops._long_plan(B, nW, h, N, hd, sms)
    smem = lambda R, p: wa_ops._fwd_long_smem_bytes(N, hd, R, p)
    fits = [(R, p, n) for p in range(1, 5) for R in range(16, 129, 16)
            if (p == 1 or R // 16 * p <= wa_ops._LONG_SM_WARPS)
            and (n := wa_ops._resident(smem(R, p), R // 16 * p,
                                       wa_ops._LONG_SM_WARPS))]
    order = ["plan"] + fits
    ms = {}
    try:
        for choice in order + order[::-1]:
            wa_ops._long_rows = (policy if choice == "plan"
                                 else lambda *_, c=choice: c)
            key = choice if choice == "plan" else f"{choice[0]}x{choice[1]}"
            ms.setdefault(key, []).append(cuda_time_ms(
                lambda: window_attention(qkv, bias, h)))
    finally:
        wa_ops._long_rows = policy
    # the plan's rows at one split against the batch: the slope is the
    # time of a batch element, the intercept what a block costs once
    by_batch = {}
    plan = wa_ops._long_plan
    try:
        wa_ops._long_plan = lambda *_: (chosen[0], chosen[1], 1, chosen[3])
        for Bs in (1, 2, 4, 8, 16):
            x = torch.randn(Bs, nW, N, 3 * h * hd, generator=gen).to(
                "cuda", torch.bfloat16)
            by_batch[Bs] = cuda_time_ms(lambda: window_attention(x, bias, h))
    finally:
        wa_ops._long_plan = plan
    row = dict(phase="k1_long_rows", stage=stage + 1, B=B, nW=nW, h=h, N=N,
               plan={"rows": chosen[0], "parts": chosen[1],
                     "splits": chosen[2], "blocks_per_sm": chosen[3]},
               ms_by_rows_x_parts=ms, ms_by_batch_one_split=by_batch)
    info(**row)
    return row


def check_bwd_kernel(gen, B, H, W, window, h, hd, dtype, shifted,
                     timed, phase="k2_check") -> dict:
    """K2 against its plain version at one shape, on the route
    `_bwd_route` gives, and a second call against the first bit for bit;
    optionally timed.  At FIBER's 384^2 windows within TOL; at its 576^2
    windows (`k2_check_long`) bf16 within one ulp of each dq / dk / dv
    row's max-abs and dbias within K2_LONG_DBIAS_RTOL of its max-abs, fp32
    within K2_LONG_FP32_ATOL.  bf16 at the long windows admits, beyond the
    ulp, one dS or P rounded the other way at a midpoint
    (`within_ulp_or_flip_bwd`), as K1's check does."""
    t0 = time.perf_counter()
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    dout = torch.randn(B, nW, N, h * hd, generator=gen).to("cuda", dtype)
    routes = dict(window_attention_bwd.route_launches)
    dqkv, dbias = window_attention_bwd(qkv, bias, dout, h)
    route = [k for k, v in window_attention_bwd.route_launches.items()
             if v != routes[k]]
    splits = window_attention_bwd.last_splits
    plan = window_attention_bwd.last_plan
    again = window_attention_bwd(qkv, bias, dout, h)
    rq, rb = window_attention_bwd_reference(qkv, bias, dout, h)
    torch.cuda.synchronize()
    err_q = (dqkv.float() - rq.float()).abs().max().item()
    err_b = (dbias - rb).abs().max().item()
    scale_q = rq.float().abs().max().item()
    scale_b = rb.abs().max().item()
    same = bool(torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1]))
    long = phase == "k2_check_long"
    expect = (BWD_LONG_ROUTE if long else BWD_ROUTE)[dtype]
    strict = None
    if not long:
        close = (torch.allclose(dqkv.float(), rq.float(), **TOL[dtype])
                 and torch.allclose(dbias, rb, **TOL[dtype]))
    elif dtype == torch.bfloat16:
        strict = within_ulp(dqkv, rq, 3)
        close = ((strict or within_ulp_or_flip_bwd(dqkv, rq, qkv, bias, dout,
                                                   h))
                 and err_b <= K2_LONG_DBIAS_RTOL * scale_b)
    else:
        close = max(err_q, err_b) <= K2_LONG_FP32_ATOL
    ok = close and same and route == [expect]
    row = dict(phase=phase, B=B, nW=nW, N=N, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), shift_mask=shifted,
               broadcast_bias=bias.stride(0) == 0, route=route,
               splits=splits, plan=plan, bit_equal_two_calls=same,
               within_one_ulp=strict,
               max_abs_err_dqkv=err_q, max_abs_dqkv=scale_q,
               rel_err_dqkv=err_q / scale_q, max_abs_err_dbias=err_b,
               max_abs_dbias=scale_b, rel_err_dbias=err_b / scale_b,
               max_abs_err=max(err_q, err_b), ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K2 disagrees with its plain version, with "
                             f"itself or with its route: {row}")
    if timed:
        iters = 5 if long and dtype == torch.float32 else 20
        row.update(bwd_timing(qkv, bias, dout, h, route[0], iters))
        row["tflops"] = B * nW * h * 10 * N * N * hd / row["ms"] / 1e9
        if route[0] in wa_ops._BWD_PLAN_LEN:
            row.update(bwd_long_kernel_ms(qkv, bias, dout, h, iters))
    row["seconds"] = time.perf_counter() - t0
    info(**row)
    return row


def bwd_long_rows_times(gen, cfg: FiberConfig, stage: int, B: int) -> dict:
    """bf16 K2 on the long-window route at one 576^2 stage, its row and
    column kernels timed apart (`bwd_long_kernel_ms`'s way) at the plan's
    (parts, stages) and (Rc, stages'), at each (parts, stages) that fits
    the row kernel with the plan's columns, and at each (Rc, stages') that
    fits the column kernel with the plan's rows (each forced in place of
    `_bwd_long_plan`, the splits `_bwd_splits`' for it), in the order
    plan, choices, choices reversed, plan: two (rows, cols) ms for each."""
    t0 = time.perf_counter()
    g, win = cfg.stage_resolution(stage)[0], cfg.derived_window_size
    h, hd = cfg.swin_num_heads[stage], 32
    bias = swin_bias(gen, win, h, g, g, shifted=g > win)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to(
        "cuda", torch.bfloat16)
    dout = torch.randn(B, nW, N, h * hd, generator=gen).to(
        "cuda", torch.bfloat16)
    policy = wa_ops._bwd_long_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = policy(B, nW, h, N, hd, sms)
    rows_smem = lambda p, st: wa_ops._bwd_rows_smem_bytes(N, hd, p, st)
    cols_smem = lambda Rc, st: wa_ops._bwd_cols_smem_bytes(N, hd, Rc, st)

    def forced(parts: int, stages: int, Rc: int, col_stages: int):
        per_sm_c = min(wa_ops._resident(cols_smem(Rc, col_stages),
                                        Rc // 16 + 1), 128 // Rc)

        def plan(B, nW, h, N, hd, sms):
            return (64, parts, stages,
                    wa_ops._bwd_splits(B, nW * -(-N // 64), h, sms, 1), Rc,
                    wa_ops._bwd_splits(B, nW * -(-N // Rc), h, sms, per_sm_c),
                    col_stages)
        return plan

    rows = [(p, st) for p in (1, 2) for st in (0, 2, 3, 4)
            if wa_ops._resident(rows_smem(p, st), 4 * p + 1)]
    cols = [(Rc, st) for Rc in (64, 128) for st in (2, 3, 4)
            if wa_ops._resident(cols_smem(Rc, st), Rc // 16 + 1)]
    order = (["plan"] + [(p, st, chosen[4], chosen[6]) for p, st in rows]
             + [(chosen[1], chosen[2], Rc, st) for Rc, st in cols])
    ms = {}
    try:
        for choice in order + order[::-1]:
            wa_ops._bwd_long_plan = (policy if choice == "plan"
                                     else forced(*choice))
            key = (choice if choice == "plan"
                   else "rows {}x{},cols {}x{}".format(*choice))
            t = bwd_long_kernel_ms(qkv, bias, dout, h, iters=10)
            ms.setdefault(key, []).append([t["rows_ms"], t["cols_ms"]])
    finally:
        wa_ops._bwd_long_plan = policy
    row = dict(phase="k2_long_rows", stage=stage + 1, B=B, nW=nW, h=h, N=N,
               plan=list(chosen), rows_ms_cols_ms_by_plan=ms,
               seconds=time.perf_counter() - t0)
    info(**row)
    return row


def bwd_split_times(gen, B, H, W, window, h, hd, dtype, shifted,
                    timed: bool = True) -> Optional[dict]:
    """K2 at one shape timed at each split count S (forced in place of
    `_bwd_splits`, whose own choice the row names), in the order 1, 2, 4,
    8, 8, 4, 2, 1: two times for each S.  Untimed it only takes its draws
    from `gen`, so that the later rows keep theirs."""
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    dout = torch.randn(B, nW, N, h * hd, generator=gen).to("cuda", dtype)
    if not timed:
        return None
    route = wa_ops._bwd_route(dtype, N, hd)
    policy = wa_ops._bwd_splits
    if route in wa_ops._BWD_LIBS:
        sms, per_sm = wa_ops._split_plan(wa_ops._BWD_LIBS[route], dtype, N,
                                         hd, 0)
        chosen = policy(B, nW, h, sms, per_sm)
    else:               # "tc_f32": the forced S splits both of its kernels
        sms, per_sm = torch.cuda.get_device_properties(
            0).multi_processor_count, None
        chosen = wa_ops._bwd_f32_card_plan(B, nW, h, N, hd,
                                           qkv.device)[1]
    ms = {}
    order = [S for S in (1, 2, 4, 8) if S <= B]
    try:
        for S in order + order[::-1]:
            wa_ops._bwd_splits = lambda *_, S=S: S
            ms.setdefault(S, []).append(cuda_time_ms(
                lambda: window_attention_bwd(qkv, bias, dout, h)))
    finally:
        wa_ops._bwd_splits = policy
    row = dict(phase="k2_splits", route=route, B=B, nW=nW, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), sms=sms,
               per_sm=per_sm, chosen=chosen, ms_by_splits=ms)
    info(**row)
    return row


def profile_share(fn, extra=()) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler, the
    card's activity alone, read from the trace's raw events: grouping them
    through `key_averages` took seconds a profile): the wall time, the
    summed kernel time, the device operations (kernels and copies) run,
    K1's and K2's parts (and those of the kernels named in `extra`,
    (label, name part) pairs) and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the ranges of user annotations (such as
    # the optimizer's step), whose kernels are counted on their own
    kernels, device_ops = {}, 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation()):
            continue
        device_ops += 1
        kernels[e.name()] = kernels.get(e.name(), 0.0) + e.duration_ns() / 1e6
    total = sum(kernels.values())
    k1 = sum(v for k, v in kernels.items() if "window_attention_fwd" in k)
    k2 = sum(v for k, v in kernels.items() if "window_attention_bwd" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    more = {f"{label}_ms": sum(v for k, v in kernels.items() if part in k)
            for label, part in extra}
    return dict(wall_ms=wall_ms, kernel_ms=total,
                device_ops=device_ops, k1_ms=k1, k2_ms=k2,
                k1_share=k1 / total, k2_share=k2 / total, **more,
                busy_share=total / wall_ms,
                top_kernels=[[k[:60], v] for k, v in top])


def seeded_gates(model: FiberCoarse, seed: int) -> None:
    """Fusion gates uniform in [0.3, 0.7] (they start at 0, which would make
    the cross-attention paths no-ops)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("alpha_i2t", "alpha_t2i")):
                p.copy_(torch.empty(p.shape).uniform_(0.3, 0.7, generator=gen))


def train_batch(cfg: FiberConfig, B: int, seed: int) -> dict:
    """A numpy pretraining batch: the corpus's images and texts, 15% of
    the real tokens masked for MLM (<mask> in, the id as the label)."""
    images, ids, masks = corpus(cfg, B, B, seed)
    rng = np.random.default_rng(seed + 1)
    pick = (rng.random(ids.shape) < 0.15) & (masks == 1)
    pick[:, 1] = True
    return {"image": images, "text_ids": ids, "text_masks": masks,
            "text_ids_mlm": np.where(pick, cfg.vocab_size - 1, ids),
            "text_labels_mlm": np.where(pick, ids, -100)}


GRAD_CHECKED = ("relative_position_bias_table", "alpha_i2t", "alpha_t2i")


def expected_launches(cfg: FiberConfig, forwards: int) -> tuple:
    """(K1, K2) launches of one step whose losses run `forwards` Swin
    forwards, the MLM fused forward among them.  K1 runs in every block
    of each.  The backward (K2, and K1 again in the recompute under remat)
    runs in every block whose output reaches a loss: all but the MLM
    forward's last block, whose output feeds only the image features that
    MLM does not read (the last text layer reads that block's input)."""
    blocks = sum(cfg.swin_depths)
    k2 = forwards * blocks - 1
    return forwards * blocks + (k2 if cfg.remat else 0), k2


def run_training(card: str) -> dict:
    """Phase 7: STEPS full-width bf16 train steps on one batch, each with
    the launch counts set to 0 before it and read after it; then one step
    under the profiler."""
    cfg = FiberConfig.base(loss_names=("itm", "mlm", "itc"), warmup_steps=0,
                           learning_rate=1e-4)
    t0 = time.perf_counter()
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    info(phase="train_model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in trainer.params),
         queue_slots=trainer.queue.size, remat=cfg.remat, batch=TRAIN_B,
         dropout=cfg.drop_rate, drop_path=cfg.swin_drop_path_rate)
    batch = trainer.to_device(train_batch(cfg, TRAIN_B, SEED))
    expect_k1, expect_k2 = expected_launches(
        cfg, forwards=2 + (3 if cfg.itm_hardneg_chunk else 1))
    steps = []
    for step in range(STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        routes1 = window_attention.route_launches
        routes = window_attention_bwd.route_launches
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = window_attention.launches, window_attention_bwd.launches
        row = dict(phase="train_step", step=step, seconds=seconds, card=card,
                   max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   k1_launches=k1, k2_launches=k2, expected_k1=expect_k1,
                   expected_k2=expect_k2, k1_route_launches=dict(routes1),
                   k2_route_launches=dict(routes),
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        if ((k1, k2) != (expect_k1, expect_k2) or routes1["tc"] != k1
                or routes["tc"] != k2):
            raise AssertionError(f"train step launched K1 {k1} and K2 {k2} "
                                 f"times ({routes1}, {routes} by route), "
                                 f"expected {expect_k1} and {expect_k2}, all "
                                 f"on the tensor cores")
        if step == 0:
            checked = [(n, p.grad) for n, p in trainer.model.named_parameters()
                       if n.endswith(GRAD_CHECKED)]
            bad = [n for n, g in checked
                   if not (torch.isfinite(g).all() and g.abs().max() > 0)]
            info(phase="train_grads", checked=len(checked), bad=bad)
            if bad or not checked:
                raise AssertionError(f"zero or non-finite gradients: {bad}")
    mlm = [r["mlm_loss"] for r in steps]
    total = int(trainer.queue.total)
    info(phase="train", steps=STEPS, mlm_first=mlm[0], mlm_last=mlm[-1],
         queue_total=total, expected_queue_total=STEPS * TRAIN_B)
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"non-finite losses: {steps}")
    if not mlm[-1] < mlm[0]:
        raise AssertionError(f"the MLM loss did not fall: {mlm}")
    if total != STEPS * TRAIN_B:
        raise AssertionError(f"the queue took {total} rows")
    prof = profile_share(lambda: trainer.train_step(batch))
    info(phase="train_profile", card=card, **prof)
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"])


def grads_card_vs_host(card: str) -> dict:
    """Phase 8: fp32, dropout and drop-path 0, B = 2; gradients of MLM +
    ITM on fixed negatives (each row's neighbour in the batch), card
    (K1 + K2) against the host's plain path.  Returns the card pass's K1
    and K2 launches (`k1`, `k2`) and its launches on the fp32 routes
    (`routes`: K1's `FP32_FWD_ROUTE`, K2's `FP32_ROUTE`)."""
    cfg = FiberConfig.base(compute_dtype=torch.float32, drop_rate=0.0,
                           swin_drop_path_rate=0.0,
                           loss_names=("itm", "mlm", "itc"))
    data = train_batch(cfg, 2, SEED + 1)
    picked = {f"vit_model.layers.{s}.blocks.{b}.attn.qkv.weight"
              for s, depth in enumerate(cfg.swin_depths) for b in (0, depth - 1)}
    grads, losses, counts, routes = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = FiberCoarse(cfg, device=dev, seed=SEED, for_training=True)
        seeded_gates(model, SEED)
        b = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        neg = {"image_neg": b["image"].roll(1, 0),
               "text_neg": b["text_ids"].roll(1, 0),
               "text_mask_neg": b["text_masks"].roll(1, 0)}
        reset_counts()
        loss = (coarse.compute_mlm(model, b)["mlm_loss"]
                + coarse.compute_itm_hardneg(model, b, neg)["itm_loss"])
        loss.backward()
        counts[dev] = (window_attention.launches, window_attention_bwd.launches)
        routes[dev] = (window_attention.route_launches[FP32_FWD_ROUTE],
                       window_attention_bwd.route_launches[FP32_ROUTE])
        losses[dev] = float(loss.detach())
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters()
                      if n.endswith(GRAD_CHECKED) or n in picked}
        info(phase="fp32_grad_pass", device=dev,
             seconds=time.perf_counter() - t0, loss=losses[dev],
             k1_launches=counts[dev][0], k2_launches=counts[dev][1])
        del model, loss
        torch.cuda.empty_cache()
    rel = {n: ((grads["cuda"][n] - g).abs().max() / g.abs().max()).item()
           for n, g in grads["cpu"].items()}
    worst = max(rel, key=lambda n: rel[n] if np.isfinite(rel[n]) else np.inf)
    expect = expected_launches(cfg, forwards=2)      # MLM and ITM forwards
    info(phase="fp32_grad_card_vs_host", card=card, tensors=len(rel),
         worst_rel_err=rel[worst], worst_tensor=worst, limit=GRAD_RTOL,
         loss_card=losses["cuda"], loss_host=losses["cpu"],
         launches=counts["cuda"], fp32_route_launches=routes["cuda"],
         expected_launches=expect)
    if (counts["cuda"] != expect or routes["cuda"] != expect
            or counts["cpu"] != (0, 0)):
        raise AssertionError(f"launches {counts} ({routes} on routes "
                             f"{FP32_FWD_ROUTE}, {FP32_ROUTE}): expected (K1, "
                             f"K2) {expect} on the card's fp32 routes and "
                             f"nothing on the host")
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"card and host gradients differ: {worst} "
                             f"relative error {rel[worst]}")
    if not abs(losses["cuda"] - losses["cpu"]) <= GRAD_RTOL * abs(losses["cpu"]):
        raise AssertionError(f"card and host losses differ: {losses}")
    return dict(k1=counts["cuda"][0], k2=counts["cuda"][1],
                routes=routes["cuda"])


def corpus(cfg: FiberConfig, n_img: int, n_txt: int, seed: int):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_img, cfg.image_size, cfg.image_size, 3)
                                 ).astype(np.float32)
    ids = rng.integers(3, cfg.vocab_size, (n_txt, cfg.max_text_len))
    masks = np.ones_like(ids)
    masks[1::3, cfg.max_text_len // 2:] = 0        # some padded texts
    ids[masks == 0] = cfg.pad_token_id
    return images, ids, masks



def seeded_blocks(gen: torch.Generator, cfg: FiberConfig, stage: int,
                  n: int, dtype: torch.dtype, window: Optional[int] = None
                  ) -> list:
    """n blocks of one FIBER-Base stage as port SwinBlocks on the card,
    alternating shift as a stage builds them (windows of `window`, default
    the config's); weights and bias tables N(0, 0.02) as the model draws
    them, the LayerNorm scales and the biases moved off 1 and 0 by N(0,
    0.02), as the parity tests move them."""
    H, C = cfg.stage_resolution(stage)[0], cfg.stage_dim(stage)
    win = window or cfg.derived_window_size
    blocks = [SwinBlock(C, (H, H), cfg.swin_num_heads[stage], win,
                        (win // 2) * (i % 2), mlp_ratio=cfg.swin_mlp_ratio)
              for i in range(n)]
    with torch.no_grad():
        for blk in blocks:
            for name, p in blk.named_parameters():
                r = 0.02 * torch.randn(p.shape, generator=gen)
                p.copy_(1 + r if name.startswith("norm")
                        and name.endswith("weight") else r)
    return [b.to("cuda", dtype).eval() for b in blocks]


def run_blocks(blocks, x: torch.Tensor) -> torch.Tensor:
    for blk in blocks:
        x = blk(x)
    return x


def check_k3(gen, cfg: FiberConfig, stage: int, n: int, B: int,
             dtype: torch.dtype, phase: str = "k3_check",
             timed: bool = True) -> dict:
    """K3 against its plain version over n seeded blocks of one stage, on
    the route `_k3_route` gives, timed beside the plain version and the
    per-block path (the same blocks as port SwinBlocks: K1 and cuBLAS),
    which stands in the library column: no one PyTorch call computes K3's
    function.  On the CUDA cores (`cuda_core`) and on `tc_f32` the row
    carries the registers, local bytes and blocks an SM the card reports
    for the instance, and the grid is held to blocks an SM x SMs; on
    `tc_long` and `tc_f32` the plan (tiles, rows a block, warps a slab,
    splits) and two calls held to the same bits, on `tc_long` a grid of one
    block an SM.  `tc_f32`'s bound takes its products at 3xTF32's 165
    TFLOP/s (`PEAK_FLOPS_ROUTE`) and its attention too, which runs on the
    CUDA cores: a lower bound; timed, its row also has the bound at the
    CUDA cores' 67 TFLOP/s and each phase's device ms (`tf32_phase_ms`)."""
    blocks = seeded_blocks(gen, cfg, stage, n, dtype)
    st = stack_stage(blocks, dtype)
    H, C = cfg.stage_resolution(stage)[0], cfg.stage_dim(stage)
    N = st.window ** 2
    x = torch.randn(B, H, H, C, generator=gen).to("cuda", dtype)

    def plain():
        return fused_swin_blocks_reference(x, st.params, st.mask, st.window,
                                           st.num_heads, st.use_shift)

    out, route, _ = routed(fused_swin_blocks, lambda: st(x))
    grid = fused_swin_blocks.last_grid
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    expect = k3_ops._k3_route(dtype, N, C // st.num_heads)
    ok = (bool(torch.isfinite(out).all()) and err <= K3_RTOL[dtype] * scale
          and route == [expect])
    planner = {"tc": k3_ops._k3_plan, "tc_long": k3_ops._k3_plan,
               "tc_f32": k3_ops._k3_f32_plan}.get(expect)
    plan = (planner(B, H, H, C, st.params["fc1_w"].shape[1], st.window,
                    st.num_heads, grid) if planner else None)
    attrs, again = None, None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if expect == "cuda_core":
        attrs = k3_ops.cuda_core_attrs(N, C // st.num_heads, dtype)
    if expect == "tc_f32":
        attrs = k3_ops.tf32_attrs(N, C // st.num_heads)
    if attrs:
        ok = ok and grid == attrs["blocks_per_sm"] * sms
    if expect in ("tc_long", "tc_f32"):    # two calls, one result
        again = torch.equal(out, st(x))
        ok = ok and again and (expect != "tc_long" or grid == sms)
    row = dict(phase=phase, stage=stage + 1, blocks=n, B=B, H=H, C=C,
               h=st.num_heads, N=N, dtype=str(dtype).replace("torch.", ""),
               use_shift=st.use_shift, route=route, grid=grid,
               tile_plan=plan, attrs=attrs, max_abs_err=err,
               max_abs_out=scale, rel_err=err / scale,
               limit=K3_RTOL[dtype], bit_equal_two_calls=again, ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K3 disagrees with its plain version or its "
                             f"route ({expect}): {row}")
    if not timed:
        info(**row)
        return row
    esz = x.element_size()
    # x in and out, every stacked weight and bias table once, the mask
    # where shifted blocks read it
    nbytes = (2 * x.numel() * esz
              + sum(t.numel() * t.element_size() for t in st.params.values())
              + (st.mask.numel() * 4 if st.use_shift else 0))
    flops = B * n * H * H * (24 * C * C + 4 * N * C)
    row.update(ms=cuda_time_ms(lambda: st(x), iters=10),
               plain_ms=cuda_time_ms(plain, iters=5),
               library_ms=cuda_time_ms(lambda: run_blocks(blocks, x),
                                       iters=10),
               library="per-block path (SwinBlock: K1 + cuBLAS)",
               gflop=flops / 1e9, **bound(nbytes, flops, dtype, expect))
    if expect == "tc_f32":         # the same work at the CUDA cores' rate
        row["bound_cuda_cores_ms"] = bound(nbytes, flops, dtype)["bound_ms"]
        # and where its time goes: each phase's device ms, summed over the
        # blocks, from the kernel built with its phase timer
        row["phase_ms"] = k3_ops.tf32_phase_ms(lambda: st(x), x.device)
    row["tflops"] = flops / row["ms"] / 1e9
    info(**row)
    return row


def k3_check_hd128(gen) -> list:
    """Phase 9b: K3 at hd = 128, the head dim that no model runs and only
    the CUDA-core route (`swin_stage.cu`) takes, in both dtypes: two
    seeded blocks (C = 256, 2 heads, 4 x 4 windows, the second shifted) at
    B = 1 against the plain version, within K3_RTOL of its max-abs, the
    grid held to the blocks an SM the card reports x SMs."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        blocks = [SwinBlock(256, (8, 8), 2, 4, 2 * i) for i in range(2)]
        with torch.no_grad():
            for blk in blocks:
                for name, p in blk.named_parameters():
                    r = 0.02 * torch.randn(p.shape, generator=gen)
                    p.copy_(1 + r if name.startswith("norm")
                            and name.endswith("weight") else r)
        st = stack_stage([b.to("cuda", dtype).eval() for b in blocks], dtype)
        x = torch.randn(1, 8, 8, 256, generator=gen).to("cuda", dtype)
        out, route, _ = routed(fused_swin_blocks, lambda: st(x))
        grid = fused_swin_blocks.last_grid
        ref = fused_swin_blocks_reference(x, st.params, st.mask, st.window,
                                          st.num_heads, st.use_shift)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        attrs = k3_ops.cuda_core_attrs(16, 128, dtype)
        row = dict(phase="k3_check_hd128", dtype=str(dtype)[6:], N=16,
                   hd=128, route=route, grid=grid, attrs=attrs,
                   max_abs_err=err, max_abs_out=scale, rel_err=err / scale,
                   limit=K3_RTOL[dtype])
        info(**row)
        if not (route == ["cuda_core"] and err <= K3_RTOL[dtype] * scale
                and bool(torch.isfinite(out).all())
                and grid == attrs["blocks_per_sm"] * sms):
            raise AssertionError(f"K3 at hd = 128: {row}")
        rows.append(row)
    return rows


def k3_long_breakdown(cfg: FiberConfig, stage: int, B: int) -> dict:
    """Phase 17a: where bf16 K3's time goes at one 576^2 stage (two blocks,
    the second shifted): the kernel on `tc_long` against its twin on `tc`,
    the same stage in 12 x 12 windows (N = 144; the same M, widths and
    GEMM tiles, so the same GEMM phases and grid syncs, only the attention
    differs), each with one block and two; beside them the per-block
    path's pieces for two blocks: the four products through cuBLAS
    (`F.linear`) and K1 on `tc_long`.  Then the two blocks on `tc_long`
    under each attention block shape K3_LONG_BLOCKS (rows, parts) forced
    in place of `_k3_long_rows`'s, in the order plan, shapes, shapes
    reversed, plan.  Seeded from a generator of its own, so the other
    checks keep their draws."""
    gen = torch.Generator().manual_seed(SEED + 14)
    H, C = cfg.stage_resolution(stage)[0], cfg.stage_dim(stage)
    h = cfg.swin_num_heads[stage]
    x = torch.randn(B, H, H, C, generator=gen).to("cuda", torch.bfloat16)
    row = dict(phase="k3_long_breakdown", stage=stage + 1, B=B, H=H, C=C, h=h)
    for name, win in (("tc_long", cfg.derived_window_size), ("tc", 12)):
        blocks = seeded_blocks(gen, cfg, stage, 2, torch.bfloat16, win)
        for n in (1, 2):
            st = stack_stage(blocks[:n], torch.bfloat16)
            _, route, _ = routed(fused_swin_blocks, lambda: st(x))
            if route != [name]:
                raise AssertionError(f"K3 breakdown: {route}, expected {name}")
            row[f"{name}_N{win * win}_{n}block_ms"] = cuda_time_ms(
                lambda: st(x), iters=10)
    M, hid = B * H * H, 4 * C
    a = torch.randn(M, C, generator=gen).to("cuda", torch.bfloat16)
    am = torch.randn(M, hid, generator=gen).to("cuda", torch.bfloat16)
    ws = [torch.randn(o, i, generator=gen).mul_(0.02).to("cuda", torch.bfloat16)
          for o, i in ((3 * C, C), (C, C), (hid, C), (C, hid))]

    def products():
        for _ in range(2):
            F.linear(a, ws[0]), F.linear(a, ws[1])
            F.linear(a, ws[2]), F.linear(am, ws[3])

    win18 = cfg.derived_window_size
    bias = swin_bias(gen, win18, h, H, H, shifted=True)
    qkv = torch.randn(B, bias.shape[0], win18 ** 2, 3 * C,
                      generator=gen).to("cuda", torch.bfloat16)
    _, k1_route, _ = routed(window_attention,
                            lambda: window_attention(qkv, bias, h))
    row.update(cublas_products_2blocks_ms=cuda_time_ms(products, iters=10),
               k1_long_2blocks_ms=2 * cuda_time_ms(
                   lambda: window_attention(qkv, bias, h)),
               k1_route=k1_route)
    st = stack_stage(seeded_blocks(gen, cfg, stage, 2, torch.bfloat16),
                     torch.bfloat16)
    policy, by_shape = k3_ops._k3_long_rows, {}
    order = ["plan"] + list(K3_LONG_BLOCKS)
    try:
        for choice in order + order[::-1]:
            k3_ops._k3_long_rows = (policy if choice == "plan"
                                    else lambda *_, c=choice: c)
            by_shape.setdefault(choice if choice == "plan" else
                                "R{}_parts{}".format(*choice), []).append(
                cuda_time_ms(lambda: st(x), iters=10))
    finally:
        k3_ops._k3_long_rows = policy
    row.update(plan_rows_parts=policy(st.window ** 2, C // h),
               ms_by_attention_block=by_shape)
    info(**row)
    return row


def k3_tile_times(gen, cfg: FiberConfig, stage: int, n: int, B: int,
                  timed: bool = True) -> Optional[dict]:
    """bf16 K3 over n seeded blocks of one stage timed under `_k3_plan`'s
    tiles and with each tile of `_K3_TILES` forced on every product (in
    place of `_k3_tile`), in the order plan, tiles, tiles reversed, plan:
    two times for each.  Untimed it only takes its draws from `gen`."""
    blocks = seeded_blocks(gen, cfg, stage, n, torch.bfloat16)
    st = stack_stage(blocks, torch.bfloat16)
    H, C = cfg.stage_resolution(stage)[0], cfg.stage_dim(stage)
    x = torch.randn(B, H, H, C, generator=gen).to("cuda", torch.bfloat16)
    if not timed:
        return None
    policy = k3_ops._k3_tile
    order = ["plan"] + list(k3_ops._K3_TILES)
    ms = {}
    try:
        for choice in order + order[::-1]:
            k3_ops._k3_tile = (policy if choice == "plan"
                               else lambda *_, t=choice: t)
            ms.setdefault("x".join(map(str, choice)) if choice != "plan"
                          else choice, []).append(
                cuda_time_ms(lambda: st(x), iters=10))
    finally:
        k3_ops._k3_tile = policy
    plan = k3_ops._k3_plan(B, H, H, C, st.params["fc1_w"].shape[1],
                           st.window, st.num_heads,
                           fused_swin_blocks.last_grid)
    row = dict(phase="k3_tiles", stage=stage + 1, blocks=n, B=B, plan=plan,
               ms_by_tiles=ms)
    info(**row)
    return row


def timed_wall(fn, reps: int = 5) -> list:
    """Host-clock ms of `reps` calls, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def k3_on_model(card: str, dtype: torch.dtype) -> dict:
    """Phase 10 at one dtype: the rerank trunk and the ITC image tower,
    each composed from the model's own modules with one K3 launch per
    stage run (parameters stacked once, outside the timed region), every
    launch on K3's route for the dtype (bf16 `tc`, fp32 `tc_f32`: the
    FIBER windows are N = 144, hd = 32), against the model's per-block
    forward."""
    cfg = FiberConfig.base(compute_dtype=dtype)
    n_img, n_txt, pair_batch = 4, 8, 16
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    swin = model.vit_model
    images, ids, masks = corpus(cfg, n_img, n_txt, SEED)
    img = torch.from_numpy(images).to("cuda", dtype)
    ids, masks = torch.from_numpy(ids).cuda(), torch.from_numpy(masks).cuda()
    n_pre = cfg.swin_depths[2] - (cfg.num_fuse_block - cfg.swin_depths[3])
    name = str(dtype).replace("torch.", "")
    route = "tc" if dtype == torch.bfloat16 else "tc_f32"
    result = {}
    with torch.inference_mode():
        trunk_stacks = stack_swin(swin, cfg.swin_depths[:2] + (n_pre,))
        tower_stacks = stack_swin(swin)

        def k3_trunk():
            return run_stacks(swin, trunk_stacks, img)

        def per_block_trunk():
            return model.encode_image_trunk(img)

        def k3_tower():
            return run_stacks(swin, tower_stacks, img)

        def per_block_tower():
            return swin(img)

        def counted(fn):
            torch.cuda.synchronize()
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            return out, (window_attention.launches,
                         fused_swin_blocks.launches)

        def itc_cls(feats):
            x = model.cross_modal_image_transform_itc(feats)
            return model._l2_normalize(model.cross_modal_image_pooler_itc(
                x.mean(dim=1, keepdim=True))).float()

        for what, k3_fn, ref_fn, expect in (
                ("k3_trunk", k3_trunk, per_block_trunk,
                 ((sum(cfg.swin_depths[:2]) + n_pre, 0), (0, 3))),
                ("k3_itc_tower", k3_tower, per_block_tower,
                 ((sum(cfg.swin_depths), 0), (0, 4)))):
            k3_fn(), ref_fn()                                 # warm-up
            ref, ref_counts = counted(ref_fn)
            out, k3_counts = counted(k3_fn)
            k3_routes = dict(fused_swin_blocks.route_launches)
            diff = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if what == "k3_trunk":
                text_pre = model.encode_text_pre(ids, masks)
                pair_img = torch.arange(n_img).repeat_interleave(n_txt)
                pair_txt = torch.arange(n_txt).repeat(n_img)
                scores = [retrieval._rank_pairs_cached(
                    model, t, text_pre, masks, pair_img, pair_txt,
                    pair_batch).cpu().numpy() for t in (ref, out)]
                scores_name = "rerank_scores"
            else:
                scores = [itc_cls(t).cpu().numpy() for t in (ref, out)]
                scores_name = "itc_cls_feats"
            score_diff = float(np.abs(scores[1] - scores[0]).max())
            row = dict(phase=what, dtype=name, batch=n_img,
                       launches_k1_k3=k3_counts,
                       k3_route_launches=k3_routes,
                       per_block_launches_k1_k3=ref_counts,
                       expected=expect, max_abs_diff=diff,
                       max_abs_ref=scale, rel_diff=diff / scale,
                       **{f"{scores_name}_max_abs_diff": score_diff,
                          f"{scores_name}_max_abs": float(
                              np.abs(scores[0]).max())})
            if what == "k3_trunk":
                row.update(
                    wall_ms_per_block=timed_wall(ref_fn),
                    wall_ms_k3=timed_wall(k3_fn),
                    profile_per_block=profile_share(
                        ref_fn, extra=(("k3", "fused_swin_blocks"),)),
                    profile_k3=profile_share(
                        k3_fn, extra=(("k3", "fused_swin_blocks"),)),
                    card=card)
            info(**row)
            if (ref_counts, k3_counts) != expect:
                raise AssertionError(f"{what}: launches (K1, K3) per block "
                                     f"{ref_counts}, through K3 {k3_counts}, "
                                     f"expected {expect}")
            if k3_routes[route] != k3_counts[1]:
                raise AssertionError(f"{what}: K3 launches by route "
                                     f"{k3_routes}, expected all "
                                     f"{k3_counts[1]} on {route}")
            if not np.isfinite(scores[1]).all():
                raise AssertionError(f"{what}: non-finite {scores_name}")
            if dtype == torch.float32 and not diff <= MODEL_RTOL * scale:
                raise AssertionError(f"{what}: fp32 through K3 differs from "
                                     f"the per-block path by {diff}")
            np.testing.assert_allclose(scores[1], scores[0], atol=5e-2,
                                       rtol=5e-2)
            result[what] = k3_counts[1]
            result[f"{what}_routes"] = k3_routes
    del model
    torch.cuda.empty_cache()
    return result


def check_k4(gen, B, H, W, window, h, hd, dtype, shifted,
             phase="k4_check", timed: bool = True) -> dict:
    """K4 against its plain version at one shape, on the route
    `_heads_route` gives, timed beside the plain version and SDPA on the
    same per-head operands."""
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    q, k, v = split_heads_qkv(qkv, h)
    t0 = time.perf_counter()
    out, route, splits = routed(
        window_attention_heads, lambda: window_attention_heads(q, k, v, bias))
    rows, parts = (window_attention_heads.last_rows,
                   window_attention_heads.last_parts)
    ref = window_attention_heads_reference(q, k, v, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    expect = wa_ops._heads_route(dtype, N, hd)
    # the long route's bound is K1's there: one ulp, or one probability
    # rounded apart at a tie (within_ulp_or_flip on the packed layout)
    packed = lambda t: t.transpose(2, 3).reshape(B, nW, N, h * hd)
    flip_ok = expect != "tc_long" or within_ulp_or_flip(
        packed(out), packed(ref), qkv, bias, h)
    again = (torch.equal(out, window_attention_heads(q, k, v, bias))
             if expect == "tc_long" else True)
    ok = (torch.allclose(out.float(), ref.float(), **TOL[dtype])
          and route == [expect] and flip_ok and again)
    row = dict(phase=phase, B=B, nW=nW, N=N, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), shift_mask=shifted,
               route=route, splits=splits, rows=rows, parts=parts,
               max_abs_err=err, within_ulp_or_flip=flip_ok,
               bit_equal_two_calls=again, ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K4 disagrees with its plain version or its "
                             f"route ({expect}): {row}")
    if not timed:
        info(**row)
        return row
    esz = qkv.element_size()
    nbytes = 4 * q.numel() * esz + bias_bytes(bias)   # q, k, v in; out
    flops = fwd_flops(B, nW, N, h, hd)
    mask = bias.expand(B, nW, h, N, N).reshape(B * nW, h, N, N).to(dtype)
    qs, ks, vs = (t.view(B * nW, h, N, hd) for t in (q, k, v))
    row.update(ms=cuda_time_ms(lambda: window_attention_heads(q, k, v, bias)),
               plain_ms=cuda_time_ms(
                   lambda: window_attention_heads_reference(q, k, v, bias)),
               library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=mask)),
               **bound(nbytes, flops, dtype))
    row["tflops"] = flops / row["ms"] / 1e9
    row["seconds"] = time.perf_counter() - t0
    info(**row)
    return row


def k1_k4_long_identity(cfg: FiberConfig) -> list:
    """Phase 17c: K1's and K4's long-window instances, both K1's routine
    (`attend_long_rows`) with its options off, on the same (window, head)s:
    K4's per-head output merged back to the packed layout equals K1's bit
    for bit at 576^2 stages 1 and 3 (bf16, B = K4_LONG_B, shifted), both on
    `tc_long`; then the same in fp32, both on FP32_FWD_ROUTE
    (`attend_f32`).
    Its inputs come from a generator of its own, so the other checks keep
    their draws."""
    gen = torch.Generator().manual_seed(SEED + 13)
    win, hd, rows = cfg.derived_window_size, 32, []
    for dtype, route in ((torch.bfloat16, "tc_long"),
                         (torch.float32, FP32_FWD_ROUTE)):
        for s in (0, 2):
            g, h = cfg.stage_resolution(s)[0], cfg.swin_num_heads[s]
            bias = swin_bias(gen, win, h, g, g, shifted=True)
            nW, N = bias.shape[0], bias.shape[2]
            qkv = torch.randn(K4_LONG_B, nW, N, 3 * h * hd,
                              generator=gen).to("cuda", dtype)
            q, k, v = split_heads_qkv(qkv, h)
            k1, k1_route, _ = routed(window_attention,
                                     lambda: window_attention(qkv, bias, h))
            k4, k4_route, _ = routed(
                window_attention_heads,
                lambda: window_attention_heads(q, k, v, bias))
            merged = k4.transpose(2, 3).reshape(K4_LONG_B, nW, N, h * hd)
            row = dict(phase="k1_k4_long_identity", stage=s + 1,
                       dtype=str(dtype).replace("torch.", ""), B=K4_LONG_B,
                       nW=nW, N=N, h=h, hd=hd, k1_route=k1_route,
                       k4_route=k4_route, bit_equal=torch.equal(merged, k1))
            info(**row)
            if (not row["bit_equal"] or k1_route != [route]
                    or k4_route != [route]):
                raise AssertionError(f"K1 and K4 at N = 324 differ: {row}")
            rows.append(row)
    return rows


def run_captioning(card: str) -> dict:
    """Phase 13: FIBER-Base captioning at 576^2 (`task_finetune_caption_mle`,
    seeded weights, fusion gates in [0.3, 0.7]).  bf16: `caption_images` on
    CAPTION_B images with beam CAPTION_BEAM and max_len CAPTION_MAX_LEN
    (the launch counts set to 0 just before it and read just after: K1
    once per Swin block of the one encode, every launch on the long-window
    route), its wall time, the encode's and the decode's, and one call
    under the profiler.  fp32: the cached greedy tokens against the
    full-prefix oracle's on the card, and the encode and the first decode
    step's logits on the card (K1 on `f32_tiled`) against the host's
    plain path at B = 1."""
    cfg = task_finetune_caption_mle()
    t0 = time.perf_counter()
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    info(phase="caption_model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()),
         image_size=cfg.image_size, window=cfg.derived_window_size,
         max_text_len=cfg.max_text_len)
    rng = np.random.default_rng(SEED + 2)
    S = cfg.image_size
    images = rng.standard_normal((CAPTION_B, S, S, 3)).astype(np.float32)
    img = torch.from_numpy(images).to("cuda", cfg.compute_dtype)

    def run():
        return caption.caption_images(model, img, BOS, EOS, PAD,
                                      max_len=CAPTION_MAX_LEN,
                                      beam_size=CAPTION_BEAM)

    run()                                             # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, scores = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = window_attention.launches
    routes = dict(window_attention.route_launches)
    rows, splits = window_attention.last_rows, window_attention.last_splits
    with torch.inference_mode():
        encode_ms = timed_wall(lambda: model.encode_image_caption(img), 3)
        emb = model.encode_image_caption(img)
        decode_ms = timed_wall(lambda: caption.beam_search_decode_cached(
            model, emb, BOS, EOS, PAD, CAPTION_MAX_LEN, CAPTION_BEAM), 3)
    prof = profile_share(run)
    ids_np, scores_np = ids.cpu().numpy(), scores.float().cpu().numpy()
    expect = sum(cfg.swin_depths)                     # one encode
    row = dict(phase="caption", card=card, dtype="bfloat16", batch=CAPTION_B,
               beam=CAPTION_BEAM, max_len=CAPTION_MAX_LEN, wall_ms=wall_ms,
               encode_wall_ms=encode_ms, decode_wall_ms=decode_ms,
               k1_launches=launches, expected_k1=expect, route_launches=routes,
               k1_rows=rows, k1_splits=splits, ids=ids_np.tolist(),
               scores=scores_np.tolist(), profile=prof)
    info(**row)
    if launches != expect or routes["tc_long"] != expect:
        raise AssertionError(f"caption_images launched K1 {launches} times "
                             f"({routes} by route), expected {expect}, all "
                             f"on the long-window route")
    if (ids_np.shape != (CAPTION_B, CAPTION_MAX_LEN)
            or not (ids_np[:, 0] == BOS).all()
            or not ((ids_np >= 0) & (ids_np < cfg.vocab_size)).all()
            or not np.isfinite(scores_np).all()):
        raise AssertionError(f"captions malformed: {ids_np}, {scores_np}")
    del model, emb
    torch.cuda.empty_cache()

    cfg32 = task_finetune_caption_mle(compute_dtype=torch.float32)
    gpu = FiberCoarse(cfg32, device="cuda", seed=SEED).eval()
    seeded_gates(gpu, SEED)
    bos = torch.full((1, 1), BOS, dtype=torch.long)
    with torch.inference_mode():
        reset_counts()
        emb = gpu.encode_image_caption(torch.from_numpy(images).cuda())
        launches32 = window_attention.launches
        routes32 = dict(window_attention.route_launches)
        cached = caption.greedy_decode_cached(gpu, emb, BOS, EOS, PAD,
                                              CAPTION_MAX_LEN).cpu().numpy()
        oracle = caption.greedy_decode(gpu, emb, BOS, EOS, PAD,
                                       CAPTION_MAX_LEN).cpu().numpy()
        caches = gpu.init_caption_cache(emb[:1], CAPTION_MAX_LEN)
        card_logits = gpu.decode_caption_step(bos.cuda(), 0, caches)[0].cpu()
        card_emb = emb[:1].cpu()
    del gpu, emb, caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = FiberCoarse(cfg32, device="cpu", seed=SEED).eval()
    seeded_gates(host, SEED)
    with torch.inference_mode():
        host_emb = host.encode_image_caption(torch.from_numpy(images[:1]))
        caches = host.init_caption_cache(host_emb, CAPTION_MAX_LEN)
        host_logits = host.decode_caption_step(bos, 0, caches)[0]
    host_seconds = time.perf_counter() - t0
    del host, caches
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    rel_logits, rel_emb = rel(card_logits, host_logits), rel(card_emb, host_emb)
    same = bool((cached == oracle).all())
    info(phase="caption_fp32", card=card, batch=CAPTION_B,
         cached_equals_oracle=same, ids=cached.tolist(),
         k1_launches=launches32, route_launches=routes32,
         logits_rel_err=rel_logits, image_embeds_rel_err=rel_emb,
         limit=MODEL_RTOL, host_seconds=host_seconds)
    if launches32 != expect or routes32[FP32_FWD_ROUTE] != expect:
        raise AssertionError(f"fp32 encode launched K1 {launches32} times "
                             f"({routes32}), expected {expect} on route "
                             f"{FP32_FWD_ROUTE}")
    if not same:
        raise AssertionError(f"fp32 cached greedy tokens differ from the "
                             f"oracle's: {cached} vs {oracle}")
    if not (rel_logits <= MODEL_RTOL and rel_emb <= MODEL_RTOL):
        raise AssertionError(f"caption card and host disagree in fp32: "
                             f"logits {rel_logits}, features {rel_emb}")
    return dict(k1=launches, routes=routes, wall_ms=wall_ms)


def vqa_at_576(card: str) -> dict:
    """Phase 14: the VQA preset (FIBER-Base at 576^2) fused forward once in
    bf16, its K1 launches counted: every Swin block, on the long-window
    route; the logits finite."""
    cfg = task_finetune_vqa()
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    images, ids, masks = corpus(cfg, 2, 2, SEED)
    with torch.inference_mode():
        x = (torch.from_numpy(images).to("cuda", cfg.compute_dtype),
             torch.from_numpy(ids).cuda(), torch.from_numpy(masks).cuda())
        reset_counts()
        out = model.infer(*x)
        logits = model.vqa_logits(out["cls_feats"]).float().cpu()
    launches = window_attention.launches
    routes = dict(window_attention.route_launches)
    expect = sum(cfg.swin_depths)
    ok = (tuple(logits.shape) == (2, cfg.vqav2_label_size)
          and bool(torch.isfinite(logits).all()))
    info(phase="vqa_576", card=card, image_size=cfg.image_size,
         k1_launches=launches, expected_k1=expect, route_launches=routes,
         logits_shape=list(logits.shape), finite=ok,
         max_abs_logit=logits.abs().max().item())
    if launches != expect or routes["tc_long"] != expect or not ok:
        raise AssertionError(f"VQA at 576^2: K1 {launches} launches "
                             f"({routes}), expected {expect} on the "
                             f"long-window route; logits ok: {ok}")
    del model
    torch.cuda.empty_cache()
    return dict(k1=launches, routes=routes)


def vqa_batch(cfg: FiberConfig, B: int, seed: int) -> dict:
    """A numpy VQA batch: the corpus's images and questions, and soft
    answer scores (about 1% of the answers scored, in (0, 1])."""
    images, ids, masks = corpus(cfg, B, B, seed)
    rng = np.random.default_rng(seed + 3)
    targets = np.where(rng.random((B, cfg.vqav2_label_size)) < 0.01,
                       rng.random((B, cfg.vqav2_label_size)), 0.0)
    return {"image": images, "text_ids": ids, "text_masks": masks,
            "vqa_targets": targets.astype(np.float32)}


def full_swin_launches(cfg: FiberConfig) -> tuple:
    """(K1, K2) launches of one step whose loss every Swin block's output
    reaches: a VQA step (the loss reads both towers' cls features) or a
    caption-MLE step (the decoder reads the last stage's output).  K2 in
    each block, K1 in each block and again in each recompute under
    remat."""
    blocks = sum(cfg.swin_depths)
    return blocks + (blocks if cfg.remat else 0), blocks


def run_vqa_training(card: str) -> dict:
    """Phase 15a: VQA_STEPS full-width bf16 VQA finetuning steps at 576^2
    (`task_finetune_vqa`, warmup 0) on one seeded batch of VQA_B, each
    with the launch counts set to 0 before it and read after it; then one
    step under the profiler."""
    cfg = task_finetune_vqa(warmup_steps=0)
    t0 = time.perf_counter()
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    info(phase="vqa_576_model", seconds=time.perf_counter() - t0,
         image_size=cfg.image_size, window=cfg.derived_window_size,
         remat=cfg.remat, batch=VQA_B, answers=cfg.vqav2_label_size,
         learning_rate=cfg.learning_rate, lr_mult_head=cfg.lr_mult_head)
    batch = trainer.to_device(vqa_batch(cfg, VQA_B, SEED + 4))
    expect_k1, expect_k2 = full_swin_launches(cfg)
    steps = []
    for step in range(VQA_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = window_attention.launches, window_attention_bwd.launches
        routes1 = dict(window_attention.route_launches)
        routes2 = dict(window_attention_bwd.route_launches)
        row = dict(phase="vqa_576_train", step=step, seconds=seconds,
                   card=card,
                   max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   k1_launches=k1, k2_launches=k2, expected_k1=expect_k1,
                   expected_k2=expect_k2, k1_route_launches=routes1,
                   k2_route_launches=routes2, k2_plan=list(
                       window_attention_bwd.last_plan),
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        if ((k1, k2) != (expect_k1, expect_k2) or routes1["tc_long"] != k1
                or routes2["tc_long"] != k2):
            raise AssertionError(f"VQA step launched K1 {k1} and K2 {k2} "
                                 f"times ({routes1}, {routes2} by route), "
                                 f"expected {expect_k1} and {expect_k2}, all "
                                 f"on the long-window tensor-core route")
        if step == 0:
            checked = [(n, p.grad) for n, p in trainer.model.named_parameters()
                       if n.endswith(GRAD_CHECKED + ("attn.qkv.weight",))]
            bad = [n for n, g in checked
                   if not (torch.isfinite(g).all() and g.abs().max() > 0)]
            info(phase="vqa_576_grads", checked=len(checked), bad=bad)
            if bad or not checked:
                raise AssertionError(f"zero or non-finite gradients: {bad}")
    vqa = [r["vqa_loss"] for r in steps]
    info(phase="vqa_576_losses", steps=VQA_STEPS, vqa_first=vqa[0],
         vqa_last=vqa[-1], vqa_losses=vqa)
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"non-finite losses: {steps}")
    if not vqa[-1] < vqa[0]:
        raise AssertionError(f"the VQA loss did not fall: {vqa}")
    # K2's two kernels apart: the row kernel (dq, dbias, the statistics)
    # and the column kernel (dk, dv)
    prof = profile_share(lambda: trainer.train_step(batch), extra=(
        ("k2_rows", "window_attention_bwd_rows"),
        ("k2_cols", "window_attention_bwd_cols")))
    info(phase="vqa_576_profile", card=card, **prof)
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"],
                k2_routes=steps[-1]["k2_route_launches"],
                k2_profile={k: prof[k] for k in ("k2_ms", "k2_rows_ms",
                                                 "k2_cols_ms")})


def vqa_grads_card_vs_host(card: str) -> None:
    """Phase 15b: the VQA preset at 576^2 in fp32, dropout and drop-path 0,
    B = 1: gradients of the VQA loss on the card (K1 and K2 on their fp32
    routes, each launch counted) against the host's plain path,
    each checked tensor within GRAD_RTOL of its max-abs."""
    cfg = task_finetune_vqa(compute_dtype=torch.float32, drop_rate=0.0,
                            swin_drop_path_rate=0.0)
    data = vqa_batch(cfg, 1, SEED + 5)
    picked = {f"vit_model.layers.{s}.blocks.{b}.attn.qkv.weight"
              for s, depth in enumerate(cfg.swin_depths) for b in (0, depth - 1)}
    grads, losses, counts, routes = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = FiberCoarse(cfg, device=dev, seed=SEED, for_training=True)
        seeded_gates(model, SEED)
        b = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        reset_counts()
        loss = coarse.compute_vqa(model, b)["vqa_loss"]
        loss.backward()
        counts[dev] = (window_attention.launches, window_attention_bwd.launches)
        routes[dev] = (window_attention.route_launches[FP32_FWD_ROUTE],
                       window_attention_bwd.route_launches[FP32_ROUTE])
        losses[dev] = float(loss.detach())
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters()
                      if n.endswith(GRAD_CHECKED) or n in picked}
        info(phase="fp32_grad_576_pass", device=dev,
             seconds=time.perf_counter() - t0, loss=losses[dev],
             k1_launches=counts[dev][0], k2_launches=counts[dev][1])
        del model, loss
        torch.cuda.empty_cache()
    rel = {n: ((grads["cuda"][n] - g).abs().max() / g.abs().max()).item()
           for n, g in grads["cpu"].items()}
    worst = max(rel, key=lambda n: rel[n] if np.isfinite(rel[n]) else np.inf)
    expect = full_swin_launches(cfg)
    info(phase="fp32_grad_576", card=card, tensors=len(rel),
         worst_rel_err=rel[worst], worst_tensor=worst, limit=GRAD_RTOL,
         loss_card=losses["cuda"], loss_host=losses["cpu"],
         launches=counts["cuda"], long_route_launches=routes["cuda"],
         expected_launches=expect)
    if (counts["cuda"] != expect or routes["cuda"] != expect
            or counts["cpu"] != (0, 0)):
        raise AssertionError(f"launches {counts} ({routes} on K1's route "
                             f"{FP32_FWD_ROUTE} and K2's {FP32_ROUTE}): "
                             f"expected (K1, K2) {expect} there and nothing "
                             f"on the host")
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"card and host gradients differ: {worst} "
                             f"relative error {rel[worst]}")
    if not abs(losses["cuda"] - losses["cpu"]) <= GRAD_RTOL * abs(losses["cpu"]):
        raise AssertionError(f"card and host losses differ: {losses}")


def k3_tower_576(card: str) -> dict:
    """Phase 17b: the ITC image tower of the 576^2 caption preset (18 x 18
    windows, N = 324, in every block) composed from the model's own modules
    with one K3 launch per stage, in bf16, against `vit_model`'s per-block
    forward (K1 on the long-window route): every K3 launch on the
    long-window tensor-core route (`_k3_route` beyond N = 144) and no K1,
    the pooled ITC features within 5e-2, both walls, and each stage's K3
    launch timed on its own input beside that stage's blocks run one by
    one (`stages`).  Its launches are the main-path count of the
    long-window K3 row."""
    cfg = task_finetune_caption_mle()
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    swin = model.vit_model
    rng = np.random.default_rng(SEED + 6)
    S = cfg.image_size
    img = torch.from_numpy(rng.standard_normal((K3_LONG_B, S, S, 3)).astype(
        np.float32)).to("cuda", cfg.compute_dtype)

    def itc_cls(feats):
        x = model.cross_modal_image_transform_itc(feats)
        return model._l2_normalize(model.cross_modal_image_pooler_itc(
            x.mean(dim=1, keepdim=True))).float().cpu().numpy()

    with torch.inference_mode():
        stacks = stack_swin(swin)
        ref = swin(img)
        torch.cuda.synchronize()
        reset_counts()
        out = run_stacks(swin, stacks, img)
        torch.cuda.synchronize()
        k3, k1 = fused_swin_blocks.launches, window_attention.launches
        routes = dict(fused_swin_blocks.route_launches)
        wall = timed_wall(lambda: run_stacks(swin, stacks, img), 3)
        wall_per_block = timed_wall(lambda: swin(img), 3)
        feats = [itc_cls(t) for t in (ref, out)]
        stages, x = [], swin.embed(img)
        for s, stack in enumerate(stacks):
            blocks = swin.layers[s].blocks
            stages.append(dict(
                stage=s + 1, blocks=len(blocks), tokens=list(x.shape[1:3]),
                k3_ms=cuda_time_ms(lambda x=x, st=stack: st(x), iters=5),
                per_block_ms=cuda_time_ms(
                    lambda x=x, b=blocks: run_blocks(b, x), iters=5)))
            x = stack(x)
            if s < len(stacks) - 1:
                x = swin.layers[s].downsample(x)
    diff = float(np.abs(feats[1] - feats[0]).max())
    row = dict(phase="k3_itc_tower_576", card=card, batch=K3_LONG_B,
               k3_launches=k3, k1_launches=k1, k3_route_launches=routes,
               expected_k3=len(stacks), itc_cls_feats_max_abs_diff=diff,
               wall_ms_k3=wall, wall_ms_per_block=wall_per_block,
               stages=stages, finite=bool(np.isfinite(feats[1]).all()))
    info(**row)
    if (k3, k1) != (len(stacks), 0) or routes["tc_long"] != k3:
        raise AssertionError(f"576^2 tower: K3 {k3} ({routes}), K1 {k1} "
                             f"launches, expected {len(stacks)} K3 on the "
                             f"long-window tensor-core route and no K1")
    if not row["finite"]:
        raise AssertionError("576^2 tower through K3: non-finite features")
    np.testing.assert_allclose(feats[1], feats[0], atol=5e-2, rtol=5e-2)
    del model
    torch.cuda.empty_cache()
    return dict(k3=k3, routes=routes, stages=stages)


def k4_tail_576(card: str) -> dict:
    """Phase 17d: `fiber_torch.tools.profile_tail` on the 576^2 caption
    preset (the tail's stage 3 in four 18 x 18 windows, N = 324) at batch
    K4_LONG_B, bf16: K4 on the long-window tensor-core route
    (`_heads_route` beyond N = 144); its launches are the main-path count
    of the long-window K4 row.  Then the same preset in fp32 (two timed
    calls a component): K4 on FP32_FWD_ROUTE, the main-path count of the fp32
    K4 row."""
    reset_counts()
    tail32 = profile_tail.run(task_finetune_caption_mle(
        compute_dtype=torch.float32), batch=K4_LONG_B, device="cuda",
        iters=2, seed=SEED)
    k4_32 = window_attention_heads.launches
    routes32 = dict(window_attention_heads.route_launches)
    info(phase="profile_tail_576_fp32", card=card, k4_launches=k4_32,
         k4_route_launches=routes32,
         ms={r["component"]: r["ms"] for r in tail32})
    if k4_32 == 0 or routes32[FP32_FWD_ROUTE] != k4_32:
        raise AssertionError(f"profile_tail at 576^2 in fp32: K4 {k4_32} "
                             f"launches ({routes32}), expected all on route "
                             f"{FP32_FWD_ROUTE}")
    reset_counts()
    tail = profile_tail.run(task_finetune_caption_mle(), batch=K4_LONG_B,
                            device="cuda", iters=5, seed=SEED)
    k4 = window_attention_heads.launches
    routes = dict(window_attention_heads.route_launches)
    for row in tail:
        info(phase="profile_tail_576", card=card, **row)
    info(phase="profile_tail_576_routes", k4_launches=k4,
         k4_route_launches=routes,
         k1_route_launches=dict(window_attention.route_launches))
    if ([r["component"] for r in tail] != list(profile_tail.COMPONENTS)
            or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in tail)):
        raise AssertionError(f"profile_tail at 576^2: {tail}")
    if k4 == 0 or routes["tc_long"] != k4:
        raise AssertionError(f"profile_tail at 576^2: K4 {k4} launches "
                             f"({routes}), expected all on route tc_long")
    return dict(k4=k4, routes=routes, k4_fp32=k4_32, routes_fp32=routes32)


def caption_batch(cfg: FiberConfig, B: int, seed: int) -> dict:
    """A numpy caption batch: the corpus's images and texts as captions,
    BOS first, EOS last before any PAD."""
    images, ids, masks = corpus(cfg, B, B, seed)
    ids[:, 0] = BOS
    ids[np.arange(B), masks.sum(1) - 1] = EOS
    return {"image": images, "text_ids": ids, "text_masks": masks}


def counted_step(fn) -> tuple:
    """fn()'s result, its seconds, peak GiB, and the K1 / K2 launches and
    launches by route, the counts set to 0 just before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            (window_attention.launches, window_attention_bwd.launches),
            (dict(window_attention.route_launches),
             dict(window_attention_bwd.route_launches)))


def check_long_launches(what: str, launches, routes, expect) -> None:
    """Every K1 and K2 launch of a 576^2 step on the long-window route, as
    many as `expect`."""
    if (tuple(launches) != tuple(expect) or routes[0]["tc_long"] != expect[0]
            or routes[1]["tc_long"] != expect[1]):
        raise AssertionError(f"{what} launched (K1, K2) {launches} ({routes} "
                             f"by route), expected {expect}, all on the "
                             f"long-window tensor-core route")


def run_caption_mle_training(card: str) -> dict:
    """Phase 18: CAPTION_STEPS bf16 caption-MLE finetuning steps at 576^2
    (`task_finetune_caption_mle`, full width and depth, max_text_len 50,
    warmup 0, lr 1e-4) through `CoarseTrainer.train_step` on one seeded
    batch of CAPTION_TRAIN_B, each with its launch counts by route; after
    CKPT_AFTER steps a `CheckpointManager` save, restored into a fresh
    trainer, and the next step taken by both with bit-equal losses
    (`caption_checkpoint`); then one profiled step."""
    cfg = task_finetune_caption_mle(compute_dtype=torch.bfloat16,
                                    warmup_steps=0, learning_rate=1e-4)
    t0 = time.perf_counter()
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    info(phase="caption_mle_576_model", seconds=time.perf_counter() - t0,
         image_size=cfg.image_size, window=cfg.derived_window_size,
         max_text_len=cfg.max_text_len, remat=cfg.remat,
         batch=CAPTION_TRAIN_B, learning_rate=cfg.learning_rate,
         dropout=cfg.drop_rate, drop_path=cfg.swin_drop_path_rate)
    batch = trainer.to_device(caption_batch(cfg, CAPTION_TRAIN_B, SEED + 7))
    expect = full_swin_launches(cfg)
    steps, mgr = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for step in range(CAPTION_STEPS):
            metrics, seconds, gib, launches, routes = counted_step(
                lambda: trainer.train_step(batch))
            row = dict(phase="caption_mle_576_train", step=step,
                       seconds=seconds, card=card, max_memory_gib=gib,
                       k1_launches=launches[0], k2_launches=launches[1],
                       expected=expect, k1_route_launches=routes[0],
                       k2_route_launches=routes[1],
                       **{k: float(v) for k, v in metrics.items()})
            info(**row)
            steps.append(row)
            check_long_launches("caption MLE step", launches, routes, expect)
            if step + 1 == CKPT_AFTER:
                mgr = CheckpointManager(
                    tmp, max_to_keep=1,
                    best_metric_name="caption_mle_accuracy")
                t0 = time.perf_counter()
                mgr.save(trainer.step, trainer.state_dict(),
                         {k: float(v) for k, v in metrics.items()})
                save_s = time.perf_counter() - t0
            elif step == CKPT_AFTER:
                t0 = time.perf_counter()
                fresh = CoarseTrainer(cfg, device="cuda", seed=SEED + 1)
                fresh.load_state_dict(mgr.restore())
                restore_s = time.perf_counter() - t0
                again = fresh.train_step(batch)
                same = {k: bool(torch.equal(metrics[k], again[k]))
                        for k in metrics}
                info(phase="caption_checkpoint", card=card,
                     saved_step=mgr.latest_step(), save_seconds=save_s,
                     restore_seconds=restore_s, best=mgr.best_value(),
                     bit_equal=same,
                     original={k: float(v) for k, v in metrics.items()},
                     restored={k: float(v) for k, v in again.items()})
                del fresh
                torch.cuda.empty_cache()
                if not all(same.values()):
                    raise AssertionError(f"the step after a restore differs: "
                                         f"{same}")
    mle = [r["caption_mle_loss"] for r in steps]
    info(phase="caption_mle_576_losses", steps=CAPTION_STEPS,
         caption_mle_losses=mle,
         accuracies=[r["caption_mle_accuracy"] for r in steps])
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"non-finite losses: {steps}")
    if not mle[-1] < mle[0]:
        raise AssertionError(f"the caption MLE loss did not fall: {mle}")
    prof = profile_share(lambda: trainer.train_step(batch))
    info(phase="caption_mle_576_profile", card=card, **prof)
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"],
                k2_routes=steps[-1]["k2_route_launches"])


def run_caption_gold(card: str) -> None:
    """Phase 19: GOLD_STEPS bf16 steps of `compute_caption_gold` at 576^2
    (`task_finetune_caption_gold`, warmup 0) on one seeded batch: the
    student of a `CoarseTrainer` with dropout, the gold copy a frozen
    `FiberCoarse` copied from the student before step 1 and refreshed
    before the last step; backward, then the trainer's own AdamW update.
    Finite losses, no gradient on the gold copy, K1 in the student's
    forward and recompute and in the gold forward, K2 in every block."""
    cfg = task_finetune_caption_gold(warmup_steps=0)
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    gold = FiberCoarse(cfg, device="cuda", seed=SEED, for_training=True)
    gold.requires_grad_(False).eval()
    batch = trainer.to_device(caption_batch(cfg, CAPTION_TRAIN_B, SEED + 8))
    k1, k2 = full_swin_launches(cfg)
    expect = (k1 + sum(cfg.swin_depths), k2)      # and the gold forward

    def step():
        for p in trainer.params:
            p.grad.zero_()
        out = caption.compute_caption_gold(trainer.model, gold, batch,
                                           pad_id=PAD, train=True)
        out["caption_gold_loss"].backward()
        trainer._update()
        return out

    for i in range(GOLD_STEPS):
        if i in (0, GOLD_STEPS - 1):                  # copy, then refresh
            gold.load_state_dict(trainer.model.state_dict())
        out, seconds, gib, launches, routes = counted_step(step)
        row = dict(phase="caption_gold_576", step=i, seconds=seconds,
                   card=card, max_memory_gib=gib, k1_launches=launches[0],
                   k2_launches=launches[1], expected=expect,
                   k1_route_launches=routes[0], k2_route_launches=routes[1],
                   gold_grads=sum(p.grad is not None
                                  for p in gold.parameters()),
                   **{k: float(v.detach()) for k, v in out.items()})
        info(**row)
        check_long_launches("gold step", launches, routes, expect)
        if row["gold_grads"] or not np.isfinite(row["caption_gold_loss"]):
            raise AssertionError(f"gold step: {row}")
    del trainer, gold, batch
    torch.cuda.empty_cache()


def run_scst(card: str) -> dict:
    """Phase 20: one SCST step at 576^2 (`task_finetune_caption_cider`,
    warmup 0): `compute_caption_cider` on SCST_B images with SCST_SAMPLES
    samples each of SCST_MAX_LEN tokens (Gumbel draws from a seeded device
    generator), rewards from the port's CiderD over SCST_REFS seeded
    reference captions per image; backward and the trainer's update.  K1
    in the sampling encode and in the loss's encode (no dropout, so no
    recompute), K2 in every block."""
    cfg = task_finetune_caption_cider(warmup_steps=0)
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    batch = trainer.to_device(caption_batch(cfg, SCST_B, SEED + 9))
    rng = np.random.default_rng(SEED + 10)
    refs_per_image = [[list(rng.integers(4, cfg.vocab_size,
                                         rng.integers(8, 16)))
                       for _ in range(SCST_REFS)] for _ in range(SCST_B)]
    scorer = CiderD({b * SCST_SAMPLES + k: refs_per_image[b]
                     for b in range(SCST_B) for k in range(SCST_SAMPLES)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    blocks = sum(cfg.swin_depths)
    expect = (2 * blocks, blocks)

    def detok(row):
        return [int(t) for t in row if t not in (BOS, EOS, PAD)]

    def step():
        for p in trainer.params:
            p.grad.zero_()
        out = caption.compute_caption_cider(
            trainer.model, batch, scorer, detok, gen, bos_id=BOS,
            eos_id=EOS, pad_id=PAD, max_len=SCST_MAX_LEN,
            num_samples=SCST_SAMPLES, mask_token_id=cfg.vocab_size - 1)
        out["caption_cider_loss"].backward()
        trainer._update()
        return out

    out, seconds, gib, launches, routes = counted_step(step)
    # the scorer's own check: a reference caption against its image's refs
    ref_reward = scorer.score({0: refs_per_image[0][0]})[0]
    loss = float(out["caption_cider_loss"])
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in trainer.params)
    row = dict(phase="scst_576", card=card, batch=SCST_B,
               samples=SCST_SAMPLES, max_len=SCST_MAX_LEN, seconds=seconds,
               max_memory_gib=gib, k1_launches=launches[0],
               k2_launches=launches[1], expected=expect,
               k1_route_launches=routes[0], k2_route_launches=routes[1],
               caption_cider_loss=loss, mean_reward=out["mean_reward"],
               reference_reward=ref_reward, grads_finite=grads_finite)
    info(**row)
    check_long_launches("SCST step", launches, routes, expect)
    if not (np.isfinite(loss) and 0.0 <= out["mean_reward"] <= 10.0
            and 0.0 < ref_reward <= 10.0 and grads_finite):
        raise AssertionError(f"SCST step: {row}")
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=launches[0], k2=launches[1], routes=routes)


def caption_grads_card_vs_host(card: str) -> None:
    """Phase 21: the caption-MLE preset at 576^2 in fp32, dropout and
    drop-path 0, B = 1: gradients of the caption MLE on the card (K1 on
    `f32_tiled`, K2 on `tc_f32`, each launch counted) against the host's
    plain path, each checked tensor within GRAD_RTOL of its max-abs."""
    cfg = task_finetune_caption_mle(compute_dtype=torch.float32,
                                    drop_rate=0.0, swin_drop_path_rate=0.0)
    data = caption_batch(cfg, 1, SEED + 12)
    picked = {f"vit_model.layers.{s}.blocks.{b}.attn.qkv.weight"
              for s, depth in enumerate(cfg.swin_depths) for b in (0, depth - 1)}
    picked |= {"mlm_score.bias", "cross_modal_att_layers.6.weight"}
    grads, losses, counts, routes, unused = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = FiberCoarse(cfg, device=dev, seed=SEED, for_training=True)
        seeded_gates(model, SEED)
        b = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        reset_counts()
        loss = coarse.compute_caption_mle(model, b)["caption_mle_loss"]
        loss.backward()
        counts[dev] = (window_attention.launches, window_attention_bwd.launches)
        routes[dev] = (window_attention.route_launches[FP32_FWD_ROUTE],
                       window_attention_bwd.route_launches[FP32_ROUTE])
        losses[dev] = float(loss.detach())
        # the Swin blocks' i2t gates take no part in captioning: no grad
        checked = [(n, p) for n, p in model.named_parameters()
                   if n.endswith(GRAD_CHECKED) or n in picked]
        unused[dev] = sorted(n for n, p in checked if p.grad is None)
        grads[dev] = {n: p.grad.detach().cpu() for n, p in checked
                      if p.grad is not None}
        info(phase="fp32_grad_caption_576_pass", device=dev,
             seconds=time.perf_counter() - t0, loss=losses[dev],
             k1_launches=counts[dev][0], k2_launches=counts[dev][1])
        del model, loss
        torch.cuda.empty_cache()
    rel = {n: ((grads["cuda"][n] - g).abs().max() / g.abs().max()).item()
           for n, g in grads["cpu"].items()}
    worst = max(rel, key=lambda n: rel[n] if np.isfinite(rel[n]) else np.inf)
    expect = full_swin_launches(cfg)
    info(phase="fp32_grad_caption_576", card=card, tensors=len(rel),
         without_grad=len(unused["cpu"]),
         worst_rel_err=rel[worst], worst_tensor=worst, limit=GRAD_RTOL,
         loss_card=losses["cuda"], loss_host=losses["cpu"],
         launches=counts["cuda"], long_route_launches=routes["cuda"],
         expected_launches=expect)
    if (counts["cuda"] != expect or routes["cuda"] != expect
            or counts["cpu"] != (0, 0)):
        raise AssertionError(f"launches {counts} ({routes} on K1's route "
                             f"{FP32_FWD_ROUTE} and K2's {FP32_ROUTE}): "
                             f"expected (K1, K2) {expect} there and nothing "
                             f"on the host")
    if (unused["cuda"] != unused["cpu"]
            or any(n.endswith("relative_position_bias_table")
                   for n in unused["cpu"])):
        raise AssertionError(f"tensors without a gradient: {unused}")
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"card and host gradients differ: {worst} "
                             f"relative error {rel[worst]}")
    if not abs(losses["cuda"] - losses["cpu"]) <= GRAD_RTOL * abs(losses["cpu"]):
        raise AssertionError(f"card and host losses differ: {losses}")


# ---------------------------------------------------------------------------
# the coarse training loop through the CLI (fiber_torch.cli)
# ---------------------------------------------------------------------------
def mixed_images(seed: int, staging: int, n: int = PP_B) -> list:
    """`n` seeded uint8 (h, w, 3) arrays of mixed native sizes, a quarter of
    them larger than the staging buffer, smoothed along both axes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        big = i % 4 == 3
        h, w = (int(rng.integers(staging + 1, staging * 5 // 4)) if big
                else int(rng.integers(staging // 3, staging)),
                int(rng.integers(staging // 3, staging)))
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        for ax in (0, 1):
            arr = (np.roll(arr, 1, ax) + arr + np.roll(arr, -1, ax)) / 3
        out.append(arr.astype(np.uint8))
    return out


def device_preprocess(card: str) -> dict:
    """Phase 23: `stage_host_batch` of PP_B seeded numpy images (no PIL) at
    each preset's staging size, then the eval and the training pipeline on
    the card (the training draws made once there) against the same
    functions on the host, fp32, TF32 off, the error on the 0-255 scale;
    each pipeline's device time for one batch in bf16."""
    std255 = torch.tensor(dtf.IMAGENET_DEFAULT_STD) * 255.0
    rows = {}
    for out, staging in PP_SIZES:
        imgs = mixed_images(SEED + out, staging)
        t0 = time.perf_counter()
        staged, sizes = dtf.stage_host_batch(imgs, staging)
        stage_ms = (time.perf_counter() - t0) * 1e3
        host = (torch.from_numpy(staged), torch.from_numpy(sizes))
        card_in = tuple(t.cuda() for t in host)
        draws = dtf.draw_train_params(
            card_in[1], torch.Generator("cuda").manual_seed(SEED))
        got = {"eval": dtf.device_eval_preprocess(*card_in, out,
                                                  dtype=torch.float32),
               "train": dtf.apply_train_preprocess(card_in[0], draws, out,
                                                   dtype=torch.float32)}
        want = {"eval": dtf.device_eval_preprocess(*host, out,
                                                   dtype=torch.float32),
                "train": dtf.apply_train_preprocess(
                    host[0], {k: v.cpu() for k, v in draws.items()}, out,
                    dtype=torch.float32)}
        err = {k: float(((got[k].cpu() - want[k]).abs() * std255).max())
               for k in got}
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())

        def eval_once():
            dtf.device_eval_preprocess(*card_in, out)

        def train_once():
            dtf.device_train_preprocess(
                *card_in, torch.Generator("cuda").manual_seed(SEED), out)

        row = dict(phase="device_preprocess", card=card, out=out,
                   staging=staging, batch=PP_B,
                   native_sizes=sizes.tolist(), stage_host_ms=stage_ms,
                   max_abs_err_255=err, atol_255=PP_ATOL_255,
                   eval_ms=cuda_time_ms(eval_once),
                   train_ms=cuda_time_ms(train_once),
                   ops=draws["ops"].tolist(), flip=draws["flip"].tolist())
        info(**row)
        rows[out] = row
        if not finite or max(err.values()) > PP_ATOL_255:
            raise AssertionError(f"device preprocessing at {out}: card and "
                                 f"host differ by {err} (0-255 scale)")
    if any(m in sys.modules for m in ("PIL", "pyarrow", "transformers")):
        raise AssertionError("the smoke run imported PIL, pyarrow or "
                             "transformers")
    torch.cuda.empty_cache()
    return rows


def launch_counts() -> tuple:
    """(K1, K2) launches and launches by route so far."""
    return ((window_attention.launches, window_attention_bwd.launches),
            (dict(window_attention.route_launches),
             dict(window_attention_bwd.route_launches)))


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def recorded_cli(profile_step: int = -1):
    """While the CLI runs: each `CoarseTrainer.train_step` timed between
    device syncs with its K1 / K2 launches by route (step `profile_step`
    under the profiler instead), each checkpoint save and restore timed,
    and the CLI's printed lines kept."""
    rec = {"steps": [], "save_s": [], "restore_s": [], "profile": None}
    step, save, restore = (CoarseTrainer.train_step, CheckpointManager.save,
                           CheckpointManager.restore)

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return call

    def counted(self, batch, generator=None):
        rec["trainer"] = self
        (k0, routes0) = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.step == profile_step:
            out = []
            rec["profile"] = profile_share(
                lambda: out.append(step(self, batch, generator)))
            metrics = out[0]
        else:
            metrics = step(self, batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (k, routes) = launch_counts()
        rec["steps"].append(dict(
            step=self.step - 1, seconds=seconds,
            k1_launches=k[0] - k0[0], k2_launches=k[1] - k0[1],
            k1_route_launches={r: routes[0][r] - routes0[0][r]
                               for r in routes[0]},
            k2_route_launches={r: routes[1][r] - routes0[1][r]
                               for r in routes[1]},
            **{n: float(v) for n, v in metrics.items()}))
        return metrics

    tee = Tee(sys.stdout)
    CoarseTrainer.train_step = counted
    CheckpointManager.save = timed(save, "save_s")
    CheckpointManager.restore = timed(restore, "restore_s")
    try:
        with contextlib.redirect_stdout(tee):
            yield rec
    finally:
        CoarseTrainer.train_step = step
        CheckpointManager.save, CheckpointManager.restore = save, restore
        rec["printed"] = tee.kept.getvalue()


def run_cli(phase: str, card: str, argv: list, expect: tuple,
            route: str, profile_step: int = -1) -> dict:
    """`fiber_torch.cli.main(argv)` on the card with the launch counts set to
    0 just before it and read just after: every step's losses (finite),
    seconds and K1 / K2 launches (`expect` a step, all on `route`), the
    CLI's ex/s lines, the checkpoint save and restore seconds and the peak
    memory of the run; step `profile_step` under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recorded_cli(profile_step) as rec:
        metrics = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches, routes = launch_counts()
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for row in rec["steps"]:
        info(phase=f"{phase}_step", card=card,
             profiled=row["step"] == profile_step, **row)
    if rec["profile"] is not None:
        info(phase=f"{phase}_profile", card=card, step=profile_step,
             **rec["profile"])
    lines = [ln for ln in rec["printed"].splitlines()
             if ln.startswith(("step ", "resumed from"))]
    info(phase=phase, card=card, argv=argv, seconds=seconds,
         max_memory_gib=gib, k1_launches=launches[0],
         k2_launches=launches[1], k1_route_launches=routes[0],
         k2_route_launches=routes[1], expected_per_step=expect, route=route,
         save_seconds=rec["save_s"], restore_seconds=rec["restore_s"],
         cli_lines=lines, last_metrics=metrics)
    bad = [r for r in rec["steps"]
           if (r["k1_launches"], r["k2_launches"]) != tuple(expect)
           or r["k1_route_launches"][route] != expect[0]
           or r["k2_route_launches"][route] != expect[1]]
    if bad or not rec["steps"]:
        raise AssertionError(f"{phase}: steps {[r['step'] for r in bad]} "
                             f"did not launch K1 / K2 {expect} times, all on "
                             f"{route}")
    if not all(np.isfinite(r[k]) for r in rec["steps"] for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"{phase}: non-finite losses {rec['steps']}")
    torch.cuda.empty_cache()
    return dict(steps=rec["steps"], lines=lines, save_s=rec["save_s"],
                restore_s=rec["restore_s"], gib=gib, launches=launches,
                routes=routes, trainer=rec.get("trainer"))


def cli_pretrain(card: str, meanwhile=None) -> dict:
    """Phase 24: `python -m fiber_torch.cli` as a user runs it, on
    `pretrain_mlm_itm_itc` at FIBER-Base 384^2 (full width and depth, bf16
    over fp32 parameters, the 4096-slot queue, remat), synthetic data,
    B = CLI_B: CLI_STEPS steps saving every CLI_CKPT_EVERY into a temporary
    directory, then `--resume` to CLI_RESUME_STEPS, which must start at
    step CLI_STEPS; 143 K1 and 71 K2 launches a step, all on `tc`.  Then
    phases 53-54 over that directory, `meanwhile()` (when given) in this
    process while their tools run; what it returned under "meanwhile"."""
    cfg = task_pretrain_mlm_itm_itc()
    expect = expected_launches(cfg, forwards=3)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--task", "pretrain_mlm_itm_itc", "--data", "synthetic",
                "--per-device-batch", str(CLI_B), "--ckpt-every",
                str(CLI_CKPT_EVERY), "--output-dir", tmp, "--log-every", "1",
                "--seed", str(SEED)]
        first = run_cli("cli_pretrain", card,
                        argv + ["--steps", str(CLI_STEPS)], expect, "tc",
                        profile_step=CLI_STEPS - 1)
        saved = sorted(CheckpointManager(tmp).steps())
        resumed = run_cli("cli_pretrain_resume", card,
                          argv + ["--steps", str(CLI_RESUME_STEPS),
                                  "--resume"], expect, "tc")
        after = sorted(CheckpointManager(tmp).steps())
        # phases 53-54: the tools over these checkpoints and a NaN dump
        got = cli_tools_round(card, tmp, resumed["trainer"], meanwhile)
    started = [ln for ln in resumed["lines"] if ln.startswith("resumed")]
    steps = [r["step"] for r in resumed["steps"]]
    info(phase="cli_pretrain_checkpoints", card=card, saved=saved,
         after_resume=after, resumed=started, resumed_steps=steps,
         save_seconds=first["save_s"] + resumed["save_s"],
         restore_seconds=resumed["restore_s"])
    if (started != [f"resumed from step {CLI_STEPS}"]
            or steps != list(range(CLI_STEPS, CLI_RESUME_STEPS))
            or saved[-1] != CLI_STEPS or after[-1] != CLI_RESUME_STEPS):
        raise AssertionError(f"the CLI saved {saved} then {after} and "
                             f"resumed {started} at steps {steps}")
    return dict(k1=first["steps"][-1]["k1_launches"],
                k2=first["steps"][-1]["k2_launches"],
                k1_routes=first["steps"][-1]["k1_route_launches"],
                k2_routes=first["steps"][-1]["k2_route_launches"],
                meanwhile=got)


def cli_staged_step(card: str) -> None:
    """Phase 25: two `CoarseTrainer.train_step`s of the pretraining preset
    at 384^2, B = CLI_B, on batches whose images are PP_B seeded numpy
    images staged on the host (`stage_host_batch`, staging 576) and finished
    on the card by the CLI's `finish_batch`; the losses (finite) and the
    device preprocessing's share of each step's wall time."""
    cfg = task_pretrain_mlm_itm_itc()
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    text = next(cli.synthetic_batches(cfg, CLI_B, SEED))
    rows = []
    for step in range(2):
        staged, sizes = dtf.stage_host_batch(
            mixed_images(SEED + 10 + step, PP_SIZES[0][1], CLI_B),
            PP_SIZES[0][1])
        batch_in = trainer.to_device({**{k: v for k, v in text.items()
                                         if k != "image"},
                                      "image_staged": staged,
                                      "image_sizes": sizes})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = cli.finish_batch(batch_in, cfg, cli.preprocess_generator(
            trainer.device, SEED, step))
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row = dict(phase="cli_staged_step", card=card, step=step,
                   seconds=seconds, preprocess_seconds=pp_s,
                   preprocess_share=pp_s / seconds,
                   image_dtype=str(batch["image"].dtype),
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        rows.append(row)
    if not all(np.isfinite(r[k]) for r in rows for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"cli_staged_step: non-finite losses {rows}")
    prof = profile_share(lambda: trainer.train_step(cli.finish_batch(
        batch_in, cfg, cli.preprocess_generator(trainer.device, SEED, 2))))
    info(phase="cli_staged_step_profile", card=card, **prof)
    del trainer
    torch.cuda.empty_cache()


def cli_irtr(card: str) -> dict:
    """Phase 26: CLI_IRTR_STEPS CLI steps each of the two retrieval presets
    on synthetic data, B = CLI_B: `finetune_irtr_itm_itc` at 384^2 (ITC
    tower + one hard-negative ITM forward: 96 K1 / 48 K2 on `tc`) and
    `finetune_irtr_itc` at 576^2 with the 4096-slot queue (the ITC tower
    alone: 48 K1 / 24 K2 on `tc_long`)."""
    out = {}
    for task, cfg, forwards, route in (
            ("finetune_irtr_itm_itc", task_finetune_irtr_itm_itc(), 2, "tc"),
            ("finetune_irtr_itc", task_finetune_irtr_itc(), 1, "tc_long")):
        k1, k2 = full_swin_launches(cfg)
        expect = (forwards * k1, forwards * k2)
        out[task] = run_cli(
            f"cli_irtr_{cfg.image_size}", card,
            ["--task", task, "--data", "synthetic", "--per-device-batch",
             str(CLI_B), "--steps", str(CLI_IRTR_STEPS), "--log-every", "1",
             "--seed", str(SEED)], expect, route)
        del out[task]["trainer"]        # its state would hold the card
        torch.cuda.empty_cache()
    return out


def nlvr2_batch(cfg: FiberConfig, B: int, seed: int) -> dict:
    """A numpy NLVR2 batch (`compute_nlvr2`'s schema): two images an
    example, the corpus's texts, a seeded True / False answer."""
    images, ids, masks = corpus(cfg, 2 * B, B, seed)
    answers = np.random.default_rng(seed + 5).integers(0, 2, B)
    return {"image_0": images[:B], "image_1": images[B:], "text_ids": ids,
            "text_masks": masks, "answers": answers}


def run_nlvr2_training(card: str) -> dict:
    """Phase 27: NLVR2_STEPS bf16 `CoarseTrainer.train_step`s of
    `task_finetune_nlvr2` at 384^2 (warmup 0), B = CLI_B two-image
    examples: two fused forwards a step, 96 K1 / 48 K2 on `tc`."""
    cfg = task_finetune_nlvr2(warmup_steps=0)
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    batch = trainer.to_device(nlvr2_batch(cfg, CLI_B, SEED + 9))
    k1, k2 = full_swin_launches(cfg)
    expect = (2 * k1, 2 * k2)
    steps = []
    for step in range(NLVR2_STEPS):
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: trainer.train_step(batch))
        row = dict(phase="nlvr2_train", step=step, seconds=seconds,
                   card=card, max_memory_gib=gib, k1_launches=launches[0],
                   k2_launches=launches[1], expected=expect,
                   k1_route_launches=routes[0], k2_route_launches=routes[1],
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        if (tuple(launches) != expect or routes[0]["tc"] != expect[0]
                or routes[1]["tc"] != expect[1]):
            raise AssertionError(f"NLVR2 step launched (K1, K2) {launches} "
                                 f"({routes} by route), expected {expect} "
                                 f"on the tensor cores")
    if not all(np.isfinite(r["nlvr2_loss"]) for r in steps):
        raise AssertionError(f"non-finite NLVR2 losses: {steps}")
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"],
                k2_routes=steps[-1]["k2_route_launches"])


def det_prompt(names: dict, T: int) -> tuple:
    """The grounding prompt of `names` as the evaluation tool builds it
    ("name1. name2. ..."), its (1, T) ids and mask from the whitespace
    tokenizer, and the (C, T) aggregation matrix."""
    prompt = build_detection_prompt(names, sorted(names), num_negatives=0,
                                    rng=np.random.default_rng(SEED),
                                    shuffle=False)
    tok = WhitespaceTokenizer()
    l2t = build_label_to_token_map(tok, prompt, T)
    agg = label_to_token_matrix({i + 1: l2t[l]
                                 for i, l in enumerate(sorted(names))},
                                len(names), T)
    enc = tok.batch([prompt.caption], max_length=T)
    return prompt.caption, enc["input_ids"], enc["attention_mask"], agg


def stage_on_host(image_u8: np.ndarray, size: tuple) -> tuple:
    """The demo's staging without PIL: resized on the host (bilinear,
    keeping the aspect ratio) to fit `size`, RGB in [0, 1] in the top-left
    corner of a zero canvas; returns (canvas, (h0, w0, scale))."""
    H, W = size
    h0, w0 = image_u8.shape[:2]
    scale = min(H / h0, W / w0)
    nh, nw = int(h0 * scale), int(w0 * scale)
    img = torch.from_numpy(image_u8).permute(2, 0, 1)[None].float()
    if (nh, nw) != (h0, w0):
        img = F.interpolate(img, size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=True)
    canvas = np.zeros((H, W, 3), np.float32)
    canvas[:nh, :nw] = img[0].permute(1, 2, 0).clamp(0, 255).numpy() / 255.0
    return canvas, (h0, w0, scale)


def det_images(seed: int) -> tuple:
    """DET_B seeded uint8 images of the sizes DET_IMAGE_SIZES, staged on the
    host to the DET_SIZE bucket: (images (B, H, W, 3), image_sizes (B, 2))."""
    rng = np.random.default_rng(seed)
    staged = [stage_on_host(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                            DET_SIZE) for h, w in DET_IMAGE_SIZES]
    images = np.stack([c for c, _ in staged])
    sizes = np.asarray([[h0 * s, w0 * s] for _, (h0, w0, s) in staged],
                       np.float32)
    return images, sizes


def det_infer_800(card: str, phase: str = "det_infer_800",
                  reps: int = DET_REPS, **cfg_kw) -> dict:
    """Phase 28: FIBER-B detection at full width and depth (Swin-B, RoBERTa-
    base, 6 fused blocks, fusion v2, FPN 256, 6 DyConvs with deform, DyReLU
    and DyFuse, T = 256) at 800x1344, bf16, B = DET_B, seeded weights with
    the fusion gates in [0.3, 0.7], a DET_CLASSES prompt, through
    `detection_inference`: the counts set to 0 just before one call and read
    just after (K1 in all 24 Swin blocks, on `tc`; the deformable sampling
    kernel in each of the DyHead's convs, `deform_launches`); wall ms over
    DET_REPS calls, peak memory, one call under the profiler, one with the
    host's events (`head_host_waits`: no host-to-device copy and no
    synchronisation launched inside `det.head`); every head output
    finite, and with the candidate threshold at 0 (random weights put few
    scores over the serving 0.05) valid detections in every image, their
    boxes finite and inside the image.  `cfg_kw` sets more config fields
    (GLIP's early fusion in `glip_infer_800`).  Phase 28 alone also times
    the sampling kernel at FIBER-B's levels (`deform_kernel_times`)."""
    cfg = DetectorConfig(image_size=DET_SIZE, compute_dtype=torch.bfloat16,
                         **cfg_kw)
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    model = GroundingDetector(cfg, device="cuda", seed=SEED)
    seeded_gates(model, SEED)
    build_s = time.perf_counter() - t0
    caption_text, ids, mask, agg = det_prompt(DET_CLASSES, cfg.max_query_len)
    images, sizes = det_images(SEED + 5)
    batch = {"images": images, "image_sizes": sizes,
             "input_ids": np.repeat(ids, DET_B, 0),
             "attention_mask": np.repeat(mask, DET_B, 0)}
    run = lambda: detection_inference(model, batch, agg)
    run()                                             # warm-up
    torch.cuda.synchronize()
    reset_counts()
    dets = run()
    torch.cuda.synchronize()
    launches = window_attention.launches
    routes = dict(window_attention.route_launches)
    deform_launches = modulated_deform_conv2d.launches
    expect_deform = deform_calls(cfg)
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_share(run, extra=(
        ("gather", "gather"), ("elementwise", "elementwise_kernel"),
        ("gemm", "gemm"), ("upsample", "upsample"), ("copy", "Memcpy"),
        ("deform", "deform_im2col")))
    waits = head_host_waits(run)
    with torch.inference_mode():
        out = model(torch.from_numpy(images).cuda(),
                    torch.from_numpy(batch["input_ids"]).long().cuda(),
                    torch.from_numpy(batch["attention_mask"]).long().cuda())
    finite = all(bool(torch.isfinite(t.float()).all())
                 for v in out["head_out"].values() for t in v)
    # random weights put few grounding scores over the serving threshold
    # (0.05); with none the same fixed-shape pass must still give boxes
    open_dets = detection_inference(model, batch, agg, pre_nms_thresh=0.0)
    valid = open_dets.valid.cpu().numpy()
    boxes = open_dets.boxes.float().cpu().numpy()
    inside = bool(np.isfinite(boxes).all() and (boxes >= 0).all()
                  and (boxes[..., 2] <= sizes[:, None, 1] - 1).all()
                  and (boxes[..., 3] <= sizes[:, None, 0] - 1).all())
    expect = sum(cfg.depths)
    info(phase=phase, card=card, dtype="bfloat16", B=DET_B, config=cfg_kw,
         image_size=list(DET_SIZE), image_sizes=sizes.tolist(),
         caption=caption_text, build_seconds=build_s,
         params=sum(p.numel() for p in model.parameters()),
         wall_ms=wall, max_memory_gib=gib, base_gib=base,
         k1_launches=launches, expected_k1=expect, k1_by_stage=list(cfg.depths),
         route_launches=routes, deform_launches=deform_launches,
         expected_deform=expect_deform, head_host_waits=waits,
         heads_finite=finite,
         valid_per_image=dets.valid.sum(1).tolist(),
         top_scores=dets.scores[:, :5].float().cpu().numpy().tolist(),
         valid_per_image_threshold_0=valid.sum(1).tolist(),
         boxes_inside_images=inside, profile=prof)
    if launches != expect or routes["tc"] != expect:
        raise AssertionError(f"{phase}: detection_inference launched K1 "
                             f"{launches} "
                             f"times ({routes} by route), expected {expect}, "
                             f"all on the tensor cores")
    waited = (not waits["heads"] or waits["htod_copies"]
              or waits["synchronizations"])
    if deform_launches != expect_deform or (waited
                                            and phase == "det_infer_800"):
        raise AssertionError(f"{phase}: {deform_launches} deformable "
                             f"sampling launches (expected {expect_deform}), "
                             f"inside det.head {waits}")
    if not (finite and valid.any(1).all() and inside):
        raise AssertionError(f"detection outputs: finite {finite}, valid "
                             f"{valid.sum(1)} at threshold 0, boxes inside "
                             f"the images {inside}")
    if phase == "det_infer_800":
        deform_kernel_times(card)
    return dict(model=model, k1=launches, routes=routes, wall_ms=wall,
                agg=agg)


def deform_calls(cfg: DetectorConfig) -> int:
    """The deformable convs of one forward: each DyConv runs, over L
    levels, L same-level convs, L - 1 stride-2 convs and L - 1 convs of
    the level below (78 for FIBER-B: 6 DyConvs, 5 levels)."""
    L = len(cfg.anchor_strides)
    return cfg.num_dyhead_convs * (3 * L - 2) if cfg.use_deform else 0


def head_host_waits(fn) -> dict:
    """One call of `fn` under the profiler with the host's events: the
    `det.head` spans, and the host-to-device copies and synchronisations
    (stream, device, event) whose runtime call starts inside one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    heads = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.device_type() != cuda and e.name() == "det.head"]
    inside = lambda t: any(a <= t <= b for a, b in heads)
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != cuda and e.name().startswith("cu")}
    copies = sum(1 for e in events if e.device_type() == cuda
                 and "HtoD" in e.name() and e.correlation_id() in calls
                 and inside(calls[e.correlation_id()].start_ns()))
    syncs = sum(1 for e in calls.values() if "Synchronize" in e.name()
                and inside(e.start_ns()))
    return {"heads": len(heads), "htod_copies": copies,
            "synchronizations": syncs}


# FIBER-B's FPN levels at 800x1344 (strides 8 ... 128) and the batch of
# the benchmark's detection cell
DEFORM_LEVELS_800 = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
DEFORM_B = 8


def deform_kernel_times(card: str) -> list:
    """The sampling kernel at FIBER-B's five levels at 800x1344, B =
    DEFORM_B, bf16, 256 channels, on seeded features and a 27-channel
    offset conv's output: each level's same-level conv, the stride-2 conv
    from the level above and the conv of the level below on the
    reinterpreted buffers.  Its matrix `torch.equal` to the plain twin's;
    the kernel's device ms (features given channels-last, so the wrapper
    copies nothing), the op's (with its NHWC copy), the layer's (the
    kernel, the product and the bias), the bound (x read once, offsets
    and masks read, the matrix written, at 3.35 TB/s) and the plain
    twin's sampling and layer ms."""
    from fiber_torch.detection.dyhead import reinterpret
    gen = torch.Generator().manual_seed(SEED + 41)
    C, dt, levels = DEFORM_C, torch.bfloat16, DEFORM_LEVELS_800
    r = lambda *shape: torch.randn(*shape, generator=gen).to("cuda", dt)
    feats = [r(DEFORM_B, C, h, w) for h, w in levels]
    oms = [r(DEFORM_B, 27, h, w) * 2.0 for h, w in levels]
    weight = (torch.randn(C, C, 3, 3, generator=gen) * (9 * C) ** -0.5
              ).to("cuda", dt)
    bias = (torch.randn(C, generator=gen) * 0.02).to("cuda", dt)
    plain = deform_conv._deform_im2col_plain
    plain_layer = deform_conv._modulated_deform_conv2d_plain
    rows = []
    with torch.inference_mode():
        for l, (h, w) in enumerate(levels):
            off, mask = oms[l][:, :18], torch.sigmoid(oms[l][:, 18:])
            calls = [("same", feats[l], off, mask, 1)]
            if l > 0:
                calls.append(("stride2", feats[l - 1], off, mask, 2))
            if l < len(levels) - 1:
                hu, wu = levels[l + 1]
                calls.append(("reinterpreted", feats[l + 1],
                              reinterpret(off, hu, wu),
                              reinterpret(mask, hu, wu), 1))
            for kind, x, o, m, stride in calls:
                Ho, Wo = o.shape[-2:]
                equal = torch.equal(deform_im2col(x, o, m, stride),
                                    plain(x, o, m, stride))
                x_cl = x.contiguous(memory_format=torch.channels_last)
                nbytes = (x.numel() + DEFORM_B * Ho * Wo * (27 + 9 * C)) * 2
                row = dict(
                    phase="det_infer_800_deform", card=card, level=l + 3,
                    conv=kind, B=DEFORM_B, C=C, x_hw=list(x.shape[-2:]),
                    out_hw=[Ho, Wo], offset_batch_stride=o.stride(0),
                    bit_equal=equal,
                    ms=cuda_time_ms(lambda: deform_im2col(x_cl, o, m, stride)),
                    op_ms=cuda_time_ms(lambda: deform_im2col(x, o, m, stride)),
                    layer_ms=cuda_time_ms(lambda: modulated_deform_conv2d(
                        x, o, m, weight, bias, stride)),
                    bound_ms=nbytes / PEAK_BYTES * 1e3,
                    plain_ms=cuda_time_ms(lambda: plain(x, o, m, stride),
                                          iters=5, warmup=1),
                    plain_layer_ms=cuda_time_ms(
                        lambda: plain_layer(x, o, m, weight, bias, stride),
                        iters=5, warmup=1))
                info(**row)
                rows.append(row)
                torch.cuda.empty_cache()
    info(phase="det_infer_800_deform_dyconv", card=card,
         **{k: sum(r[k] for r in rows) for k in
            ("ms", "op_ms", "layer_ms", "bound_ms", "plain_ms",
             "plain_layer_ms")},
         note="one DyConv's 13 convs at B = 8; a pass runs 6 DyConvs")
    bad = [(r["level"], r["conv"]) for r in rows if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"det_infer_800_deform: the kernel's matrix "
                             f"differs from the plain twin's at {bad}")
    return rows


def det_fp32_card_vs_host(card: str) -> None:
    """Phase 29: the same widths at DET_FP32_SIZE, B = 1, fp32 (TF32 off):
    every head output at every level on the card (K1 on `f32_tiled`)
    against the host's plain path, within DET_RTOL of each tensor's
    max-abs."""
    cfg = DetectorConfig(image_size=DET_FP32_SIZE)
    _, ids, mask, _ = det_prompt(DET_CLASSES, cfg.max_query_len)
    rng = np.random.default_rng(SEED + 6)
    H, W = DET_FP32_SIZE
    img = torch.from_numpy(rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32))
    args = (img, torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    gpu = GroundingDetector(cfg, device="cuda", seed=SEED)
    seeded_gates(gpu, SEED)
    with torch.inference_mode():
        reset_counts()
        card_out = gpu(*(a.cuda() for a in args))
        launches = window_attention.launches
        routes = dict(window_attention.route_launches)
        card_out = {k: [t.cpu() for t in v]
                    for k, v in card_out["head_out"].items()}
    del gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = GroundingDetector(cfg, device="cpu", seed=SEED)
    seeded_gates(host, SEED)
    with torch.inference_mode():
        host_out = host(*args)["head_out"]
    host_s = time.perf_counter() - t0
    errs = {k: [((c - h).abs().max() / h.abs().max()).item()
                for c, h in zip(card_out[k], host_out[k])]
            for k in card_out}
    worst = max(max(v) for v in errs.values())
    info(phase="det_fp32_card_vs_host", card=card, image_size=list(DET_FP32_SIZE),
         rel_err_by_level=errs, worst_rel_err=worst, limit=DET_RTOL,
         k1_launches=launches, route_launches=routes, host_seconds=host_s)
    if launches != sum(cfg.depths) or routes[FP32_FWD_ROUTE] != launches:
        raise AssertionError(f"fp32 detector launched K1 {launches} times "
                             f"({routes}), expected {sum(cfg.depths)} on "
                             f"route {FP32_FWD_ROUTE}")
    if not worst <= DET_RTOL:
        raise AssertionError(f"detector card and host disagree in fp32: "
                             f"{errs}")


def det_eval(card: str, model) -> None:
    """Phase 29: the chunked zero-shot evaluation in this process on the
    bf16 800x1344 model: `evaluate_detection` over DET_EVAL_IMAGES seeded
    images, the tool's ten classes in chunks of DET_EVAL_CHUNK, two images
    a pass, timed (s per image).  The tool as a user runs it is phase 29b
    (`subprocess_round`)."""
    rng = np.random.default_rng(SEED + 7)
    images = np.concatenate([det_images(SEED + 8 + i)[0]
                             for i in range(DET_EVAL_IMAGES // DET_B)])
    sizes = np.tile(np.asarray([DET_SIZE], np.float32), (len(images), 1))
    gts = [{"boxes": np.asarray([[10., 10., 30., 30.], [100., 80., 170., 150.],
                                 [300., 200., 600., 500.]]),
            "labels": rng.integers(1, len(eval_det.COCO_CLASSES) + 1, 3)}
           for _ in images]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eval_det.evaluate_detection(
        model, images, sizes, eval_det.COCO_CLASSES, gts,
        WhitespaceTokenizer(), chunk_size=DET_EVAL_CHUNK, batch=DET_B)
    seconds = time.perf_counter() - t0
    info(phase="det_eval", card=card, images=len(images),
         classes=len(eval_det.COCO_CLASSES), chunk=DET_EVAL_CHUNK, batch=DET_B,
         seconds=seconds, s_per_image=seconds / len(images), metrics=metrics)
    check_eval_metrics("det_eval", metrics)


def check_eval_metrics(what: str, metrics) -> None:
    keys = {"mAP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
            "AR100", "ARs", "ARm", "ARl"}
    if metrics is None or set(metrics) != keys or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: metrics {metrics}")


def det_demo(card: str, model) -> None:
    """Phase 31: `GroundingDemo` on one 800x1066 image staged on the host
    (no PIL) and a free caption: the phrases it found and its boxes."""
    rng = np.random.default_rng(SEED + 9)
    staged = stage_on_host(rng.integers(0, 256, (800, 1066, 3),
                                        dtype=np.uint8), DET_SIZE)
    demo = GroundingDemo(model, WhitespaceTokenizer(), score_threshold=0.05)
    caption_text = "a person riding a bicycle next to a red car and a dog"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = demo(staged, caption_text)
    wall_ms = (time.perf_counter() - t0) * 1e3
    phrases = [caption_text[s:e] for s, e in find_noun_phrases(caption_text)]
    info(phase="det_demo", card=card, caption=caption_text, phrases=phrases,
         boxes=len(out["boxes"]), labels=out["labels"][:10],
         scores=[float(v) for v in out["scores"][:10]], wall_ms=wall_ms)
    if not phrases or len(out["boxes"]) != len(out["labels"]) or not \
            np.isfinite(out["boxes"]).all():
        raise AssertionError(f"det_demo: {phrases}, {out}")
    if any(m in sys.modules for m in ("PIL", "pyarrow", "transformers")):
        raise AssertionError("the detection phases imported PIL, pyarrow or "
                             "transformers")


def det_trainer(cls=DetectionTrainer, mesh=None, **kw):
    """FIBER-B at DET_SIZE, bf16 over fp32 parameters, seeded weights with
    the fusion gates in [0.3, 0.7]: the trainer of the detection training
    phases (clip 1, EMA 0.999, no warmup, lr DET_TRAIN_LR), data parallel
    over `mesh` when given."""
    cfg = DetectorConfig(image_size=DET_SIZE, compute_dtype=torch.bfloat16,
                         **kw)
    trainer = cls(cfg, device="cuda", seed=SEED, base_lr=DET_TRAIN_LR,
                  lang_lr=DET_TRAIN_LR, clip_norm=1.0, ema_decay=0.999,
                  warmup_iters=0, mesh=mesh)
    seeded_gates(trainer.model, SEED)
    return trainer


def det_batch(cfg: DetectorConfig, B: int, seed: int, size=None) -> dict:
    """One seeded `synthetic_batches` batch (at `size`), on the card."""
    if size is not None:
        cfg = dataclasses.replace(cfg, image_size=size)
    batch = next(synthetic_batches(cfg, B, seed=seed))
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def set_remat(model, on: bool) -> None:
    """Checkpointing of every Swin block and of the DyConv tower."""
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = on


def check_det_launches(what: str, launches, routes, expect) -> None:
    if (tuple(launches) != tuple(expect) or routes[0]["tc"] != expect[0]
            or routes[1]["tc"] != expect[1]):
        raise AssertionError(f"{what} launched (K1, K2) {launches} ({routes} "
                             f"by route), expected {expect}, all on the "
                             f"tensor cores")


def check_deform_launches(what: str, expect: int) -> None:
    if modulated_deform_conv2d.launches != expect:
        raise AssertionError(f"{what} launched the deformable sampling "
                             f"kernel {modulated_deform_conv2d.launches} "
                             f"times, expected {expect}")


def det_train_800(card: str) -> dict:
    """Phase 33: DET_TRAIN_STEPS bf16 detection train steps at 800x1344 on
    one batch, each counted (`counted_step`; the deformable sampling
    kernel once a conv in the forward, none in the backward, which
    recomputes the plain version); a profiled step; one step with remat
    on (the kernel again in each DyConv's recompute)."""
    t0 = time.perf_counter()
    trainer = det_trainer()
    cfg = trainer.cfg
    info(phase="det_train_model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in trainer.params),
         groups={g["name"]: sum(p.numel() for p in g["params"])
                 for g in trainer.optimizer.param_groups},
         image_size=list(DET_SIZE), batch=DET_B, lr=DET_TRAIN_LR)
    batch = det_batch(cfg, DET_B, SEED + 11)
    blocks = sum(cfg.depths)
    steps, peak = [], 0.0
    for step in range(DET_TRAIN_STEPS):
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: trainer.train_step(batch))
        row = dict(phase="det_train_800", step=step, card=card,
                   wall_ms=seconds * 1e3, max_memory_gib=gib,
                   deform_launches=modulated_deform_conv2d.launches,
                   k1_launches=launches[0], k2_launches=launches[1],
                   k1_route_launches=routes[0], k2_route_launches=routes[1],
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        peak = max(peak, gib)
        check_det_launches("det_train_800", launches, routes,
                           (blocks, blocks))
        check_deform_launches("det_train_800", deform_calls(cfg))
    total = [r["total_loss"] for r in steps]
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.startswith("loss") or k == "total_loss") or \
            not all(r["finite"] == 1.0 for r in steps):
        raise AssertionError(f"det_train_800: non-finite losses {steps}")
    if not total[-1] < total[0]:
        raise AssertionError(f"det_train_800: the total loss did not fall: "
                             f"{total}")
    prof = profile_share(lambda: trainer.train_step(batch), extra=(
        ("gather", "gather"), ("scatter", "scatter"),
        ("elementwise", "elementwise_kernel"), ("gemm", "gemm"),
        ("conv", "conv"), ("reduce", "reduce_kernel"), ("copy", "Memcpy"),
        ("deform", "deform_im2col")))
    info(phase="det_train_profile", card=card, **prof)
    set_remat(trainer.model, True)
    metrics, seconds, gib, launches, routes = counted_step(
        lambda: trainer.train_step(batch))
    set_remat(trainer.model, False)
    info(phase="det_train_remat", card=card, wall_ms=seconds * 1e3,
         max_memory_gib=gib, max_memory_gib_no_remat=peak,
         deform_launches=modulated_deform_conv2d.launches,
         k1_launches=launches[0], k2_launches=launches[1],
         k1_route_launches=routes[0], k2_route_launches=routes[1],
         total_loss=float(metrics["total_loss"]))
    check_det_launches("det_train_remat", launches, routes,
                       (2 * blocks, blocks))
    check_deform_launches("det_train_remat", 2 * deform_calls(cfg))
    if not (gib < peak and np.isfinite(float(metrics["total_loss"]))):
        raise AssertionError(f"det_train_remat: peak {gib} GiB against "
                             f"{peak} without remat, loss "
                             f"{float(metrics['total_loss'])}")
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"],
                k2_routes=steps[-1]["k2_route_launches"],
                wall_ms=[r["wall_ms"] for r in steps], profile=prof)


def det_grad_runs(cfg: DetectorConfig, batch: dict, runs) -> dict:
    """For each run (name, device, threads, cuDNN on, eps): a copy of one
    fp32 training build of `cfg` (seeded on the host, gates in [0.3, 0.7],
    eval mode: no dropout) on the run's device, its weights moved by x (1 +
    eps u) when eps, `detection_loss` and its backward.  Returns {name: (losses, gradients on the host,
    (K1, K2) launches, their routes, seconds, head outputs on the host when
    the run's name is "card" or "host" and the build has early fusion)}."""
    threads = torch.get_num_threads()
    built = GroundingDetector(cfg, device="cpu", seed=SEED,
                              for_training=True).eval()
    seeded_gates(built, SEED)
    out = {}
    for run, dev, n_threads, cudnn, eps in runs:
        torch.set_num_threads(n_threads)
        t0 = time.perf_counter()
        model = copy.deepcopy(built).to(dev)
        if eps:
            gen = torch.Generator().manual_seed(SEED + 14)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + eps * (2 * torch.rand(p.shape, generator=gen)
                                      - 1))
        heads = None
        if run in ("card", "host") and cfg.early_fuse != "none":
            with torch.inference_mode(), \
                    torch.backends.cudnn.flags(enabled=cudnn):
                heads = model(
                    torch.as_tensor(batch["images"]).to(dev),
                    torch.as_tensor(batch["input_ids"]).long().to(dev),
                    torch.as_tensor(batch["attention_mask"]).long().to(dev)
                )["head_out"]
                heads = {k: [t.cpu() for t in v] for k, v in heads.items()}
        reset_counts()
        with torch.backends.cudnn.flags(enabled=cudnn):
            losses = detection_loss(model, batch, train=False)
            losses["total_loss"].backward()
        out[run] = ({k: float(v.detach()) for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    (window_attention.launches, window_attention_bwd.launches),
                    (dict(window_attention.route_launches),
                     dict(window_attention_bwd.route_launches)),
                    time.perf_counter() - t0, heads)
        del model, losses
        torch.cuda.empty_cache()
    torch.set_num_threads(threads)
    del built
    return out


def grad_scale(hg: dict, n: str) -> torch.Tensor:
    """The max-abs a gradient's error is measured against: its own, or for
    an attention key bias (exact gradient zero: the softmax over the keys
    does not see q . b_k) its key weight's."""
    if n.endswith("key.bias"):
        n = n[:-len("bias")] + "weight"
    return hg[n].abs().max().clamp_min(1e-30)


def det_grads_card_vs_host(card: str) -> None:
    """Phase 34: fp32 (TF32 off) at DET_GRAD_SIZE, B = 1, full width and
    depth, deform on, no dropout: `detection_loss` and every
    parameter's gradient on the card (K1 on `f32_tiled`, K2 on `tc_f32`)
    against
    the host's plain path.  At random weights some gradients are
    ill-conditioned (the DyHead's backward amplifies rounding): the host
    against itself on one thread (another order of its sums), and on its
    weights moved by one rounding (x (1 + 2^-23 u)), differs there by a
    few % of the tensor's max-abs.  So each tensor of the card is held,
    against the nearer of the host's two orders, within GRAD_RTOL of its
    max-abs, or twice that spread where it is larger; an attention key
    bias, whose exact gradient
    is zero (the softmax over the keys does not see q . b_k), is measured
    against its key weight's max-abs.  The card runs its convolutions
    without cuDNN, whose fp32 algorithms round some of these gradients
    further apart; the cuDNN run's errors are reported beside.  Every
    loss within DET_LOSS_RTOL."""
    cfg = DetectorConfig(image_size=DET_GRAD_SIZE)
    batch = next(synthetic_batches(cfg, 1, seed=SEED + 12))
    threads = torch.get_num_threads()
    out = det_grad_runs(cfg, batch, (
        ("card", "cuda", threads, False, 0.0),
        ("card_cudnn", "cuda", threads, True, 0.0),
        ("host", "cpu", threads, True, 0.0),
        ("host_1_thread", "cpu", 1, True, 0.0),
        ("host_perturbed", "cpu", threads, True, 2.0 ** -23)))
    cl, cg, launches, routes = out["card"][:4]
    hl, hg = out["host"][:2]
    h1g, hpg, cdg = (out[k][1] for k in ("host_1_thread", "host_perturbed",
                                         "card_cudnn"))
    loss_err = {k: abs(cl[k] - hl[k]) / max(abs(hl[k]), 1e-30) for k in hl}
    scale = functools.partial(grad_scale, hg)

    def diff(a, b, n) -> torch.Tensor:
        return (a[n] - b[n]).abs().max()

    err = {n: float(torch.minimum(diff(cg, hg, n), diff(cg, h1g, n))
                    / scale(n)) for n in hg}
    spread = {n: float(torch.maximum(diff(h1g, hg, n), diff(hpg, hg, n))
                       / scale(n)) for n in hg}
    err_cudnn = {n: float(torch.minimum(diff(cdg, hg, n), diff(cdg, h1g, n))
                          / scale(n)) for n in hg}
    limit = {n: max(GRAD_RTOL, 2.0 * spread[n]) for n in hg}
    worst = sorted(((n, err[n], spread[n]) for n in hg),
                   key=lambda r: -r[1])[:8]
    over = [(n, err[n], limit[n]) for n in hg if err[n] > limit[n]]
    zero = [n for n, g in hg.items() if not bool(g.abs().max() > 0)]
    info(phase="det_grads_card_vs_host", card=card,
         image_size=list(DET_GRAD_SIZE), params=len(hg), losses=hl,
         loss_rel_err=loss_err,
         worst_grad_rel_err_and_host_spread=worst, grad_limit=GRAD_RTOL,
         tensors_within_grad_limit=sum(e <= GRAD_RTOL for e in err.values()),
         tensors_on_the_spread_limit=sum(v > GRAD_RTOL
                                         for v in limit.values()),
         worst_host_spread=max(spread.values()), over_limit=over[:8],
         cudnn_over_limit=sorted(((n, err_cudnn[n], limit[n]) for n in hg
                                  if err_cudnn[n] > limit[n]),
                                 key=lambda r: -r[1])[:8],
         zero_grads=zero[:10], n_zero_grads=len(zero), k1_launches=launches[0],
         k2_launches=launches[1], route_launches=routes,
         seconds={k: v[4] for k, v in out.items()})
    blocks = sum(cfg.depths)
    if (launches != (blocks, blocks) or routes[0][FP32_FWD_ROUTE] != blocks
            or routes[1][FP32_ROUTE] != blocks):
        raise AssertionError(f"det_grads_card_vs_host launched (K1, K2) "
                             f"{launches} ({routes}), expected {blocks} each "
                             f"on routes {FP32_FWD_ROUTE}, {FP32_ROUTE}")
    if max(loss_err.values()) > DET_LOSS_RTOL or over:
        raise AssertionError(f"detection gradients disagree card vs host: "
                             f"losses {loss_err}, over their limit {over[:8]}")


# the tools as a user runs them (`python -m fiber_torch.tools.<name>`)
DET_TOOLS = {
    "eval_det": ["--num-images", str(DET_EVAL_IMAGES), "--chunk-size",
                 str(DET_EVAL_CHUNK), "--device", "cuda", "--dtype",
                 "bfloat16"],
    "train_det": ["--image-size", "%dx%d" % DET_SIZE, "--batch", str(DET_B),
                  "--steps", str(DET_CLI_STEPS), "--log-every", "1"],
    "finetune_det": ["--tuning", "language_prompt_v2", "--steps",
                     str(DET_CLI_STEPS)]}


def det_tool_specs() -> dict:
    return {name: ([sys.executable, "-m", f"fiber_torch.tools.{name}",
                    *argv], None) for name, argv in DET_TOOLS.items()}


def det_tool_results(card: str, outs: dict) -> dict:
    """Phases 29b and 35: `eval_det` (the same sizes as phase 29, its own
    seeded model: exit 0, every metric printed and finite), `train_det` at
    800x1344 and `finetune_det --tuning language_prompt_v2` at its default
    size (DET_CLI_STEPS steps each: exit 0, finite losses, the frozen
    parameters moved by no more than the weight decay)."""
    runs = {}
    for name in DET_TOOLS:
        rc, out, err, seconds = outs[name]
        lines = out.strip().splitlines()
        last = json.loads(lines[-1]) if rc == 0 and lines else None
        runs[name] = dict(rc=rc, seconds=seconds, result=last,
                          stderr=err[-2000:] if rc else "")
    tool = runs.pop("eval_det")
    info(phase="det_eval_tool", card=card, argv=DET_TOOLS["eval_det"],
         images=DET_EVAL_IMAGES, tool_rc=tool["rc"],
         tool_seconds=tool["seconds"],
         tool_s_per_image=tool["seconds"] / DET_EVAL_IMAGES,
         tool_metrics=tool["result"], tool_stderr=tool["stderr"])
    check_eval_metrics(f"det_eval_tool (rc {tool['rc']})", tool["result"])
    for name, run in runs.items():
        info(phase="det_train_cli", card=card, tool=name,
             argv=DET_TOOLS[name], **run)
    train, tune = runs["train_det"]["result"], runs["finetune_det"]["result"]
    ok = (train is not None and tune is not None
          and len(train["steps"]) == DET_CLI_STEPS
          and all(np.isfinite(s["total_loss"]) and s["finite"] == 1.0
                  for s in train["steps"])
          and len(tune["losses"]) == DET_CLI_STEPS
          and np.isfinite(tune["losses"]).all()
          and tune["frozen_excess_over_decay"] <= 0.0)
    if not ok:
        raise AssertionError(f"det_train_cli: {runs}")
    return runs


def det_multiscale(card: str) -> dict:
    """Phase 36: `MultiScaleDetectionTrainer` on the DET_MULTISCALE buckets
    in turn, two steps each, one parameter set."""
    trainer = det_trainer(MultiScaleDetectionTrainer)
    cfg = trainer.cfg
    batches = {size: det_batch(cfg, DET_B, SEED + 13, size)
               for size in DET_MULTISCALE}
    blocks = sum(cfg.depths)
    rows = []
    for step in range(2 * len(DET_MULTISCALE)):
        size = DET_MULTISCALE[step % len(DET_MULTISCALE)]
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: trainer.trainer_for(size).train_step(batches[size]))
        rows.append(dict(phase="det_multiscale", step=step, card=card,
                         image_size=list(size), wall_ms=seconds * 1e3,
                         max_memory_gib=gib, k1_launches=launches[0],
                         k2_launches=launches[1],
                         **{k: float(v) for k, v in metrics.items()}))
        info(**rows[-1])
        check_det_launches("det_multiscale", launches, routes,
                           (blocks, blocks))
    if not all(np.isfinite(r["total_loss"]) and r["finite"] == 1.0
               for r in rows):
        raise AssertionError(f"det_multiscale: {rows}")
    del trainer, batches
    torch.cuda.empty_cache()
    return dict(k1=rows[-1]["k1_launches"], k2=rows[-1]["k2_launches"])


# ---------------------------------------------------------------------------
# data parallel (fiber_torch/parallel/): the ranks are this script run again,
# `python3 chip_smoke.py --ddp-worker <job> <rank> <world> <dir> <card>`,
# meeting through the FIBER_* environment on a localhost port.  One card
# holds both ranks of a two-rank job, so those run gloo (whose collectives
# the port stages through the host for CUDA tensors); NCCL runs at world 1.
DDP_TIMEOUT_S = 900
DDP_STEPS = 3                # CLI steps at world 1; bf16 steps on two ranks
DDP_FP32_B = 4               # the fp32 global batch, two rows a rank
DDP_BF16_B = 4               # rows a rank of the bf16 steps
DDP_LOSS_RTOL = 1e-5
TP_STEPS = 2                 # bf16 steps on the (1, 2) mesh
DDP_DET_BOXES = (1, 8)       # the boxes of the two detection images
DDP_EVAL_IMAGES = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(specs: dict, d: str, timeout: float, during=None) -> tuple:
    """Start every process of `specs` ({name: (argv, env or None)}) at
    once, each writing its output and errors to files in `d`; call
    `during()` (when given) while they run; wait for all within `timeout`
    seconds of the start (a process still running then fails the phase),
    and stop every process still running on the way out.  Returns
    ({name: (exit code, output, errors, seconds)}, what `during` returned).
    """
    procs, files, seconds = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for name, (argv, env) in specs.items():
            stem = os.path.join(d, name.replace(" ", "_"))
            files[name] = (open(stem + ".out", "w+"),
                           open(stem + ".err", "w+"))
            procs[name] = subprocess.Popen(argv, env=env, text=True,
                                           stdout=files[name][0],
                                           stderr=files[name][1])
        got = during() if during is not None else None
        while len(seconds) < len(procs):
            for name, p in procs.items():
                if name not in seconds and p.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"still running after {timeout} s: "
                                     f"{sorted(set(procs) - set(seconds))}")
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, (fo, fe) in files.items():
        fo.seek(0)
        fe.seek(0)
        out[name] = (procs[name].returncode, fo.read(), fe.read(),
                     seconds[name])
        fo.close()
        fe.close()
    return out, got


def ddp_specs(job: str, world: int, d: str, card: str, group: bool = True,
              tag: str = None) -> dict:
    """`run_procs` specs of `job` on `world` ranks, named "<tag> rank <r>"
    (`tag` defaults to the job), each this script's worker; with `group`,
    FIBER_* set for a rendezvous on a free localhost port, without, one
    plain process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("FIBER_COORDINATOR", "FIBER_NUM_PROCESSES",
                        "FIBER_PROCESS_ID")}
    coord = f"127.0.0.1:{free_port()}"
    specs = {}
    for r in range(world):
        renv = dict(env, FIBER_COORDINATOR=coord,
                    FIBER_NUM_PROCESSES=str(world),
                    FIBER_PROCESS_ID=str(r)) if group else env
        specs[f"{tag or job} rank {r}"] = (
            [sys.executable, os.path.abspath(__file__), "--ddp-worker", job,
             str(r), str(world), d, card], renv)
    return specs


def ddp_results(outs: dict, world: int, d: str, tag: str) -> list:
    """Every rank's output echoed with its rank; a rank that failed fails
    the phase; every rank's result (`<d>/rank<r>.json`)."""
    for r in range(world):
        rc, out, err = outs[f"{tag} rank {r}"][:3]
        for line in (out + err).splitlines():
            print(f"[{tag} rank {r}] {line}", flush=True)
        if rc != 0:
            raise AssertionError(f"{tag}: rank {r} exited {rc}")
    results = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def ddp_run(job: str, world: int, d: str, card: str, during=None) -> tuple:
    """`job` on `world` ranks that meet on a localhost port, each started
    as this script's worker at once (`run_procs`, `during` called while
    they run); within DDP_TIMEOUT_S; every rank's result, and what
    `during` returned."""
    with tempfile.TemporaryDirectory() as logs:
        outs, got = run_procs(ddp_specs(job, world, d, card), logs,
                              DDP_TIMEOUT_S, during)
    return ddp_results(outs, world, d, job), got


def timed_all_reduce() -> list:
    """Time every gradient all-reduce of the trainers with CUDA events:
    returns the list the (start, end) pairs go to."""
    from fiber_torch.train import detection_trainer as det_mod
    from fiber_torch.train import trainer as coarse_mod
    events = []
    for mod in (coarse_mod, det_mod):
        def timed(flat, group, _orig=mod.all_reduce_grads_):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            _orig(flat, group)
            pair[1].record()
            events.append(pair)
        mod.all_reduce_grads_ = timed
    return events


def event_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t`'s bits as integers of its width (so that NaN equals NaN)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def ranks_bit_equal(tensors, group, chunk: int = 1 << 26) -> bool:
    """Every tensor on this rank equal, bit for bit, to rank 0's (broadcast
    from rank 0 in pieces of `chunk` elements, through the host under
    gloo); the same verdict on every rank."""
    from fiber_torch.parallel.data_parallel import all_reduce_sum_, broadcast_
    bad = torch.zeros((), device=tensors[0].device)
    for t in tensors:
        for piece in t.detach().reshape(-1).split(chunk):
            ref = piece.clone()
            broadcast_([ref], group)
            bad += 0.0 if torch.equal(bits(ref), bits(piece)) else 1.0
    return float(all_reduce_sum_(bad, group)) == 0.0


@contextlib.contextmanager
def fixed_negatives():
    """The mining replaced by fixed global negatives: each row's image
    negative the next row of the global batch, its text negative the one
    after (valid while the queue is empty), so that one process and two
    ranks take the same negatives."""
    orig = coarse.mine_hard_negatives
    calls = []

    def mine(sim, valid, generator, row0=0, total_rows=None):
        n = total_rows or sim.shape[0]
        rows = row0 + torch.arange(sim.shape[0], device=sim.device)
        calls.append(1)
        return (rows + 1 + (len(calls) + 1) % 2) % n
    coarse.mine_hard_negatives = mine
    try:
        yield
    finally:
        coarse.mine_hard_negatives = orig


def ddp_fp32_cfg() -> FiberConfig:
    return FiberConfig.base(compute_dtype=torch.float32, drop_rate=0.0,
                            swin_drop_path_rate=0.0, warmup_steps=0,
                            learning_rate=1e-4,
                            loss_names=("itm", "mlm", "itc"))


def ddp_fp32_step(mesh=None) -> tuple:
    """Phases 38 (a) and 56 (a): one fp32 `train_step` of FIBER-Base 384^2
    with EMA on this process's rows of the DDP_FP32_B global batch (its
    data rank's), on fixed negatives; (trainer, metrics, seconds, peak
    GiB)."""
    from fiber_torch.parallel.mesh import shard_batch
    tr = CoarseTrainer(ddp_fp32_cfg(), device="cuda", seed=SEED,
                       ema_decay=0.999, mesh=mesh)
    seeded_gates(tr.model, SEED)
    batch = shard_batch(train_batch(tr.cfg, DDP_FP32_B, SEED + 20), tr.group)
    with fixed_negatives():
        metrics, seconds, gib, _, _ = counted_step(
            lambda: tr.train_step(batch))
    return tr, {k: float(v) for k, v in metrics.items()}, seconds, gib


def det_box_batch(cfg: DetectorConfig, counts, seed: int) -> dict:
    """A seeded synthetic detection batch whose image b holds counts[b]
    boxes (as `synthetic_batches` draws them)."""
    batch = next(synthetic_batches(cfg, len(counts), max_boxes=max(counts),
                                   seed=seed))
    rng = np.random.default_rng(seed + 1)
    H, W = cfg.image_size
    G, T = max(counts), cfg.max_query_len
    batch["gt_boxes"] = np.zeros((len(counts), G, 4), np.float32)
    batch["gt_valid"] = np.zeros((len(counts), G), bool)
    batch["positive_map"] = np.zeros((len(counts), G, T), np.float32)
    for b, n in enumerate(counts):
        for g in range(n):
            x1, y1 = rng.uniform(0, W - 64), rng.uniform(0, H - 64)
            w, h = rng.uniform(32, 128), rng.uniform(32, 128)
            batch["gt_boxes"][b, g] = [x1, y1, min(x1 + w, W - 1),
                                       min(y1 + h, H - 1)]
            batch["gt_valid"][b, g] = True
            batch["positive_map"][b, g, rng.integers(1, T - 1)] = 1.0
    return batch


def det_num_pos(cfg: DetectorConfig, batch: dict) -> torch.Tensor:
    """The ATSS positives of a batch, as `detection_loss` assigns them (on
    the host)."""
    from fiber_torch.detection.atss import batched_atss_assign
    from fiber_torch.detection.detector import detector_anchors
    anchors, sizes, _ = detector_anchors(cfg, cfg.image_size)
    return batched_atss_assign(
        anchors, sizes, torch.as_tensor(batch["gt_boxes"]),
        torch.as_tensor(batch["gt_valid"]), topk=cfg.atss_topk).pos_mask.sum()


def det_fp32_grads(mesh=None, eps: float = 0.0, seed: int = SEED) -> tuple:
    """Phase 39's gradients: fp32 FIBER-B at DET_GRAD_SIZE, no dropout,
    no clip, this process's rows of a seeded two-image batch, summed over
    the ranks (`DetectionTrainer._grads`); the weights moved by one
    rounding (x (1 + eps u), u drawn from `seed`) when `eps`.  (flat gradient on the host,
    metrics, the parameters' names and sizes.)"""
    from fiber_torch.parallel.mesh import shard_batch
    cfg = DetectorConfig(image_size=DET_GRAD_SIZE)
    tr = DetectionTrainer(cfg, device="cuda", seed=SEED, ema_decay=None,
                          clip_norm=None, warmup_iters=0, mesh=mesh)
    seeded_gates(tr.model, SEED)
    if eps:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in tr.params:
                p.mul_(1 + eps * (2 * torch.rand(p.shape, generator=gen)
                                  - 1).to(p.device))
    tr.model.eval()
    batch = shard_batch(next(synthetic_batches(cfg, 2, seed=SEED + 12)),
                        tr.group)
    metrics = tr._grads(batch, None)
    names = [(n, p.numel()) for n, p in tr.model.named_parameters()]
    out = (tr.flat_grad.cpu(), {k: float(v) for k, v in metrics.items()},
           names)
    del tr
    torch.cuda.empty_cache()
    return out


def eval_predictions(model) -> list:
    """Phase 40: `predict_detections` over DDP_EVAL_IMAGES seeded images at
    DET_SIZE, ten classes in chunks of DET_EVAL_CHUNK, one image a pass,
    the candidate threshold 0 (seeded weights score under the default
    0.05), so that every image keeps post_nms_top_n detections a chunk."""
    images = np.concatenate([det_images(SEED + 8 + i)[0]
                             for i in range(DDP_EVAL_IMAGES // DET_B)])
    sizes = np.tile(np.asarray([DET_SIZE], np.float32), (len(images), 1))
    return eval_det.predict_detections(
        model, images, sizes, eval_det.COCO_CLASSES, WhitespaceTokenizer(),
        chunk_size=DET_EVAL_CHUNK, batch=1, pre_nms_thresh=0.0,
        pre_nms_top_n=100, post_nms_top_n=20)


def eval_model():
    from fiber_torch.parallel.multihost import rank_device
    model = GroundingDetector(DetectorConfig(image_size=DET_SIZE,
                                             compute_dtype=torch.bfloat16),
                              device=rank_device("cuda"), seed=SEED).eval()
    seeded_gates(model, SEED)
    return model


def job_cli(rank: int, world: int, d: str, card: str) -> dict:
    """Phase 37's run: `fiber_torch.cli.main` on the pretraining preset,
    under a process group when FIBER_* is set (NCCL at world 1), each
    step counted and its gradient all-reduce timed; the parameters after
    the last step saved to `<d>/params.pt`."""
    cfg = task_pretrain_mlm_itm_itc()
    events = timed_all_reduce()
    res = run_cli("ddp_world1_pretrain_run", card,
                  ["--task", "pretrain_mlm_itm_itc", "--data", "synthetic",
                   "--per-device-batch", str(CLI_B), "--steps",
                   str(DDP_STEPS), "--log-every", "1", "--seed", str(SEED)],
                  expected_launches(cfg, forwards=3), "tc")
    torch.save(torch.cat([p.detach().reshape(-1) for p in
                          res["trainer"].params]).cpu(),
               os.path.join(d, "params.pt"))
    steps = [{k: v for k, v in r.items() if not isinstance(v, dict)}
             for r in res["steps"]]
    group = bool(os.environ.get("FIBER_COORDINATOR"))
    return dict(steps=steps, all_reduce_ms=event_ms(events), gib=res["gib"],
                group=group, backend=(("nccl" if torch.cuda.is_available()
                                       else "gloo") if group else None))


def ring_rows(queue) -> dict:
    """The queue's input-ring slots held here whose bits are not all zero:
    {ring: (their slot numbers in the whole ring, their rows), on the
    host}."""
    from fiber_torch.parallel.itc_queue import INPUT_RINGS
    out = {}
    for k in INPUT_RINGS:
        ring = getattr(queue, k)
        nz = torch.cat([bits(c).reshape(c.shape[0], -1).ne(0).any(1)
                        for c in ring.split(256)])
        idx = nz.nonzero()[:, 0]
        out[k] = ((idx + queue.lo).cpu(), ring[idx].cpu())
    return out


def job_pretrain(rank: int, world: int, d: str, card: str, mesh) -> dict:
    """Phase 38's ranks: (a) the fp32 step, its summed gradient saved by
    rank 0; (b) every parameter, EMA tensor and feature ring, `ptr` and
    `total` against rank 0's, this rank's input-ring bytes, and its
    block's non-zero rows saved (`ring_rows`); (c) DDP_STEPS bf16 steps of
    this rank's DDP_BF16_B rows, counted, the all-reduce timed."""
    from fiber_torch.parallel.mesh import shard_batch
    t0 = time.perf_counter()
    tr, metrics, seconds, gib = ddp_fp32_step(mesh)
    if rank == 0:
        torch.save(tr.flat_grad.cpu(), os.path.join(d, "pretrain_grads.pt"))
    q = tr.queue
    same = ranks_bit_equal(list(tr.params) + list(tr.ema)
                           + [q.image_feats, q.text_feats, q.ptr, q.total],
                           tr.group)
    torch.save(ring_rows(q), os.path.join(d, f"rings_rank{rank}.pt"))
    out = dict(fp32=dict(metrics=metrics, seconds=seconds, gib=gib,
                         bit_equal=same, ring_bytes=q.input_bytes(),
                         ring_lo=q.lo, ring_slots=q.slots,
                         phase_seconds=time.perf_counter() - t0))
    del tr
    torch.cuda.empty_cache()
    cfg = FiberConfig.base(loss_names=("itm", "mlm", "itc"), warmup_steps=0,
                           learning_rate=1e-4)
    tr = CoarseTrainer(cfg, device="cuda", seed=SEED, mesh=mesh)
    seeded_gates(tr.model, SEED)
    batch = tr.to_device(shard_batch(train_batch(cfg, DDP_BF16_B * world,
                                                 SEED), tr.group))
    events = timed_all_reduce()
    rows = []
    for step in range(DDP_STEPS):
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: tr.train_step(batch))
        rows.append(dict(step=step, seconds=seconds, gib=gib,
                         k1=launches[0], k2=launches[1],
                         k1_tc=routes[0]["tc"], k2_tc=routes[1]["tc"],
                         **{k: float(v) for k, v in metrics.items()}))
    out["bf16"] = dict(steps=rows, all_reduce_ms=event_ms(events),
                       expect=expected_launches(
                           cfg, forwards=2 + (3 if cfg.itm_hardneg_chunk
                                              else 1)),
                       queue_total=int(tr.queue.total))
    del tr, batch
    torch.cuda.empty_cache()
    return out


def job_det(rank: int, world: int, d: str, card: str, mesh) -> dict:
    """Phases 39-40's ranks: one bf16 detection step at DET_SIZE of this
    rank's image (DDP_DET_BOXES boxes), counted, with the global ATSS
    positives and the parameters and EMA against rank 0's; the fp32
    gradients at DET_GRAD_SIZE (rank 0 saves them); the evaluation's
    predictions of this rank's images, gathered (rank 0 saves them)."""
    from fiber_torch.parallel.data_parallel import global_count
    from fiber_torch.parallel.mesh import shard_batch
    out = {}
    t0 = time.perf_counter()
    tr = det_trainer(mesh=mesh)
    batch = shard_batch(det_box_batch(tr.cfg, DDP_DET_BOXES, SEED + 30),
                        tr.group)
    local_pos = det_num_pos(tr.cfg, batch)
    num_pos = global_count(local_pos, tr.group)
    events = timed_all_reduce()
    metrics, seconds, gib, launches, routes = counted_step(
        lambda: tr.train_step(batch))
    same = ranks_bit_equal(list(tr.params) + list(tr.ema), tr.group)
    out["bf16"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                       seconds=seconds, gib=gib, k1=launches[0],
                       k2=launches[1], k1_tc=routes[0]["tc"],
                       k2_tc=routes[1]["tc"], num_pos=int(num_pos),
                       local_num_pos=int(local_pos),
                       boxes=int(batch["gt_valid"].sum()), bit_equal=same,
                       all_reduce_ms=event_ms(events),
                       expect=[sum(tr.cfg.depths)] * 2,
                       phase_seconds=time.perf_counter() - t0)
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    grads, metrics, _ = det_fp32_grads(mesh)
    if rank == 0:
        torch.save(grads, os.path.join(d, "det_grads.pt"))
    out["fp32"] = dict(metrics=metrics, seconds=time.perf_counter() - t0,
                       gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    preds = eval_predictions(eval_model())
    if rank == 0:
        torch.save(preds, os.path.join(d, "preds.pt"))
    out["eval"] = dict(seconds=time.perf_counter() - t0,
                       gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       images=len(preds))
    return out


def job_tp(rank: int, world: int, d: str, card: str) -> dict:
    """Phase 56's ranks, the same world on a (1, world) mesh: (a) phase
    38's fp32 step on all its rows, every gathered gradient saved by rank
    0, the replicated parameters, EMA and queue against rank 0's; (b) the
    parameter, gradient and AdamW elements this rank holds, and what
    `tp_sharding` reckons; (c) TP_STEPS bf16 steps of DDP_BF16_B rows,
    counted, with the model group's collectives."""
    from fiber_torch.parallel import tp
    from fiber_torch.parallel.data_parallel import all_gather_objects
    from fiber_torch.parallel.mesh import (create_mesh, model_group,
                                           shard_batch)
    t0 = time.perf_counter()
    mesh = create_mesh(data=1, model=world)
    tr, metrics, seconds, gib = ddp_fp32_step(mesh)
    grads = torch.cat([tr._whole(p, p.grad).reshape(-1) for p in tr.params])
    if rank == 0:
        torch.save(grads.cpu(), os.path.join(d, "tp_grads.pt"))
    del grads
    whole = [i for i, p in enumerate(tr.params) if id(p) not in tr._shards]
    # the queue's input rings compared by their non-zero rows (4 of 4096
    # slots: the whole fp32 ring is 7.25 GB to send through the host)
    q, group = tr.queue, model_group(mesh)
    rings = ring_rows(q)
    slots = all_gather_objects({k: v[0].tolist() for k, v in rings.items()},
                               group)
    same = slots[0] == slots[1] and ranks_bit_equal(
        [tr.params[i] for i in whole] + [tr.ema[i] for i in whole]
        + [q.image_feats, q.text_feats, q.ptr, q.total]
        + [v[1].to(q.ptr.device) for v in rings.values()], group)
    moments = [v for st in tr.optimizer.state.values()
               for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
    out = dict(fp32=dict(
        metrics=metrics, seconds=seconds, gib=gib, bit_equal=same,
        sharded=len(tr.tp_plan), whole=tp.local_numel(tr.model),
        expect=tp.local_numel(tr.model, tr.tp_plan, world),
        params=sum(p.numel() for p in tr.params),
        grads=tr.flat_grad.numel(), adamw=sum(v.numel() for v in moments),
        phase_seconds=time.perf_counter() - t0))
    del tr, moments
    torch.cuda.empty_cache()
    cfg = FiberConfig.base(loss_names=("itm", "mlm", "itc"), warmup_steps=0,
                           learning_rate=1e-4)
    tr = CoarseTrainer(cfg, device="cuda", seed=SEED, mesh=mesh)
    seeded_gates(tr.model, SEED)
    batch = tr.to_device(shard_batch(train_batch(cfg, DDP_BF16_B, SEED),
                                     tr.group))
    rows = []
    for step in range(TP_STEPS):
        tp.reset_collectives()
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: tr.train_step(batch))
        rows.append(dict(step=step, seconds=seconds, gib=gib,
                         k1=launches[0], k2=launches[1],
                         k1_tc=routes[0]["tc"], k2_tc=routes[1]["tc"],
                         collectives=dict(tp.COLLECTIVES),
                         **{k: float(v) for k, v in metrics.items()}))
    out["bf16"] = dict(steps=rows, expect=expected_launches(
        cfg, forwards=2 + (3 if cfg.itm_hardneg_chunk else 1)))
    del tr, batch
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def job_pretrain_det(rank: int, world: int, d: str, card: str) -> dict:
    """Phases 38-40's and 56's ranks, one process a rank: one gloo group
    for `job_pretrain`'s work, then `job_det`'s, then `job_tp`'s."""
    from fiber_torch.parallel.mesh import create_mesh
    from fiber_torch.parallel.multihost import maybe_initialize_distributed
    maybe_initialize_distributed(backend="gloo")
    mesh = create_mesh()
    out = dict(pretrain=job_pretrain(rank, world, d, card, mesh),
               det=job_det(rank, world, d, card, mesh),
               tp=job_tp(rank, world, d, card))
    torch.distributed.destroy_process_group()
    return out


DDP_JOBS = {"cli": job_cli, "pretrain_det": job_pretrain_det}


def ddp_worker(argv: list) -> int:
    job, rank, world, d, card = (argv[0], int(argv[1]), int(argv[2]),
                                 argv[3], argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = DDP_JOBS[job](rank, world, d, card)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def per_tensor_rel_err(got: torch.Tensor, want: torch.Tensor,
                       names) -> dict:
    """{name: max |got - want| / max |want|} over each parameter's slice of
    two flat gradients; an attention key bias, whose exact gradient is
    zero (the softmax over the keys does not see q . b_k), is measured
    against its key weight's max-abs, as in `det_grads_card_vs_host`."""
    slices, off = {}, 0
    for n, k in names:
        slices[n] = slice(off, off + k)
        off += k
    out = {}
    for n, s in slices.items():
        ref = n[:-len("bias")] + "weight" if n.endswith("key.bias") else n
        out[n] = float((got[s] - want[s]).abs().max()
                       / want[slices[ref]].abs().max().clamp_min(1e-30))
    return out


def subprocess_round(card: str, meanwhile=None) -> dict:
    """Phases 29b, 35 and 37, five processes started at once on the card
    (`run_procs`, within DDP_TIMEOUT_S): the three detection tools
    (`det_tool_results`) and phase 37's two runs; `meanwhile()` (when
    given) in this process while they run.  Each process's seconds and
    step times are taken while the others share the card and the host."""
    with tempfile.TemporaryDirectory() as logs, \
            tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db:
        specs = {**det_tool_specs(),
                 **ddp_specs("cli", 1, da, card, group=True, tag="cli_nccl"),
                 **ddp_specs("cli", 1, db, card, group=False,
                             tag="cli_none")}
        outs = run_procs(specs, logs, DDP_TIMEOUT_S, meanwhile)[0]
        runs = {"nccl": ddp_results(outs, 1, da, "cli_nccl")[0],
                "none": ddp_results(outs, 1, db, "cli_none")[0]}
        pa = torch.load(os.path.join(da, "params.pt"))
        pb = torch.load(os.path.join(db, "params.pt"))
    tools = det_tool_results(card, outs)
    world1 = ddp_world1_pretrain(card, runs, pa, pb,
                                 {k: outs[f"cli_{k} rank 0"][3] for k in runs})
    return dict(tools=tools, world1=world1)


def ddp_world1_pretrain(card: str, runs: dict, pa: torch.Tensor,
                        pb: torch.Tensor, seconds: dict) -> dict:
    """Phase 37: `python -m fiber_torch.cli` on `pretrain_mlm_itm_itc`
    (FIBER-Base 384^2, full width, bf16 over fp32, synthetic data, B =
    CLI_B, DDP_STEPS steps) in a subprocess under an NCCL process group of
    one rank (FIBER_COORDINATOR, FIBER_NUM_PROCESSES=1, FIBER_PROCESS_ID=0),
    and in one without (`runs`, their parameters after the run `pa`, `pb`;
    `subprocess_round`): every step's losses and the parameters bit-equal;
    143 K1 and 71 K2 a step on `tc`; step wall ms and the gradient
    all-reduce's ms (CUDA events)."""
    same_params = bool(torch.equal(bits(pa), bits(pb)))
    loss_keys = [k for k in runs["none"]["steps"][0] if k.endswith("_loss")]
    same_losses = all(a[k] == b[k] for a, b in zip(runs["nccl"]["steps"],
                                                  runs["none"]["steps"])
                      for k in loss_keys)
    info(phase="ddp_world1_pretrain", card=card,
         backend=runs["nccl"]["backend"], world=1,
         steps=DDP_STEPS, batch=CLI_B,
         step_ms={k: [r["seconds"] * 1e3 for r in v["steps"]]
                  for k, v in runs.items()},
         all_reduce_ms=runs["nccl"]["all_reduce_ms"],
         losses={k: [{n: r[n] for n in loss_keys} for r in v["steps"]]
                 for k, v in runs.items()},
         launches=[(r["k1_launches"], r["k2_launches"])
                   for r in runs["nccl"]["steps"]],
         max_memory_gib={k: v["gib"] for k, v in runs.items()},
         seconds=seconds, losses_bit_equal=same_losses,
         params_bit_equal=same_params, group=runs["nccl"]["group"])
    if not (runs["nccl"]["group"] and not runs["none"]["group"]
            and same_losses and same_params
            and len(runs["nccl"]["steps"]) == DDP_STEPS):
        raise AssertionError("ddp_world1_pretrain: the NCCL run of one rank "
                             "and the run with no group differ")
    return dict(k1=runs["nccl"]["steps"][-1]["k1_launches"],
                k2=runs["nccl"]["steps"][-1]["k2_launches"])


def ddp_2rank(card: str, meanwhile=None) -> tuple:
    """Phases 38-40 and 56: one launch of two ranks (`job_pretrain_det`)
    for the three jobs, one process's references taken on the card while
    they run, then `meanwhile()` (when given) while they still run (the
    ranks' times are a check, not a speed: gloo, one card)."""
    def during():
        refs = ddp_pretrain_reference(), ddp_det_reference()
        if meanwhile is not None:
            meanwhile()
        return refs

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks, (pre_ref, det_ref) = ddp_run("pretrain_det", 2, d, card,
                                            during=during)
        seconds = time.perf_counter() - t0
        pre_got = torch.load(os.path.join(d, "pretrain_grads.pt"))
        rings = [torch.load(os.path.join(d, f"rings_rank{r}.pt"))
                 for r in range(len(ranks))]
        tp_got = torch.load(os.path.join(d, "tp_grads.pt"))
        det_got = torch.load(os.path.join(d, "det_grads.pt"))
        preds = torch.load(os.path.join(d, "preds.pt"), weights_only=False)
    return (ddp_2rank_pretrain(card, pre_ref, [r["pretrain"] for r in ranks],
                               pre_got, rings, seconds),
            ddp_2rank_det(card, det_ref, [r["det"] for r in ranks], det_got,
                          preds, seconds),
            tp_2rank_pretrain(card, pre_ref, [r["tp"] for r in ranks],
                              tp_got))


def ddp_pretrain_reference() -> dict:
    """Phase 38's one process: the fp32 step on the global batch."""
    t0 = time.perf_counter()
    tr, metrics, step_s, gib = ddp_fp32_step()
    out = dict(grads=tr.flat_grad.cpu(), metrics=metrics, step_s=step_s,
               gib=gib, names=[(n, p.numel())
                               for n, p in tr.model.named_parameters()],
               rings=ring_rows(tr.queue), ring_bytes=tr.queue.input_bytes())
    del tr
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def rings_match(ref: dict, block: dict, lo: int, slots: int) -> bool:
    """A rank's input-ring block (`ring_rows`) bit-equal to slots [lo, lo +
    slots) of one process's rings: the same non-zero slots, the same
    rows."""
    for k, (want_slots, want_rows) in ref.items():
        inside = (want_slots >= lo) & (want_slots < lo + slots)
        got_slots, got_rows = block[k]
        if not (torch.equal(got_slots, want_slots[inside])
                and torch.equal(bits(got_rows), bits(want_rows[inside]))):
            return False
    return True


def ddp_2rank_pretrain(card: str, ref: dict, ranks: list, got: torch.Tensor,
                       rings: list, seconds: float) -> dict:
    """Phase 38: two ranks of `CoarseTrainer` on one card with gloo,
    FIBER-Base 384^2 at full width.  (a) fp32 (TF32 off), no dropout, EMA,
    B = 2 a rank on fixed negatives: one `train_step` against one
    process's step on the global batch of DDP_FP32_B: the losses within
    DDP_LOSS_RTOL, every summed gradient within GRAD_RTOL of its tensor's
    max-abs.  (b) Both ranks' parameters, EMA, feature rings, `ptr` and
    `total` bit-equal after it; each rank holds half the queue's input
    rings, and its block is bit-equal to the same slots of the one
    process's queue (`rings` are the ranks' `ring_rows`: the rings differ
    across the ranks by design).  (c) DDP_STEPS bf16 steps of DDP_BF16_B
    rows a rank on one batch:
    finite losses, a falling MLM loss, 143 K1 and 71 K2 a rank a step on
    `tc`.  gloo's collectives take these CUDA tensors through the host:
    its times are a check, not a speed.  `ref` is
    `ddp_pretrain_reference()`, `ranks` the ranks' results, `got` rank 0's
    summed gradient, `seconds` the two-rank launch's (`ddp_2rank`)."""
    want_grads, want, one_s, one_gib, names, one_seconds = (
        ref["grads"], ref["metrics"], ref["step_s"], ref["gib"],
        ref["names"], ref["seconds"])
    rel = per_tensor_rel_err(got, want_grads, names)
    worst = max(rel, key=rel.get)
    loss_err = {k: abs(ranks[0]["fp32"]["metrics"][k] - v)
                / max(abs(v), 1e-30) for k, v in want.items()
                if k.endswith("_loss")}
    bf16 = [r["bf16"] for r in ranks]
    steps = bf16[0]["steps"]
    expect = tuple(bf16[0]["expect"])
    launches_ok = all((s["k1"], s["k2"]) == expect and s["k1_tc"] == expect[0]
                      and s["k2_tc"] == expect[1]
                      for b in bf16 for s in b["steps"])
    mlm = [s["mlm_loss"] for s in steps]
    fp32 = [r["fp32"] for r in ranks]
    blocks_equal = [rings_match(ref["rings"], block, f["ring_lo"],
                                f["ring_slots"])
                    for block, f in zip(rings, fp32)]
    half = all(2 * f["ring_bytes"] == ref["ring_bytes"] for f in fp32)
    info(phase="ddp_2rank_pretrain", card=card, backend="gloo", world=2,
         staged_through_host=True, fp32_batch=DDP_FP32_B,
         loss_rel_err=loss_err, limit_loss=DDP_LOSS_RTOL,
         worst_grad_rel_err=rel[worst], worst_tensor=worst,
         grad_limit=GRAD_RTOL, tensors=len(rel),
         fp32_step_ms=[r["fp32"]["seconds"] * 1e3 for r in ranks],
         one_process_step_ms=one_s * 1e3, one_process_gib=one_gib,
         fp32_max_memory_gib=[r["fp32"]["gib"] for r in ranks],
         bit_equal_params_ema_feature_rings=[f["bit_equal"] for f in fp32],
         input_ring_bytes=[f["ring_bytes"] for f in fp32],
         one_process_input_ring_bytes=ref["ring_bytes"],
         input_ring_blocks_bit_equal=blocks_equal,
         filled_slots={k: v[0].tolist() for k, v in ref["rings"].items()},
         bf16_rows_a_rank=DDP_BF16_B,
         bf16_step_ms=[[s["seconds"] * 1e3 for s in b["steps"]]
                       for b in bf16],
         all_reduce_ms=[b["all_reduce_ms"] for b in bf16],
         bf16_max_memory_gib=[max(s["gib"] for s in b["steps"])
                              for b in bf16],
         launches=[[(s["k1"], s["k2"]) for s in b["steps"]] for b in bf16],
         expected_launches=expect, mlm_losses=mlm,
         total_losses=[s["total_loss"] for s in steps],
         queue_total=[b["queue_total"] for b in bf16],
         seconds=seconds, one_process_seconds=one_seconds)
    if not (max(loss_err.values()) <= DDP_LOSS_RTOL
            and rel[worst] <= GRAD_RTOL
            and all(f["bit_equal"] for f in fp32)
            and all(blocks_equal) and half):
        raise AssertionError(f"ddp_2rank_pretrain: two ranks against one "
                             f"process: losses {loss_err}, gradient "
                             f"{worst} {rel[worst]}, bit-equal "
                             f"{[f['bit_equal'] for f in fp32]}, ring "
                             f"blocks {blocks_equal}, ring bytes "
                             f"{[f['ring_bytes'] for f in fp32]} of "
                             f"{ref['ring_bytes']}")
    if not (launches_ok and all(np.isfinite(s[k]) for b in bf16
                                for s in b["steps"] for k in s
                                if k.endswith("_loss"))
            and mlm[-1] < mlm[0]):
        raise AssertionError(f"ddp_2rank_pretrain: bf16 steps {bf16}")
    return dict(k1=steps[-1]["k1"], k2=steps[-1]["k2"])


def tp_2rank_pretrain(card: str, ref: dict, ranks: list,
                      got: torch.Tensor) -> dict:
    """Phase 56: tensor parallelism over two model ranks on one card with
    gloo, FIBER-Base 384^2 at full width.  (a) phase 38's fp32 step on all
    DDP_FP32_B rows against `ref`, phase 38's one-process step: the losses
    within DDP_LOSS_RTOL, every gathered gradient (`got`, rank 0's) within
    GRAD_RTOL of its tensor's max-abs; the replicated parameters, EMA and
    queue bit-equal across the model ranks.  (b) Each rank's parameter,
    gradient and AdamW elements as `tp_sharding` reckons them.  (c)
    TP_STEPS bf16 steps: finite losses, 143 K1 and 71 K2 a rank a step on
    `tc`; the model group's all-gathers and all-reduces a step, their
    bytes (gloo through the host: a check, not a speed)."""
    rel = per_tensor_rel_err(got, ref["grads"], ref["names"])
    worst = max(rel, key=rel.get)
    fp32 = [r["fp32"] for r in ranks]
    loss_err = {k: abs(fp32[0]["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in ref["metrics"].items() if k.endswith("_loss")}
    held_ok = all(f["params"] == f["grads"] == f["expect"]
                  and f["adamw"] == 2 * f["expect"] for f in fp32)
    bf16 = [r["bf16"] for r in ranks]
    expect = tuple(bf16[0]["expect"])
    launches_ok = all((s["k1"], s["k2"]) == expect and s["k1_tc"] == expect[0]
                      and s["k2_tc"] == expect[1]
                      for b in bf16 for s in b["steps"])
    finite = all(np.isfinite(s[k]) for b in bf16 for s in b["steps"]
                 for k in s if k.endswith("_loss"))
    steps = bf16[0]["steps"]
    info(phase="tp_2rank_pretrain", card=card, backend="gloo", world=2,
         mesh=[1, 2], staged_through_host=True, fp32_batch=DDP_FP32_B,
         sharded_leaves=fp32[0]["sharded"], loss_rel_err=loss_err,
         limit_loss=DDP_LOSS_RTOL, worst_grad_rel_err=rel[worst],
         worst_tensor=worst, grad_limit=GRAD_RTOL, tensors=len(rel),
         bit_equal_replicated=[f["bit_equal"] for f in fp32],
         whole_params=fp32[0]["whole"], params_a_rank=fp32[0]["params"],
         param_share=fp32[0]["params"] / fp32[0]["whole"],
         reckoned=fp32[0]["expect"], grads_a_rank=fp32[0]["grads"],
         adamw_a_rank=fp32[0]["adamw"],
         param_grad_adamw_bytes_a_rank=4 * (fp32[0]["params"]
                                            + fp32[0]["grads"]
                                            + fp32[0]["adamw"]),
         fp32_step_ms=[f["seconds"] * 1e3 for f in fp32],
         one_process_step_ms=ref["step_s"] * 1e3,
         fp32_max_memory_gib=[f["gib"] for f in fp32],
         one_process_gib=ref["gib"], bf16_rows=DDP_BF16_B,
         bf16_step_ms=[[s["seconds"] * 1e3 for s in b["steps"]]
                       for b in bf16],
         bf16_max_memory_gib=[max(s["gib"] for s in b["steps"])
                              for b in bf16],
         launches=[[(s["k1"], s["k2"]) for s in b["steps"]] for b in bf16],
         expected_launches=expect,
         collectives_a_step=[s["collectives"] for s in steps],
         total_losses=[s["total_loss"] for s in steps],
         seconds=[r["seconds"] for r in ranks])
    if not (max(loss_err.values()) <= DDP_LOSS_RTOL
            and rel[worst] <= GRAD_RTOL
            and all(f["bit_equal"] for f in fp32) and held_ok):
        raise AssertionError(f"tp_2rank_pretrain: two model ranks against "
                             f"one process: losses {loss_err}, gradient "
                             f"{worst} {rel[worst]}, bit-equal "
                             f"{[f['bit_equal'] for f in fp32]}, held "
                             f"{fp32}")
    if not (launches_ok and finite):
        raise AssertionError(f"tp_2rank_pretrain: bf16 steps {bf16}")
    return dict(k1=steps[-1]["k1"], k2=steps[-1]["k2"])


def ddp_det_reference() -> dict:
    """Phases 39-40's one process: the global ATSS positives, the fp32
    gradients on the global batch and on weights moved by one rounding
    (three draws), the evaluation's predictions."""
    cfg = DetectorConfig(image_size=DET_SIZE)
    t0 = time.perf_counter()
    out = dict(num_pos=int(det_num_pos(cfg, det_box_batch(
        cfg, DDP_DET_BOXES, SEED + 30))))
    out["grads"], out["metrics"], out["names"] = det_fp32_grads()
    out["moved"] = [det_fp32_grads(eps=2.0 ** -23, seed=SEED + i)[0]
                    for i in (14, 15, 16)]
    model = eval_model()
    out["preds"] = eval_predictions(model)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def ddp_2rank_det(card: str, ref: dict, ranks: list, got: torch.Tensor,
                  preds: list, seconds: float) -> dict:
    """Phases 39-40: two ranks with gloo.  FIBER-B detection at DET_SIZE,
    bf16 over fp32, one image a rank (DDP_DET_BOXES boxes, so the ranks'
    positives differ): one `DetectionTrainer.train_step`; the global ATSS
    positives equal one process's on both images, the parameters and EMA
    bit-equal across the ranks, 24 K1 and 24 K2 a rank on `tc`.  The fp32
    gradients at DET_GRAD_SIZE (two images, one a rank) against one
    process's within GRAD_RTOL of each tensor's max-abs, or twice one
    process's own spread (its weights moved by one rounding) where that
    is larger (three runs on weights moved by one rounding; an attention key
    bias against its key weight) (`ddp_2rank_det`).  Then `eval_det`'s loop at DET_SIZE,
    one image a pass, over DDP_EVAL_IMAGES images split over the ranks:
    the merged predictions bit-equal to one process's
    (`ddp_2rank_eval_det`).  `ref` is `ddp_det_reference()`, `ranks` the
    ranks' results, `got` and `preds` rank 0's gradient and the merged
    predictions, `seconds` the two-rank launch's (`ddp_2rank`)."""
    want_pos, want, want_m, names, moved, want_preds, one_seconds = (
        ref[k] for k in ("num_pos", "grads", "metrics", "names", "moved",
                         "preds", "seconds"))
    err = per_tensor_rel_err(got, want, names)
    spreads = [per_tensor_rel_err(m, want, names) for m in moved]
    spread = {n: max(sp[n] for sp in spreads) for n in err}
    limit = {n: max(GRAD_RTOL, 2.0 * spread[n]) for n in err}
    over = sorted(((n, err[n], limit[n]) for n in err if err[n] > limit[n]),
                  key=lambda r: -r[1])
    worst = max(err, key=err.get)
    bf16 = [r["bf16"] for r in ranks]
    loss_err = {k: abs(ranks[0]["fp32"]["metrics"][k] - v)
                / max(abs(v), 1e-30) for k, v in want_m.items()
                if k != "finite"}
    info(phase="ddp_2rank_det", card=card, backend="gloo", world=2,
         staged_through_host=True, image_size=list(DET_SIZE),
         boxes=[b["boxes"] for b in bf16],
         local_num_pos=[b["local_num_pos"] for b in bf16],
         num_pos=[b["num_pos"] for b in bf16], one_process_num_pos=want_pos,
         launches=[(b["k1"], b["k2"]) for b in bf16],
         expected_launches=bf16[0]["expect"],
         bit_equal_params_ema=[b["bit_equal"] for b in bf16],
         step_ms=[b["seconds"] * 1e3 for b in bf16],
         all_reduce_ms=[b["all_reduce_ms"] for b in bf16],
         max_memory_gib=[b["gib"] for b in bf16],
         total_loss=bf16[0]["metrics"]["total_loss"],
         finite=bf16[0]["metrics"]["finite"],
         fp32_image_size=list(DET_GRAD_SIZE), fp32_loss_rel_err=loss_err,
         worst_grad_rel_err=err[worst], worst_tensor=worst,
         worst_spread=max(spread.values()), grad_limit=GRAD_RTOL,
         tensors_on_the_spread_limit=sum(v > GRAD_RTOL
                                         for v in limit.values()),
         over_limit=over[:8], fp32_max_memory_gib=[r["fp32"]["gib"]
                                                   for r in ranks],
         rank_seconds=[b["phase_seconds"] for b in bf16], seconds=seconds,
         one_process_seconds=one_seconds)
    equal = len(preds) == len(want_preds) and all(
        set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(preds, want_preds))
    info(phase="ddp_2rank_eval_det", card=card, backend="gloo", world=2,
         images=len(preds), image_size=list(DET_SIZE), batch=1,
         classes=len(eval_det.COCO_CLASSES), chunk=DET_EVAL_CHUNK,
         detections=[len(p["scores"]) for p in preds],
         bit_equal_to_one_process=equal,
         seconds=[r["eval"]["seconds"] for r in ranks],
         max_memory_gib=[r["eval"]["gib"] for r in ranks])
    if not (all(b["num_pos"] == want_pos for b in bf16)
            and all(b["bit_equal"] for b in bf16)
            and all((b["k1"], b["k2"]) == tuple(b["expect"])
                    and (b["k1_tc"], b["k2_tc"]) == tuple(b["expect"])
                    for b in bf16)
            and bf16[0]["metrics"]["finite"] == 1.0
            and np.isfinite(bf16[0]["metrics"]["total_loss"])):
        raise AssertionError(f"ddp_2rank_det: {bf16}, one process's "
                             f"positives {want_pos}")
    if over or max(loss_err.values()) > DET_LOSS_RTOL:
        raise AssertionError(f"ddp_2rank_det: fp32 gradients over their "
                             f"limit {over[:8]}, losses {loss_err}")
    if not equal or not all(len(p["scores"]) for p in preds):
        raise AssertionError("ddp_2rank_eval_det: the merged predictions "
                             "differ from one process's, or are empty")
    return dict(k1=bf16[0]["k1"], k2=bf16[0]["k2"])

# ---- the early-fusion head and the backbone registry (phases 41-47) -----
# K1 and K2 at the registry's Swin-T shapes at DET_SIZE (window 7, N = 49,
# hd = 32, shifted): windows after padding and heads, by stage
SWINT_WINDOWS = ((29, 48, 3), (15, 24, 6), (8, 12, 12), (4, 6, 24))
SWINT_WIN = 7
GLIP = dict(early_fuse="mha-b")
GLIP_REPS = 3
REGISTRY_SWINT = ("SWINT-FPN-RETINANET", "SWINT-VL-FPN-RETINANET",
                  "SWINT-V2-FPN-RETINANET", "SWINT-V2-VL-FPN-RETINANET")
REGISTRY_CONV = ("R-50-FPN", "R-101-FPN", "EFFICIENTNET-BIFPN",
                 "EFFICIENTNET-B7-BIFPN", "FBNET-FPN-RETINANET",
                 "FBNET-C-FPN-RETINANET")
REGISTRY_FP32_SIZE, REGISTRY_RTOL = (224, 320), 1e-3
# the Swin-T trunks' K1 launches a forward: stages 1-3 (10 blocks) where
# the last stage attends jointly with the text, all 12 blocks otherwise
SWINT_K1 = {"SWINT-FPN-RETINANET": 12, "SWINT-VL-FPN-RETINANET": 10,
            "SWINT-V2-FPN-RETINANET": 12, "SWINT-V2-VL-FPN-RETINANET": 10}
REGISTRY_T = 256


def swint_kernel_checks() -> tuple:
    """Phases 41-42: K1 (`k1_check_swint`) and K2 (`k2_check_swint`) at
    the four Swin-T stage shapes of DET_SIZE, B = DET_B, shifted, fp32 and
    bf16, against their plain versions within the existing bounds (bf16 K1
    within one ulp or one flipped probability, K2 within `k2_check`'s),
    with kernel, plain, SDPA and bound ms, on a generator of their own."""
    gen = torch.Generator().manual_seed(SEED + 15)
    k1, k2 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for s, (nh, nw, h) in enumerate(SWINT_WINDOWS):
            with torch.inference_mode():
                k1[(dtype, s)] = check_kernel(
                    gen, DET_B, nh * SWINT_WIN, nw * SWINT_WIN, SWINT_WIN, h,
                    32, dtype, shifted=True, timed=True,
                    phase="k1_check_swint")
            with torch.no_grad():
                k2[(dtype, s)] = check_bwd_kernel(
                    gen, DET_B, nh * SWINT_WIN, nw * SWINT_WIN, SWINT_WIN, h,
                    32, dtype, shifted=True, timed=True,
                    phase="k2_check_swint")
            torch.cuda.empty_cache()
    return k1, k2


def glip_train_800(card: str) -> dict:
    """Phase 44: FIBER-B with GLIP's early fusion (VLFuse MHA-B and a BERT
    layer before each DyConv) under `DetectionTrainer` at DET_SIZE, B =
    DET_B, bf16 over fp32: DET_TRAIN_STEPS steps on one batch, each counted
    (24 K1 and 24 K2 on `tc`), finite losses, the total loss of the last
    step below the first's, step wall ms and peak memory."""
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    trainer = det_trainer(**GLIP)
    cfg = trainer.cfg
    info(phase="glip_train_model", seconds=time.perf_counter() - t0,
         base_gib=base,
         params=sum(p.numel() for p in trainer.params),
         groups={g["name"]: sum(p.numel() for p in g["params"])
                 for g in trainer.optimizer.param_groups})
    batch = det_batch(cfg, DET_B, SEED + 11)
    blocks = sum(cfg.depths)
    steps = []
    for step in range(DET_TRAIN_STEPS):
        metrics, seconds, gib, launches, routes = counted_step(
            lambda: trainer.train_step(batch))
        row = dict(phase="glip_train_800", step=step, card=card,
                   wall_ms=seconds * 1e3, max_memory_gib=gib,
                   k1_launches=launches[0], k2_launches=launches[1],
                   k1_route_launches=routes[0], k2_route_launches=routes[1],
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        check_det_launches("glip_train_800", launches, routes,
                           (blocks, blocks))
    total = [r["total_loss"] for r in steps]
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.startswith("loss") or k == "total_loss") or \
            not all(r["finite"] == 1.0 for r in steps):
        raise AssertionError(f"glip_train_800: non-finite losses {steps}")
    if not total[-1] < total[0]:
        raise AssertionError(f"glip_train_800: the total loss did not fall: "
                             f"{total}")
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"],
                k1_routes=steps[-1]["k1_route_launches"],
                k2_routes=steps[-1]["k2_route_launches"],
                wall_ms=[r["wall_ms"] for r in steps],
                max_memory_gib=max(r["max_memory_gib"] for r in steps))


def glip_fp32_card_vs_host(card: str) -> None:
    """Phase 45: the early-fusion detector in fp32 (TF32 off) at
    DET_GRAD_SIZE, B = 1, full width and depth, with BERT and then CLIP
    language layers: every
    head output at every level on the card against the host's plain path
    within DET_RTOL of its max-abs; every gradient within GRAD_RTOL of its
    max-abs, or twice the host's own spread where that is larger, against
    the nearer of the host's two orders (`det_grads_card_vs_host`'s rule:
    the spread over one thread's order and weights moved by one
    rounding); every loss within DET_LOSS_RTOL."""
    threads = torch.get_num_threads()
    for lang_model in ("bert", "clip"):
        cfg = DetectorConfig(image_size=DET_GRAD_SIZE, lang_model=lang_model,
                             **GLIP)
        batch = next(synthetic_batches(cfg, 1, seed=SEED + 16))
        out = det_grad_runs(cfg, batch, (
            ("card", "cuda", threads, False, 0.0),
            ("host", "cpu", threads, True, 0.0),
            ("host_1_thread", "cpu", 1, True, 0.0),
            ("host_perturbed", "cpu", threads, True, 2.0 ** -23)))
        cl, cg, launches, routes = out["card"][:4]
        hl, hg = out["host"][:2]
        h1g, hpg = out["host_1_thread"][1], out["host_perturbed"][1]
        ch, hh = out["card"][5], out["host"][5]
        head_err = {k: [float((c - h).abs().max() / h.abs().max()
                              .clamp_min(1e-30))
                        for c, h in zip(ch[k], hh[k])] for k in hh}
        worst_head = max(max(v) for v in head_err.values())
        loss_err = {k: abs(cl[k] - hl[k]) / max(abs(hl[k]), 1e-30)
                    for k in hl}
        diff = lambda a, b, n: (a[n] - b[n]).abs().max() / grad_scale(hg, n)
        err = {n: float(torch.minimum(diff(cg, hg, n), diff(cg, h1g, n)))
               for n in hg}
        spread = {n: float(torch.maximum(diff(h1g, hg, n), diff(hpg, hg, n)))
                  for n in hg}
        limit = {n: max(GRAD_RTOL, 2.0 * spread[n]) for n in hg}
        over = [(n, err[n], limit[n]) for n in hg if err[n] > limit[n]]
        early = [n for n in hg if ".dyhead_tower." in n
                 and not n.split(".dyhead_tower.")[1].split(".")[1] in (
                     "DyConv", "AttnConv", "relu", "offset")]
        info(phase="glip_fp32_card_vs_host", card=card, lang_model=lang_model,
             image_size=list(DET_GRAD_SIZE), head_rel_err_by_level=head_err,
             worst_head_rel_err=worst_head, head_limit=DET_RTOL,
             losses=hl, loss_rel_err=loss_err, params=len(hg),
             early_fusion_params=len(early),
             worst_early_fusion_grad_rel_err=max(err[n] for n in early),
             worst_grad_rel_err_and_host_spread=sorted(
                 ((n, err[n], spread[n]) for n in hg),
                 key=lambda r: -r[1])[:8],
             tensors_within_grad_limit=sum(e <= GRAD_RTOL
                                           for e in err.values()),
             tensors_on_the_spread_limit=sum(v > GRAD_RTOL
                                             for v in limit.values()),
             over_limit=over[:8], k1_launches=launches[0],
             k2_launches=launches[1], route_launches=routes,
             seconds={k: v[4] for k, v in out.items()})
        blocks = sum(cfg.depths)
        if (launches != (blocks, blocks)
                or routes[0][FP32_FWD_ROUTE] != blocks
                or routes[1][FP32_ROUTE] != blocks):
            raise AssertionError(f"glip_fp32_card_vs_host ({lang_model}) "
                                 f"launched (K1, K2) {launches} ({routes}), "
                                 f"expected {blocks} each on routes "
                                 f"{FP32_FWD_ROUTE}, {FP32_ROUTE}")
        if (worst_head > DET_RTOL or max(loss_err.values()) > DET_LOSS_RTOL
                or over):
            raise AssertionError(
                f"glip_fp32_card_vs_host ({lang_model}): heads {head_err}, "
                f"losses {loss_err}, gradients over their limit {over[:8]}")


def seeded_backbone(name: str, size: tuple, seed: int) -> tuple:
    """`build_backbone(name, size)` (256 channels) on the host, fp32, its
    parameters drawn from a generator seeded `seed`: matrices and kernels
    normal with std 1 / sqrt(fan in), the position-bias tables N(0, 0.02),
    norm weights and fusion weights 1 + N(0, 0.02), biases N(0, 0.02); the
    layer scales and frozen BatchNorm statistics as built."""
    module, lang_aware = build_backbone(name, size)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if "relative_position" in n:
                p.copy_(0.02 * r)
            elif p.ndim >= 2:
                p.copy_(r * p[0].numel() ** -0.5)
            elif n.endswith(("weight", "_w1", "_w2")):
                p.copy_(1 + 0.02 * r)
            elif not n.endswith(("gamma", "gamma_text")):
                p.copy_(0.02 * r)
    return module, lang_aware


def backbone_inputs(lang_aware: bool, B: int, size: tuple, seed: int,
                    device: str, dtype: torch.dtype) -> tuple:
    """Seeded images (B, H, W, 3) and, for a language-aware backbone, text
    hidden states (B, REGISTRY_T, 768) with the second row padded from
    half its length."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.rand(B, *size, 3, generator=gen)
    if not lang_aware:
        return (images.to(device, dtype),)
    text = torch.randn(B, REGISTRY_T, 768, generator=gen)
    mask = torch.ones(B, REGISTRY_T, dtype=torch.long)
    mask[-1, REGISTRY_T // 2:] = 0
    return (images.to(device, dtype), text.to(device, dtype),
            mask.to(device))


def levels_of(out, lang_aware: bool) -> list:
    return list(out[0] if lang_aware else out)


def backbone_card_vs_host(name: str) -> dict:
    """fp32 (TF32 off) at REGISTRY_FP32_SIZE, B = 1: the five levels on the
    card against the host's plain path, each within REGISTRY_RTOL of its
    max-abs, and the K1 launches (Swin-T on `f32_tiled`)."""
    host, lang_aware = seeded_backbone(name, REGISTRY_FP32_SIZE, SEED + 17)
    host.eval()
    card = copy.deepcopy(host).cuda()
    args = backbone_inputs(lang_aware, 1, REGISTRY_FP32_SIZE, SEED + 18,
                           "cpu", torch.float32)
    with torch.inference_mode():
        reset_counts()
        got = levels_of(card(*(a.cuda() for a in args)), lang_aware)
        launches = window_attention.launches
        routes = dict(window_attention.route_launches)
        want = levels_of(host(*args), lang_aware)
    errs = [float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]
    if len(errs) != 5 or max(errs) > REGISTRY_RTOL:
        raise AssertionError(f"{name}: fp32 card vs host {errs}")
    return dict(rel_err_by_level=errs, k1_launches=launches,
                route_launches=routes)


def registry_forward(name: str, card: str, phase: str) -> tuple:
    """bf16 at DET_SIZE, B = DET_B: the module on the card, one warm-up
    forward, the counts set to 0 just before a counted forward and read
    just after, then GLIP_REPS timed forwards; five finite levels of 256
    channels; the peak memory beside what was allocated before the module
    (`base_gib`: what earlier phases still hold).  Returns (module,
    inputs, row)."""
    base = torch.cuda.memory_allocated() / 2 ** 30
    module, lang_aware = seeded_backbone(name, DET_SIZE, SEED + 19)
    module = module.to("cuda", torch.bfloat16).eval()
    args = backbone_inputs(lang_aware, DET_B, DET_SIZE, SEED + 20, "cuda",
                           torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        module(*args)
        torch.cuda.synchronize()
        reset_counts()
        levels = levels_of(module(*args), lang_aware)
        torch.cuda.synchronize()
        launches = window_attention.launches
        routes = dict(window_attention.route_launches)
        wall = timed_wall(lambda: module(*args), GLIP_REPS)
    shapes = [list(t.shape) for t in levels]
    finite = all(bool(torch.isfinite(t).all()) for t in levels)
    row = dict(phase=phase, card=card, name=name, dtype="bfloat16", B=DET_B,
               image_size=list(DET_SIZE), language_aware=lang_aware,
               params=sum(p.numel() for p in module.parameters()),
               wall_ms=wall, max_memory_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, base_gib=base, level_shapes=shapes, finite=finite,
               k1_launches=launches, route_launches=routes)
    if len(levels) != 5 or not finite or any(sh[1] != 256 for sh in shapes):
        raise AssertionError(f"{phase} {name}: levels {shapes}, finite "
                             f"{finite}")
    return module, args, row


def registry_swint_800(card: str) -> dict:
    """Phase 46: the four Swin-T registry backbones (GLIP-T widths) at
    DET_SIZE, B = DET_B, bf16: forward wall ms and K1 launches by route (10
    a forward for the VL trunks, 12 for the others, all on `tc`); one
    backward of SWINT-VL-FPN-RETINANET in training mode (10 K2 on `tc`,
    every gradient finite); each in fp32 card vs host at
    REGISTRY_FP32_SIZE."""
    out = {}
    for name in REGISTRY_SWINT:
        module, args, row = registry_forward(name, card,
                                             "registry_swint_800")
        row["fp32_card_vs_host"] = backbone_card_vs_host(name)
        info(**row)
        expect = SWINT_K1[name]
        if row["k1_launches"] != expect or row["route_launches"]["tc"] != \
                expect:
            raise AssertionError(f"{name} launched K1 {row['k1_launches']} "
                                 f"times ({row['route_launches']}), expected "
                                 f"{expect} on the tensor cores")
        out[name] = row
        if name == "SWINT-VL-FPN-RETINANET":
            # training mode: drop-path draws from a card generator
            module.train()
            set_generator(module, torch.Generator("cuda").manual_seed(
                SEED + 21))

            def step():
                levels, lang = module(*args)
                loss = sum(t.float().mean() for t in levels) + \
                    lang["hidden"].float().mean()
                loss.backward()
                return loss

            loss, seconds, gib, launches, routes = counted_step(step)
            grads = [p.grad for p in module.parameters()
                     if p.grad is not None]
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            bwd = dict(phase="registry_swint_800_backward", card=card,
                       name=name, wall_ms=seconds * 1e3, max_memory_gib=gib,
                       k1_launches=launches[0], k2_launches=launches[1],
                       k1_route_launches=routes[0],
                       k2_route_launches=routes[1], grads=len(grads),
                       grads_finite=finite, loss=float(loss))
            info(**bwd)
            if (launches[1] != 10 or routes[1]["tc"] != 10 or not finite
                    or len(grads) != sum(1 for _ in module.parameters())):
                raise AssertionError(f"{name} backward: {bwd}")
            out["backward"] = bwd
        del module, args
        torch.cuda.empty_cache()
    return out


def registry_conv_800(card: str) -> dict:
    """Phase 47: the ResNet, EfficientNet-BiFPN and FBNet registry
    backbones at DET_SIZE, B = DET_B, bf16: forward wall ms and peak memory
    (no kernel of the port runs in them); each in fp32 card vs host at
    REGISTRY_FP32_SIZE."""
    out = {}
    for name in REGISTRY_CONV:
        module, args, row = registry_forward(name, card, "registry_conv_800")
        row["fp32_card_vs_host"] = backbone_card_vs_host(name)
        info(**row)
        out[name] = row
        del module, args
        torch.cuda.empty_cache()
    return out



# the FPN levels of DET_GRAD_SIZE (strides 8 ... 128) and the DyHead's width
DEFORM_LEVELS = ((40, 60), (20, 30), (10, 15), (5, 8), (3, 4))
DEFORM_C = 256


def deform_grad_run(device: str, dtype: torch.dtype, seed: int) -> tuple:
    """The modulated deformable convs of the first DyConv at DET_GRAD_SIZE
    (B = 1, 256 channels): for each FPN level its same-level conv, the
    stride-2 conv from the level above and the conv of the level below on
    the reinterpreted buffers, on seeded features, offsets (N(0, 2): the
    samples straddle and leave the borders), masks and weights; the
    gradients of sum(out * g) with seeded cotangents, as fp64 on the host.
    Returns (names, gradients, seconds)."""
    from fiber_torch.detection.deform_conv import modulated_deform_conv2d
    from fiber_torch.detection.dyhead import reinterpret
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen) * s).to(
        device, dtype).requires_grad_(True)
    feats = [r(1, DEFORM_C, h, w) for h, w in DEFORM_LEVELS]
    offs = [r(1, 18, h, w, s=2.0) for h, w in DEFORM_LEVELS]
    masks = [r(1, 9, h, w) for h, w in DEFORM_LEVELS]
    weights = [r(DEFORM_C, DEFORM_C, 3, 3, s=(9 * DEFORM_C) ** -0.5)
               for _ in range(3)]
    bias = r(DEFORM_C, s=0.02)
    sync = torch.cuda.synchronize if device == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    loss = 0.0
    n = len(feats)
    for l in range(n):
        m = torch.sigmoid(masks[l])
        calls = [(feats[l], offs[l], m, weights[1], 1)]
        if l > 0:
            calls.append((feats[l - 1], offs[l], m, weights[2], 2))
        if l < n - 1:
            hu, wu = DEFORM_LEVELS[l + 1]
            calls.append((feats[l + 1], reinterpret(offs[l], hu, wu),
                          reinterpret(m, hu, wu), weights[0], 1))
        for x, off, mk, w, stride in calls:
            out = modulated_deform_conv2d(x, off, mk, w, bias, stride=stride)
            g = torch.randn(out.shape, generator=gen).to(device, dtype)
            loss = loss + (out * g).sum()
    leaves = feats + offs + masks + weights + [bias]
    names = ([f"x{l}" for l in range(n)] + [f"offset{l}" for l in range(n)]
             + [f"mask{l}" for l in range(n)]
             + ["weight_up", "weight_same", "weight_down", "bias"])
    grads = torch.autograd.grad(loss, leaves)
    sync()
    return names, [g.detach().cpu().double() for g in grads], \
        time.perf_counter() - t0


def deform_bwd_card_vs_host(card: str) -> dict:
    """Phase 48: ROADMAP queue 3's suspect, the card's fp32 backward of
    `modulated_deform_conv2d` (its four corner gathers scatter-add in no
    fixed order): on the card the sampling kernel's Function, whose
    backward recomputes the plain version (one launch a conv).  At the first DyConv's shapes (`deform_grad_run`), fp32
    with TF32 off: two card runs against each other, and the card and the
    host's fp32 each against the host's fp64, every gradient over its
    fp64 max-abs.  The card alone is at fault where its error to fp64
    exceeds GRAD_RTOL and four times the host fp32's."""
    t0 = time.perf_counter()
    reset_counts()
    names, card1, s1 = deform_grad_run("cuda", torch.float32, SEED + 31)
    launches = modulated_deform_conv2d.launches
    _, card2, s2 = deform_grad_run("cuda", torch.float32, SEED + 31)
    _, host32, s3 = deform_grad_run("cpu", torch.float32, SEED + 31)
    _, host64, s4 = deform_grad_run("cpu", torch.float64, SEED + 31)
    rel = lambda a, b: [float((x - y).abs().max() / y.abs().max()
                              .clamp_min(1e-300)) for x, y in zip(a, b)]
    card_card, card_64, host_64 = (rel(card1, card2), rel(card1, host64),
                                   rel(host32, host64))
    fault = [n for n, c, h in zip(names, card_64, host_64)
             if c > GRAD_RTOL and c > 4 * h]
    calls = 3 * len(DEFORM_LEVELS) - 2
    row = dict(phase="deform_bwd_card_vs_host", card=card,
               levels=DEFORM_LEVELS, channels=DEFORM_C,
               kernel_launches=launches, convs=calls,
               card_runs_bit_equal=all(v == 0 for v in card_card),
               card_vs_card=dict(zip(names, card_card)),
               card_vs_fp64=dict(zip(names, card_64)),
               host_fp32_vs_fp64=dict(zip(names, host_64)),
               worst_card_vs_fp64=max(card_64),
               worst_host_fp32_vs_fp64=max(host_64), card_at_fault=fault,
               run_seconds=[s1, s2, s3, s4],
               seconds=time.perf_counter() - t0)
    info(**row)
    if launches != calls:
        raise AssertionError(f"deform_bwd_card_vs_host: {launches} sampling "
                             f"kernel launches for {calls} convs: the card "
                             f"did not run through `_DeformConvFunction`")
    if fault or not all(np.isfinite(card_64)):
        raise AssertionError(f"deform_bwd_card_vs_host: the card's fp32 "
                             f"gradients off fp64 where the host's are not: "
                             f"{fault}")
    return row


# ---------------------------------------------------------------------------
# The ROI side and the dense heads on FIBER-B's FPN levels (phases 49, 50)
# ---------------------------------------------------------------------------
# the dense heads and their classes; the 80 COCO classes, with background for
# the box head; the joints; the psroi pool's output channels, group and
# trans classes
ROI_DENSE = (("RPN", 1), ("RETINA", 81), ("FCOS", 80), ("ATSS", 80))
ROI_CLASSES, ROI_JOINTS = 80, 17
ROI_PS = dict(output_dim=8, group_size=7, pooled_size=7, sample_per_part=4,
              trans_std=0.1)
ROI_PS_CLASSES = 2
# phase 49 at DET_SIZE (gt boxes an image, RPN top-k before and after NMS,
# proposals sampled, ROIs of the mask and keypoint heads, PS-ROI boxes,
# set-loss queries); phase 50 at ROI_FP32_SIZE, B = 1, fewer ROIs
ROI_FULL = dict(G=20, pre_nms=1000, post_nms=512, samples=512, mask_rois=128,
                ps_rois=512, queries=100)
ROI_FP32 = dict(G=8, pre_nms=300, post_nms=128, samples=128, mask_rois=8,
                ps_rois=128, queries=100)
ROI_FP32_SIZE, ROI_RTOL = (320, 480), 1e-3
ROI_KP_BIAS = "keypoint.predictor.kps_score_lowres.bias"
ROI_TTA_SCALES = (0.75, 1.0)


def roi_gt(sizes, G: int, canvas: tuple, seed: int) -> dict:
    """Seeded gt of each image inside its (h, w): G boxes (sides 24 px to
    half the image), 1-based labels of ROI_CLASSES, an 8-vertex polygon
    inside each box rasterised at the `canvas` size (host numpy), and
    ROI_JOINTS visible keypoints inside each box."""
    rng = np.random.default_rng(seed)
    B = len(sizes)
    boxes = np.zeros((B, G, 4), np.float32)
    kps = np.zeros((B, G, ROI_JOINTS, 3), np.float32)
    masks = np.zeros((B, G) + tuple(canvas), bool)
    for b, (h, w) in enumerate(sizes):
        bw, bh = rng.uniform(24, w / 2, G), rng.uniform(24, h / 2, G)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes[b] = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
        ang = np.sort(rng.uniform(0, 2 * np.pi, (G, 8)), axis=1)
        rad = rng.uniform(0.4, 1.0, (G, 8))
        px = (x1 + bw / 2)[:, None] + rad * np.cos(ang) * (bw / 2)[:, None]
        py = (y1 + bh / 2)[:, None] + rad * np.sin(ang) * (bh / 2)[:, None]
        for g in range(G):
            poly = np.stack([px[g], py[g]], 1).reshape(-1)
            masks[b, g] = structures.rasterize_polygons([poly], *canvas)
        u = rng.uniform(0.05, 0.95, (G, ROI_JOINTS, 2))
        kps[b, ..., 0] = x1[:, None] + u[..., 0] * bw[:, None]
        kps[b, ..., 1] = y1[:, None] + u[..., 1] * bh[:, None]
        kps[b, ..., 2] = 2
    return dict(boxes=boxes, labels=rng.integers(1, ROI_CLASSES + 1, (B, G)),
                valid=np.ones((B, G), bool), masks=masks, kps=kps)


def roi_draws(B: int, n_anchors: int, n_sample: int, seed: int) -> dict:
    """Seeded uniform keys of the RPN sampler (B, 2, anchors) and the
    proposal sampler (B, 2, proposals + gt), fed to both devices."""
    rng = np.random.default_rng(seed)
    return dict(rpn=rng.uniform(0, 1, (B, 2, n_anchors)).astype(np.float32),
                sample=rng.uniform(0, 1, (B, 2, n_sample)).astype(np.float32))


def roi_heads_build(device: str, C: int, seed: int) -> dict:
    """Every head at full width (C input channels), weights drawn from
    `seed` on the host as flax draws them: the four dense heads of
    `build_head`, the box head (1024 wide, 81 classes), the mask head (80
    classes) and the keypoint head (17 joints, 512 wide, 8 convs)."""
    heads = {name: alt_heads.build_head(name, C, n, device=device,
                                        seed=seed + i)
             for i, (name, n) in enumerate(ROI_DENSE)}
    heads["box"] = roi_heads.BoxHead(C, ROI_CLASSES + 1, device=device,
                                     seed=seed + 10)
    heads["mask"] = roi_heads.MaskHead(C, ROI_CLASSES, device=device,
                                       seed=seed + 11)
    heads["keypoint"] = roi_heads.KeypointHead(C, ROI_JOINTS, device=device,
                                               seed=seed + 12)
    return heads


def dense_loss(name: str, out: dict, anchors, level_sizes, feat_sizes, g,
               keys=None, gen=None) -> dict:
    if name == "RPN":
        return alt_heads.rpn_loss(out, anchors, g["boxes"], g["valid"],
                                  generator=gen, keys=keys)
    if name == "RETINA":
        return alt_heads.retinanet_loss(out, anchors, g["boxes"], g["labels"],
                                        g["valid"], 81)
    if name == "FCOS":
        return alt_heads.fcos_loss(out, feat_sizes, g["boxes"], g["labels"],
                                   g["valid"], ROI_CLASSES)
    return alt_heads.plain_atss_loss(out, anchors, level_sizes, g["boxes"],
                                     g["labels"], g["valid"], ROI_CLASSES)


def roi_suite(levels, image_sizes, gt: dict, heads: dict, dims: dict, *,
              draws=None, gen=None, proposals=None, seed: int = SEED,
              timed: bool = False) -> dict:
    """The ROI side and the dense heads on FPN `levels` ((B, C, H, W) fp32
    per level, strides DetectorConfig's) of images `image_sizes` (B, 2):

    the four dense heads' forward, loss and gradients; `rpn_proposals`;
    per image `sample_proposals` (on `proposals` when given, else the
    RPN's), the box head's loss and gradients over the pooled samples and
    `box_head_inference`; the mask head on the first `mask_rois` sampled
    ROIs (the positives first) against `crop_and_resize` targets, its loss
    and gradients, and on the detections, pasted on the host; the
    keypoint head on the same ROIs with `to_heatmap_targets`, its loss and
    gradients and `heatmaps_to_keypoints`; `deform_psroi_pool` of image
    0's finest level (a seeded 1x1 projection to output_dim x group^2
    channels) over `ps_rois` sampled boxes with seeded offsets, and its
    gradients; `set_criterion` with Hungarian matching on `queries`
    seeded queries and its gradients.  The samplers take `draws` (fed
    keys) or `gen`.  Returns dict(fwd, loss, grad, ints) of named tensors
    and `host` (values for the checks), with `ms` when `timed`."""
    dev = levels[0].device
    B, C = levels[0].shape[:2]
    strides = DetectorConfig().anchor_strides
    feat_sizes = [tuple(l.shape[-2:]) for l in levels]
    per_level = [torch.from_numpy(a).to(dev) for a in fpn_anchors(
        feat_sizes, strides=strides, sizes=DetectorConfig().anchor_sizes)]
    anchors = torch.cat(per_level)
    level_sizes = [len(a) for a in per_level]
    g = {k: torch.from_numpy(v).to(dev) for k, v in gt.items()
         if k != "masks"}
    g["labels"] = g["labels"].long()
    sizes = torch.as_tensor(image_sizes, dtype=torch.float32, device=dev)
    fwd, loss, grad, ints, host, ms = {}, {}, {}, {}, {}, {}
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    t_ms = lambda fn: cuda_time_ms(fn, iters=3, warmup=1) if timed else None

    def backward(name, total, module):
        named = list(module.named_parameters())
        gs = torch.autograd.grad(total, [p for _, p in named])
        grad.update({f"{name}.{k}": v for (k, _), v in zip(named, gs)})

    # ---- the dense heads ------------------------------------------------
    rpn_out = None
    for name, _ in ROI_DENSE:
        head = heads[name]
        out = head(levels)
        keys = None if draws is None else torch.from_numpy(
            draws["rpn"]).to(dev)
        ls = dense_loss(name, out, anchors, level_sizes, feat_sizes, g,
                        keys=keys, gen=gen)
        for k, v in out.items():
            fwd[f"{name}.{k}"] = cat(v).detach()
        loss.update({f"{name}.{k}": v for k, v in ls.items()})
        backward(name, sum(ls.values()), head)
        if name == "RPN":
            rpn_out = {k: [t.detach() for t in v] for k, v in out.items()}
        if timed:
            with torch.no_grad():
                ms[f"{name}_forward"] = t_ms(lambda: head(levels))
    # the RPN's matches and samples of image 0, on fed keys when given
    q = box_iou_legacy(g["boxes"][0], anchors)
    m = matcher.match_quality(q, g["valid"][0], 0.7, 0.3,
                              allow_low_quality=True)
    ints["rpn_matches"] = m
    rk = None if draws is None else torch.from_numpy(draws["rpn"][0]).to(dev)
    ps, ns = matcher.balanced_sample(m >= 0, m == matcher.BELOW_LOW, gen, 256,
                                     0.5, keys=rk)
    ints["rpn_pos_sel"], ints["rpn_neg_sel"] = ps, ns
    locs = torch.cat(alt_heads.fcos_locations(feat_sizes, strides, device=dev))
    ranges = torch.cat([torch.tensor(alt_heads.FCOS_SIZE_RANGES[i],
                                     device=dev).expand(len(a), 2)
                        for i, a in enumerate(per_level)])
    lab, _, pos = alt_heads.fcos_assign(locs, ranges, g["boxes"][0],
                                        g["labels"][0], g["valid"][0])
    ints["fcos_labels"], ints["fcos_pos"] = lab, pos

    # ---- proposals and sampling -----------------------------------------
    with torch.no_grad():
        props, p_scores, p_ok = alt_heads.rpn_proposals(
            rpn_out, per_level, sizes, pre_nms_top_n=dims["pre_nms"],
            post_nms_top_n=dims["post_nms"])
    fwd["proposals"], fwd["proposal_scores"] = props, p_scores
    host["proposal_ok"] = p_ok.cpu()
    host["proposals"] = props.cpu()
    if proposals is not None:
        props, p_ok = (t.to(dev) for t in proposals)
    samples = []
    for b in range(B):
        keys = None if draws is None else torch.from_numpy(
            draws["sample"][b]).to(dev)
        s = roi_heads.sample_proposals(
            props[b], p_ok[b], g["boxes"][b], g["labels"][b], g["valid"][b],
            generator=gen, batch_size=dims["samples"], keys=keys)
        samples.append(s)
        for k in ("selected", "pos", "labels", "matched_gt"):
            ints[f"sample{b}.{k}"] = s[k]
    host["sampled"] = [int(s["selected"].sum()) for s in samples]
    host["sampled_pos"] = [int(s["pos"].sum()) for s in samples]
    level_maps = lambda b: [l[b] for l in levels]

    # ---- the box head -------------------------------------------------------
    pooled = torch.cat([roi_heads.multilevel_roi_align(
        level_maps(b), s["boxes"], 7, strides) for b, s in enumerate(samples)])
    fwd["box_pooled"] = pooled
    cls, reg = heads["box"](pooled)
    fwd["box_cls"], fwd["box_reg"] = cls.detach(), reg.detach()
    bl = roi_heads.box_head_loss(
        cls, reg, torch.cat([s["labels"] for s in samples]),
        torch.cat([s["reg_targets"] for s in samples]),
        torch.cat([s["selected"] for s in samples]),
        torch.cat([s["pos"] for s in samples]))
    loss.update({f"box.{k}": v for k, v in bl.items()})
    backward("box", sum(bl.values()), heads["box"])
    n_roi = len(samples[0]["boxes"])
    dets = []
    with torch.no_grad():
        for b, s in enumerate(samples):
            ok = torch.cat([p_ok[b], g["valid"][b]])
            dets.append(roi_heads.box_head_inference(
                cls[b * n_roi:(b + 1) * n_roi], reg[b * n_roi:(b + 1) * n_roi],
                s["boxes"], ok, sizes[b], ROI_CLASSES + 1,
                score_thresh=0.0))
    # the detections' scores in order (a near tie may swap two boxes)
    fwd["det_scores"] = torch.stack([d[1] for d in dets]).sort(
        dim=1, descending=True).values
    host["dets"] = [[t.cpu() for t in d] for d in dets]
    if timed:
        with torch.no_grad():
            b0 = samples[0]["boxes"]
            ms["roi_align_box"] = t_ms(lambda: roi_heads.multilevel_roi_align(
                level_maps(0), b0, 7, strides))
            ms["box_forward"] = t_ms(lambda: heads["box"](pooled))

    # ---- the mask and keypoint heads on the positives first -----------------
    M = dims["mask_rois"]
    roi = []
    for s in samples:
        order = torch.sort((~s["pos"]).int(), stable=True).indices[:M]
        roi.append({k: s[k][order] for k in ("boxes", "pos", "labels",
                                              "matched_gt")})
    mboxes = torch.cat([r["boxes"] for r in roi])
    mpos = torch.cat([r["pos"] for r in roi])
    mlabels = torch.cat([r["labels"] for r in roi])
    pooled14 = torch.cat([roi_heads.multilevel_roi_align(
        level_maps(b), r["boxes"], 14, strides) for b, r in enumerate(roi)])
    fwd["mask_pooled"] = pooled14
    gt_masks = [structures.SegmentationMasks(
        torch.from_numpy(gt["masks"][b]).to(dev), g["valid"][b])
        for b in range(B)]
    targets = torch.cat([gm.crop_and_resize(r["boxes"], 28,
                                            index=r["matched_gt"])
                         for gm, r in zip(gt_masks, roi)])
    fwd["mask_targets"] = targets
    mlog = heads["mask"](pooled14)
    fwd["mask_logits"] = mlog.detach()
    loss["mask"] = roi_heads.mask_head_loss(mlog, targets, mlabels, mpos)
    backward("mask", loss["mask"], heads["mask"])

    kp_targets = [structures.Keypoints(
        g["kps"][b][r["matched_gt"]], g["valid"][b][r["matched_gt"]])
        .to_heatmap_targets(r["boxes"], 56) for b, r in enumerate(roi)]
    bins = torch.cat([k[0] for k in kp_targets])
    vis = torch.cat([k[1] for k in kp_targets])
    ints["kp_bins"], ints["kp_vis"] = bins, vis
    klog = heads["keypoint"](pooled14)
    fwd["kp_logits"] = klog.detach()
    loss["keypoint"] = roi_heads.keypoint_head_loss(klog, bins, vis, mpos)
    backward("keypoint", loss["keypoint"], heads["keypoint"])
    with torch.no_grad():
        kxy, kscore = roi_heads.heatmaps_to_keypoints(klog, mboxes)
    fwd["keypoints"], fwd["kp_scores"] = kxy, kscore
    if timed:
        with torch.no_grad():
            r0 = roi[0]["boxes"]
            ms["roi_align_mask"] = t_ms(lambda: roi_heads.multilevel_roi_align(
                level_maps(0), r0, 14, strides))
            ms["mask_forward"] = t_ms(lambda: heads["mask"](pooled14))
            ms["keypoint_forward"] = t_ms(lambda: heads["keypoint"](pooled14))

    # the mask head on the detections, pasted on the host (image 0)
    with torch.no_grad():
        d_boxes, d_scores, d_labels, d_ok = dets[0]
        dl = roi_heads.multilevel_roi_align(level_maps(0), d_boxes, 14,
                                            strides)
        probs = torch.sigmoid(heads["mask"](dl).gather(
            1, (d_labels - 1)[:, None, None, None].expand(-1, 1, 28, 28)))[:, 0]
    host["mask_probs"] = probs[d_ok].cpu()
    host["mask_det"] = [t[d_ok].cpu() for t in (d_boxes, d_scores, d_labels)]

    # ---- deformable PS-ROI pooling ------------------------------------------
    gen_h = torch.Generator().manual_seed(seed + 50)
    OD, G7 = ROI_PS["output_dim"], ROI_PS["group_size"]
    w_ps = (torch.randn(OD * G7 * G7, C, generator=gen_h) * C ** -0.5).to(
        dev, levels[0].dtype)
    x_ps = torch.einsum("oc,chw->ohw", w_ps, levels[0][0].detach())
    x_ps = x_ps.detach().requires_grad_(True)
    R_ps = dims["ps_rois"]
    rois_ps = samples[0]["boxes"][:R_ps].detach()
    trans = torch.randn(R_ps, ROI_PS_CLASSES, 2, 7, 7, generator=gen_h).to(dev)
    trans.requires_grad_(True)
    ps_kw = dict(spatial_scale=1.0 / strides[0], **ROI_PS)
    ps_out = deform_psroi_pool(x_ps, rois_ps, trans, **ps_kw)
    fwd["psroi"] = ps_out.detach()
    g_ps = torch.randn(ps_out.shape, generator=gen_h).to(dev)
    gx, gt_ = torch.autograd.grad((ps_out * g_ps).sum(), [x_ps, trans])
    grad["psroi.x"], grad["psroi.trans"] = gx, gt_
    if timed:
        with torch.no_grad():
            ms["deform_psroi_pool"] = t_ms(lambda: deform_psroi_pool(
                x_ps, rois_ps, trans, **ps_kw))

    # ---- the set loss ---------------------------------------------------------
    Q = dims["queries"]
    logits = torch.randn(B, Q, ROI_CLASSES, generator=gen_h).to(dev)
    xy = torch.rand(B, Q, 2, generator=gen_h) * 0.7
    wh = 0.05 + torch.rand(B, Q, 2, generator=gen_h) * 0.25
    scale = sizes.cpu().flip(-1)[:, None, :]
    qboxes = (torch.cat([xy, xy + wh], -1) * scale.repeat(1, 1, 2)).to(dev)
    logits.requires_grad_(True)
    qboxes.requires_grad_(True)
    sl = set_loss.set_criterion(logits, qboxes, g["boxes"], g["labels"] - 1,
                                g["valid"], sizes, num_classes=ROI_CLASSES)
    loss.update({f"set.{k}": v for k, v in sl.items()})
    gl, gb = torch.autograd.grad(sum(sl.values()), [logits, qboxes])
    grad["set.logits"], grad["set.boxes"] = gl, gb
    with torch.no_grad():
        h, w = sizes[:, 0], sizes[:, 1]
        cost = set_loss.set_matching_cost(
            logits, qboxes, g["boxes"], g["labels"] - 1,
            torch.stack([w, h, w, h], 1), use_focal=True)
        cost = torch.where(g["valid"][:, None, :], cost, 1e9)
        ints["hungarian"] = set_loss.hungarian_match(cost, g["valid"])
    return dict(fwd=fwd, loss=loss, grad=grad, ints=ints, host=host, ms=ms)


def roi_checks(what: str, res: dict, image_sizes, dims: dict) -> dict:
    """The phase's checks: every loss and gradient finite; proposals and
    detections finite and inside their images; the valid counts in
    range; each image's Hungarian match a permutation of distinct
    queries.  Returns the counts; raises on the first failure."""
    bad = [k for k, v in list(res["loss"].items()) + list(res["grad"].items())
           if not bool(torch.isfinite(v).all())]
    host, sizes = res["host"], np.asarray(image_sizes, np.float32)

    def inside(boxes, b):
        b_ = boxes.float().numpy()
        return bool(np.isfinite(b_).all() and (b_ >= 0).all()
                    and (b_[..., [0, 2]] <= sizes[b, 1] - 1).all()
                    and (b_[..., [1, 3]] <= sizes[b, 0] - 1).all())

    props_in = all(inside(host["proposals"][b][host["proposal_ok"][b]], b)
                   for b in range(len(sizes)))
    dets_in = all(inside(d[0][d[3]], b) for b, d in enumerate(host["dets"]))
    n_props = host["proposal_ok"].sum(1).tolist()
    n_dets = [int(d[3].sum()) for d in host["dets"]]
    match = res["ints"]["hungarian"].cpu().numpy()
    perm = all(len(set(row.tolist())) == len(row) and
               (row < dims["queries"]).all() for row in match)
    counts = dict(proposals=n_props, sampled=host["sampled"],
                  sampled_pos=host["sampled_pos"], detections=n_dets)
    if (bad or not props_in or not dets_in or not perm
            or not all(0 < n <= dims["post_nms"] for n in n_props)
            or not all(0 < n <= dims["samples"] for n in host["sampled"])
            or not all(n <= dims["samples"] // 4 for n in host["sampled_pos"])
            or not all(0 < n <= 100 for n in n_dets)):
        raise AssertionError(f"{what}: not finite {bad}, proposals inside "
                             f"{props_in}, detections inside {dets_in}, "
                             f"Hungarian a permutation {perm}, {counts}")
    return counts


def roi_levels_800(model, images: np.ndarray, ids, mask) -> tuple:
    """FIBER-B's five FPN levels of `images` (bf16, no grad), with the
    counts set to 0 just before and read just after."""
    dev = model.device
    with torch.no_grad():
        reset_counts()
        levels, _ = model.fusion_backbone(
            torch.from_numpy(images).to(dev, model.cfg.compute_dtype),
            torch.from_numpy(ids).long().to(dev),
            torch.from_numpy(mask).long().to(dev))
        torch.cuda.synchronize()
    return levels, window_attention.launches, dict(
        window_attention.route_launches)


def roi_heads_800(card: str, model) -> dict:
    """Phase 49: the ROI side and the other detection heads on FIBER-B's
    FPN levels at 800x1344 (the model of phase 28, B = DET_B, its images
    and prompt): the fusion backbone and FPN under no_grad with K1 counted
    (24 launches on `tc`), then at full width (FPN 256) in fp32 over the
    bf16 levels with seeded heads and ROI_FULL's sizes, `roi_suite` with
    the samplers drawing from a CUDA generator and `roi_checks`; the
    detections' masks pasted on the host and scored by `coco_map(iou_type=
    "segm")` against the rasterised gt; `im_detect_bbox_aug` over
    `detection_inference` at ROI_TTA_SCALES with the flip (four calls).
    Prints each head's forward ms and ROIAlign's at the box and mask
    sizes (CUDA events), peak memory and the seconds."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    _, ids, mask, agg = det_prompt(DET_CLASSES, cfg.max_query_len)
    images, sizes = det_images(SEED + 5)
    levels, launches, routes = roi_levels_800(
        model, images, np.repeat(ids, DET_B, 0), np.repeat(mask, DET_B, 0))
    expect = sum(cfg.depths)
    if launches != expect or routes["tc"] != expect:
        raise AssertionError(f"roi_heads_800: the backbone launched K1 "
                             f"{launches} times ({routes}), expected {expect} "
                             f"on `tc`")
    levels = [l.float() for l in levels]
    gt = roi_gt(sizes.tolist(), ROI_FULL["G"], DET_SIZE, SEED + 41)
    t_build = time.perf_counter()
    heads = roi_heads_build("cuda", levels[0].shape[1], SEED + 42)
    build_s = time.perf_counter() - t_build
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    t_suite = time.perf_counter()
    res = roi_suite(levels, sizes, gt, heads, ROI_FULL, gen=gen, timed=True)
    torch.cuda.synchronize()
    suite_s = time.perf_counter() - t_suite
    counts = roi_checks("roi_heads_800", res, sizes, ROI_FULL)

    # segm AP of image 0's pasted masks against its rasterised gt
    t_paste = time.perf_counter()
    boxes, scores, labels = (t.float().numpy() if t.is_floating_point()
                             else t.numpy() for t in res["host"]["mask_det"])
    H, W = DET_SIZE
    pasted = structures.paste_masks_in_image(res["host"]["mask_probs"], boxes,
                                             H, W)
    segm = coco_map([{"boxes": boxes, "scores": scores, "labels": labels,
                      "masks": pasted}],
                    [{"boxes": gt["boxes"][0], "labels": gt["labels"][0],
                      "masks": gt["masks"][0]}], iou_type="segm")
    paste_s = time.perf_counter() - t_paste
    # an area range without gt (no small box) scores NaN, as in pycocotools
    if not all(np.isfinite(segm[k]) for k in ("mAP", "AP50", "AR100")):
        raise AssertionError(f"roi_heads_800: segm metrics {segm}")

    # test-time augmentation over detection_inference
    t_tta = time.perf_counter()
    calls = []
    infer = box_aug.detector_infer_fn(model, ids, mask, agg,
                                      pre_nms_thresh=0.0)

    def counted(img, flipped):
        calls.append([list(img.shape[:2]), flipped])
        return infer(img, flipped)

    tta = box_aug.im_detect_bbox_aug(counted, images[0],
                                     scales=ROI_TTA_SCALES, hflip=True)
    tta_s = time.perf_counter() - t_tta
    tb = tta["boxes"]
    tta_ok = bool(len(tb) and np.isfinite(tb).all() and (tb >= -1e-3).all()
                  and (tb[:, [0, 2]] <= DET_SIZE[1] - 1 + 1e-3).all()
                  and (tb[:, [1, 3]] <= DET_SIZE[0] - 1 + 1e-3).all())
    row = dict(phase="roi_heads_800", card=card, B=DET_B,
               image_size=list(DET_SIZE), fpn=[list(l.shape) for l in levels],
               k1_launches=launches, route_launches=routes, dims=ROI_FULL,
               counts=counts, forward_ms=res["ms"],
               losses={k: float(v.detach()) for k, v in res["loss"].items()},
               segm=segm, pasted=len(pasted), tta_calls=calls,
               tta_boxes=len(tb), tta_inside=tta_ok,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=dict(heads_build=build_s, suite=suite_s,
                            paste_segm=paste_s, tta=tta_s,
                            phase=time.perf_counter() - t0))
    info(**row)
    if len(calls) != 2 * len(ROI_TTA_SCALES) or not tta_ok:
        raise AssertionError(f"roi_heads_800: TTA {calls}, boxes inside "
                             f"{tta_ok}")
    return row


def roi_fp32_card_vs_host(card: str) -> dict:
    """Phase 50: `roi_suite` at ROI_FP32_SIZE, B = 1, full width (256
    channels, seeded levels), ROI_FP32's sizes, fp32 (TF32 off) on the card
    and on the host from the same weights, inputs and fed sampler draws,
    the card sampling the host's proposals: every forward tensor and loss
    within ROI_RTOL of the host's max-abs; every gradient within ROI_RTOL
    of it or, where not, within twice the host's own error to an fp64 host
    run (the keypoint logits' bias, whose exact gradient is zero, against
    its weight's max-abs); the integer outputs (the RPN's matches and samples, the FCOS
    assignment, the proposal samples and their gt, the keypoint bins, the
    Hungarian permutation) equal.  The checked card run takes its
    convolutions without cuDNN, whose fp32 algorithms round some
    gradients further apart; a run with cuDNN is reported beside."""
    t0 = time.perf_counter()
    C = DetectorConfig().out_channels
    H, W = ROI_FP32_SIZE
    feat = DetectorConfig(image_size=ROI_FP32_SIZE).feat_sizes()
    rng = np.random.default_rng(SEED + 44)
    levels_np = [rng.standard_normal((1, C, h, w)).astype(np.float32)
                 for h, w in feat]
    sizes = np.array([[H - 16, W - 40]], np.float32)
    gt = roi_gt(sizes.tolist(), ROI_FP32["G"], ROI_FP32_SIZE, SEED + 45)
    n_anchors = sum(h * w for h, w in feat)
    draws = roi_draws(1, n_anchors, ROI_FP32["post_nms"] + ROI_FP32["G"],
                      SEED + 46)

    built = roi_heads_build("cpu", C, SEED + 47)

    def run(device, dtype=torch.float32, proposals=None, cudnn=True):
        heads = {k: copy.deepcopy(h).to(device, dtype)
                 for k, h in built.items()}
        levels = [torch.from_numpy(l).to(device, dtype) for l in levels_np]
        t = time.perf_counter()
        # TF32 stays off under the context (its default would turn it on)
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            res = roi_suite(levels, sizes, gt, heads, ROI_FP32, draws=draws,
                            proposals=proposals)
        if device == "cuda":
            torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t
        return res

    host = run("cpu")
    props = (host["host"]["proposals"], host["host"]["proposal_ok"])
    seconds = {"host": host["seconds"]}
    on_card = run("cuda", proposals=props, cudnn=False)
    card_cudnn = run("cuda", proposals=props)
    counts = roi_checks("roi_fp32_card_vs_host", on_card, sizes, ROI_FP32)
    # the keypoint logits' bias has an exact gradient of zero (each joint's
    # softmax gradient sums to zero, and so does its resize's): its error is
    # measured against its weight's max-abs
    scale_of = {ROI_KP_BIAS: ROI_KP_BIAS[:-len("bias")] + "weight"}

    def rel(a, b, name=None):
        ref = host["grad"][scale_of[name]] if name in scale_of else b
        return float((a.detach().cpu().double() - b.detach().double()).abs()
                     .max() / ref.detach().double().abs().max()
                     .clamp_min(1e-30))

    fwd = {k: rel(on_card["fwd"][k], host["fwd"][k]) for k in host["fwd"]}
    fwd.update({f"loss.{k}": rel(on_card["loss"][k], host["loss"][k])
                for k in host["loss"]})
    grads = {k: rel(on_card["grad"][k], host["grad"][k], k)
             for k in host["grad"]}
    cudnn_grads = {k: rel(card_cudnn["grad"][k], host["grad"][k], k)
                   for k in host["grad"]}
    over = [k for k, v in grads.items() if not v <= ROI_RTOL]
    spread = {}
    if over or any(v > ROI_RTOL for v in cudnn_grads.values()):
        # the host's own spread: its error to an fp64 run
        h64 = run("cpu", torch.float64, proposals=props)
        seconds["host_fp64"] = h64["seconds"]
        spread = {k: rel(host["grad"][k], h64["grad"][k], k)
                  for k in host["grad"]}
    grad_fault = [k for k in over if not grads[k] <= 2 * spread[k]]
    cudnn_over = {k: [v, spread[k]] for k, v in cudnn_grads.items()
                  if v > max(ROI_RTOL, 2 * spread[k])} if spread else {}
    ints = {k: bool(torch.equal(on_card["ints"][k].cpu(), host["ints"][k]))
            for k in host["ints"]}
    row = dict(phase="roi_fp32_card_vs_host", card=card,
               image_size=list(ROI_FP32_SIZE), dims=ROI_FP32, counts=counts,
               worst_fwd=max(fwd.items(), key=lambda kv: kv[1]),
               worst_grad=max(grads.items(), key=lambda kv: kv[1]),
               grads_over_rtol={k: [grads[k], spread[k]] for k in over},
               worst_host_spread=max(spread.values(), default=0.0),
               cudnn_over_limit=cudnn_over, ints_equal=ints, fwd_rel=fwd,
               limit=ROI_RTOL, run_seconds=dict(
                   seconds, card=on_card["seconds"],
                   card_cudnn=card_cudnn["seconds"]),
               seconds=time.perf_counter() - t0)
    info(**row)
    bad_fwd = [k for k, v in fwd.items() if not v <= ROI_RTOL]
    if bad_fwd or grad_fault or not all(ints.values()):
        raise AssertionError(f"roi_fp32_card_vs_host: forwards over "
                             f"{ROI_RTOL} {bad_fwd}, gradients off {grad_fault}"
                             f", integer outputs {ints}")
    return row


# ---------------------------------------------------------------------------
# The evaluators, the fuzzy checkpoint load, the tools over the CLI's
# checkpoints and a NaN dump, and the FLOP summary (phases 51-55)
# ---------------------------------------------------------------------------
# the evaluators' ground truths: boxes an image (small, medium and large in
# turn, the prompt's ten classes in turn), the LVIS vocabulary (the ten
# classes 1-3 rare, 4-6 common, 7-10 frequent), the refexp datasets
EVAL_GT_BOXES = 9
LVIS_CLASSES = 1203
REFEXP_NAMES = ("refcoco", "refcocog")
# the ground truths fed back as detections at score 1 score 1.0 at every
# metric (JAX's evaluators do on `evaluator_gts`: tests/test_torch_
# evaluation.py), within CONTROL_ATOL: the VOC 07 metric sums eleven 1/11
# steps
CONTROL_ATOL = 1e-12
# the NaN dump: the image set to NaN; the tools' subprocesses' time limit
NAN_IMAGE = 1
TOOL_TIMEOUT_S = 300
# the FLOP summary's card-vs-host model: FIBER-Base's structure at half its
# widths (head dim 32) at 192^2 (window 6), stages (2, 2, 6, 2), a 1000-word
# vocabulary, fp32; its images, texts and pair batch
FLOPS_HOST_CFG = dict(image_size=192, swin_embed_dim=64,
                      swin_depths=(2, 2, 6, 2), swin_num_heads=(2, 4, 8, 16),
                      input_image_embed_size=512, vocab_size=1000,
                      text_hidden_size=256, num_text_heads=8,
                      input_text_embed_size=256, hidden_size=256,
                      compute_dtype=torch.float32)
FLOPS_HOST_CORPUS = (2, 2, 4)
TABLE = "relative_position_bias_table"


def evaluator_gts(n_img: int, seed: int) -> list:
    """Seeded ground truths at DET_SIZE: EVAL_GT_BOXES boxes an image with
    COCO crowd, LVIS ignore and VOC difficult flags, LVIS negative and
    not-exhaustive category ids."""
    rng = np.random.default_rng(seed)
    H, W = DET_SIZE
    classes = sorted(eval_det.COCO_CLASSES)
    sides = (20.0, 60.0, 200.0)               # small, medium, large
    gts, k = [], 0
    for _ in range(n_img):
        boxes, labels = [], []
        for j in range(EVAL_GT_BOXES):
            w, h = sides[j % 3] * rng.uniform(0.8, 1.2, 2)
            x0, y0 = rng.uniform(0, W - w), rng.uniform(0, H - h)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(classes[k % len(classes)])
            k += 1
        flags = rng.random((3, EVAL_GT_BOXES))
        gts.append({
            "boxes": np.asarray(boxes), "labels": np.asarray(labels),
            "iscrowd": flags[0] < 0.1,
            "ignore": (flags[1] < 0.1).astype(np.int64),
            "difficult": flags[2] < 0.15,
            "neg_category_ids": rng.integers(1, LVIS_CLASSES + 1,
                                             3).tolist(),
            "not_exhaustive_category_ids": rng.integers(
                1, len(classes) + 1, 1).tolist()})
    return gts


def lvis_frequencies(seed: int) -> dict:
    """{category: "r" | "c" | "f"} over the LVIS_CLASSES vocabulary."""
    rng = np.random.default_rng(seed)
    freq = {c + 1: "rcf"[int(g)]
            for c, g in enumerate(rng.integers(0, 3, LVIS_CLASSES))}
    freq.update({c: "rrrcccffff"[c - 1] for c in eval_det.COCO_CLASSES})
    return freq


def grounding_sets(preds: list, gts: list) -> tuple:
    """Flickr phrases (one a class present in an image: its detections
    score-sorted, its boxes) and refexp referrals (one a non-crowd box: its
    class's detections and scores, the box, REFEXP_NAMES in turn)."""
    phrases, referrals = ([], []), ([], [])
    for p, g in zip(preds, gts):
        order = np.argsort(-p["scores"], kind="mergesort")
        pb, ps, pl = (p[k][order] for k in ("boxes", "scores", "labels"))
        for c in np.unique(g["labels"]):
            phrases[0].append({"boxes": pb[pl == c]})
            phrases[1].append({"boxes": g["boxes"][g["labels"] == c]})
        for box, c, crowd in zip(g["boxes"], g["labels"], g["iscrowd"]):
            if crowd:
                continue
            referrals[0].append({"boxes": pb[pl == c], "scores": ps[pl == c]})
            referrals[1].append({"boxes": box[None], "dataset_name":
                                 REFEXP_NAMES[len(referrals[1]) % 2]})
    return phrases, referrals


def simple_ap50(ev, preds: list, gts: list) -> dict:
    """`match_detections` per image and class at IoU 0.5, then
    `average_precision` per class over the images; their mean."""
    aps = []
    for c in sorted(eval_det.COCO_CLASSES):
        scores, matched, n = [], [], 0
        for p, g in zip(preds, gts):
            d, gm = p["labels"] == c, g["labels"] == c
            scores.append(p["scores"][d])
            matched.append(ev.match_detections(p["boxes"][d], p["scores"][d],
                                               g["boxes"][gm], 0.5))
            n += int(gm.sum())
        aps.append(ev.average_precision(np.concatenate(scores),
                                        np.concatenate(matched), n))
    return {"ap50": float(np.mean(aps))}


def evaluator_suite(ev, preds: list, gts: list, freq: dict) -> tuple:
    """Every evaluator of the module `ev` (the port's; its tests pass JAX's
    too) on the detections `preds` and ground truths `gts`, each timed on
    the host: ({evaluator: metrics}, {evaluator: seconds})."""
    phrases, referrals = grounding_sets(preds, gts)
    groups = {c: freq[c] for c in eval_det.COCO_CLASSES}
    calls = {
        "coco_map": lambda: ev.coco_map(preds, gts),
        "simple_ap50": lambda: simple_ap50(ev, preds, gts),
        "box_proposal_ar": lambda: ev.box_proposal_ar(preds, gts),
        "flickr_grounding_recall": lambda: ev.flickr_grounding_recall(
            *phrases, ks=(1, 5, 10, -1)),
        "refexp_precision": lambda: ev.refexp_precision(*referrals),
        "refexp_accuracy": lambda: {"P@1": ev.refexp_accuracy(*referrals)},
        "lvis_fixed_ap": lambda: ev.lvis_fixed_ap(preds, gts,
                                                  class_groups=groups),
        "voc_detection_map": lambda: ev.voc_detection_map(preds, gts),
        "lvis_classic_eval": lambda: ev.lvis_classic_eval(preds, gts, freq),
    }
    out, seconds = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
    return out, seconds


def flat_metrics(results: dict) -> dict:
    """{"<evaluator>/<metric>[/<class>]": float} of the number leaves
    (box_proposal_ar's recalls array and counts left out)."""
    out = {}
    for name, metrics in results.items():
        for k, v in metrics.items():
            if isinstance(v, dict):
                out.update({f"{name}/{k}/{c}": float(x) for c, x in v.items()})
            elif isinstance(v, float):
                out[f"{name}/{k}"] = v
    return out


def ground_truth_control(gts: list) -> list:
    """The ground truths as detections at score 1."""
    return [{"boxes": g["boxes"], "labels": g["labels"],
             "scores": np.ones(len(g["boxes"]))} for g in gts]


def det_evaluators_800(card: str, model) -> dict:
    """Phase 51: after `det_eval`, on its bf16 800x1344 model:
    `eval_predictions` (DDP_EVAL_IMAGES images, ten classes in chunks of
    DET_EVAL_CHUNK, one image a pass: 24 K1 launches a forward, all on
    `tc`) scored against `evaluator_gts` by every evaluator of
    `fiber_torch/detection/evaluation.py` (`evaluator_suite`, LVIS over
    LVIS_CLASSES categories), each timed on the host: every metric finite
    in [0, 1]; the ground truths fed back as detections at score 1 give
    1.0 at every metric."""
    gts = evaluator_gts(DDP_EVAL_IMAGES, SEED + 13)
    freq = lvis_frequencies(SEED + 14)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    preds = eval_predictions(model)
    predict_s = time.perf_counter() - t0
    launches = window_attention.launches
    routes = dict(window_attention.route_launches)
    chunks = -(-len(eval_det.COCO_CLASSES) // DET_EVAL_CHUNK)
    expect = sum(model.cfg.depths) * DDP_EVAL_IMAGES * chunks
    results, seconds = evaluator_suite(evaluation, preds, gts, freq)
    vals = flat_metrics(results)
    control, control_s = evaluator_suite(evaluation,
                                         ground_truth_control(gts), gts,
                                         freq)
    cvals = flat_metrics(control)
    bad = sorted(k for k, v in vals.items()
                 if not (np.isfinite(v) and 0.0 <= v <= 1.0))
    not_one = {k: v for k, v in cvals.items()
               if not abs(v - 1.0) <= CONTROL_ATOL}
    info(phase="det_evaluators_800", card=card, images=DDP_EVAL_IMAGES,
         detections=[len(p["scores"]) for p in preds],
         gt_boxes=[len(g["boxes"]) for g in gts],
         lvis_categories=LVIS_CLASSES, predict_seconds=predict_s,
         k1_launches=launches, expected_k1=expect, route_launches=routes,
         host_seconds=seconds, control_host_seconds=control_s,
         metrics=vals, out_of_range=bad, control_not_one=not_one)
    if launches != expect or routes["tc"] != expect:
        raise AssertionError(f"det_evaluators_800: K1 {launches} launches "
                             f"({routes}), expected {expect} on `tc`")
    if bad or not_one or set(cvals) != set(vals):
        raise AssertionError(f"det_evaluators_800: metrics outside [0, 1] "
                             f"{bad}; control not 1.0 at {not_one}")
    return dict(k1=launches, routes=routes, seconds=seconds)


def fuzzy_load_576(card: str) -> dict:
    """Phase 52 (while phases 53-54's tools run): the port's seeded FIBER-Base 384^2 VQA state_dict (window
    12, 529-row bias tables) written as a .pth under a `module.` prefix, as
    a released Lightning checkpoint keys it, and fuzzy-loaded
    (`utils/fuzzy_load.py::load_into_model`) into `task_finetune_vqa`
    (576^2, window 18): every bias table resized to 1225 rows, every other
    key matched, none skipped or left over but `alpha_t2i` (JAX's
    `merge_into` skips it); then one bf16 VQA forward on the card, 24 K1
    launches on `tc_long`, the logits finite and bit-equal to those of a
    model given the same tables resized on the host through
    `load_state_dict(strict=True)`."""
    src_cfg, cfg = task_finetune_vqa(image_size=384), task_finetune_vqa()
    w0, w1 = src_cfg.derived_window_size, cfg.derived_window_size
    src = FiberCoarse(src_cfg, device="cuda", seed=SEED + 11)
    seeded_gates(src, SEED + 11)
    sd = {k: v.cpu() for k, v in src.state_dict().items()}
    del src
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fiber_base_384.pth")
        t0 = time.perf_counter()
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                    "epoch": 9}, path)
        save_s = time.perf_counter() - t0
        model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
        ref = copy.deepcopy(model)
        t0 = time.perf_counter()
        report = fuzzy_load.load_into_model(model, path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    after = model.state_dict()
    tables = sorted(k for k in after if TABLE in k)
    resized = {k: [int(sd[k].shape[0]), int(after[k].shape[0])]
               for k in tables}
    used = {m.split(" <- ")[1] for m in report["matched"]}
    left = sorted(set(map(fuzzy_load.strip_key, sd)) - used)
    extra = [k for k in report["skipped_shape"] + report["unmatched_model"]
             + left if "alpha_t2i" not in k]
    ref.load_state_dict({k: torch.from_numpy(
        fuzzy_load.resize_relative_position_bias_table(v.numpy(), w0, w1))
        if TABLE in k else v for k, v in sd.items()}, strict=True)
    images, ids, masks = corpus(cfg, 2, 2, SEED)
    logits = []
    with torch.inference_mode():
        x = (torch.from_numpy(images).to("cuda", cfg.compute_dtype),
             torch.from_numpy(ids).cuda(), torch.from_numpy(masks).cuda())
        for m in (model, ref):
            reset_counts()
            logits.append(m.vqa_logits(m.infer(*x)["cls_feats"]).float())
            if m is model:
                launches = window_attention.launches
                routes = dict(window_attention.route_launches)
    finite = bool(torch.isfinite(logits[0]).all())
    equal = bool(torch.equal(logits[0], logits[1]))
    expect = sum(cfg.swin_depths)
    info(phase="fuzzy_load_576", card=card, checkpoint_bytes=size,
         save_seconds=save_s, load_seconds=load_s,
         matched=len(report["matched"]), model_keys=len(after),
         skipped_shape=report["skipped_shape"],
         unmatched_model=report["unmatched_model"], loaded_unused=left,
         tables=len(tables), table_rows=sorted(set(map(tuple,
                                                       resized.values()))),
         k1_launches=launches, route_launches=routes, logits_finite=finite,
         logits_bit_equal=equal,
         max_abs_logit=logits[0].abs().max().item())
    if (extra or len(report["matched"]) != len(after)
            or any(r != [(2 * w0 - 1) ** 2, (2 * w1 - 1) ** 2]
                   for r in resized.values())
            or len(tables) != sum(cfg.swin_depths)):
        raise AssertionError(f"fuzzy_load_576: keys not loaded {extra}, "
                             f"tables {resized}")
    if launches != expect or routes["tc_long"] != expect or not (
            finite and equal):
        raise AssertionError(f"fuzzy_load_576: K1 {launches} ({routes}), "
                             f"logits finite {finite}, bit-equal {equal}")
    del model, ref
    torch.cuda.empty_cache()
    return dict(k1=launches, routes=routes)


def cli_tools_round(card: str, ckpt_dir: str, trainer, meanwhile=None):
    """Phases 53 and 54, inside `cli_pretrain`'s directory, with `trainer`
    the resumed run's: a NaN dump of a CLI_B batch (image NAN_IMAGE set to
    NaN) with the trainer's parameters, then `python -m
    fiber_torch.tools.eval_all` over the run's checkpoints and `python -m
    fiber_torch.tools.debug_nan` on the dump as a user runs them, the two
    at once (`run_procs`), while this process restores the last
    checkpoint into `trainer` and evaluates it on the tool's batch, then
    calls `meanwhile()` (when given); returns what that returned."""
    cfg = trainer.cfg
    saved = CheckpointManager(ckpt_dir).steps()
    with tempfile.TemporaryDirectory() as d:
        batch = next(cli.synthetic_batches(cfg, CLI_B, SEED + 12))
        batch["image"][NAN_IMAGE] = np.nan
        t0 = time.perf_counter()
        dump = dump_training_state(d, trainer.step, batch,
                                   trainer.model.state_dict())
        dump_s = time.perf_counter() - t0
        specs = {
            "eval_all": ([sys.executable, "-m", "fiber_torch.tools.eval_all",
                          "--dir", ckpt_dir], None),
            "debug_nan": ([sys.executable, "-m",
                           "fiber_torch.tools.debug_nan", dump], None)}

        def during():
            mgr = CheckpointManager(ckpt_dir)
            trainer.load_state_dict(mgr.restore(saved[-1]))
            want = eval_all.eval_metrics(trainer, next(
                cli.synthetic_batches(cfg, eval_all.EVAL_BATCH)), 0)
            return want, meanwhile() if meanwhile is not None else None

        outs, (want, got) = run_procs(specs, d, TOOL_TIMEOUT_S, during)
    eval_all_ckpts(card, outs["eval_all"], saved, want)
    debug_nan_replay(card, outs["debug_nan"], batch, dump_s)
    return got


def eval_all_ckpts(card: str, out: tuple, saved: list, want: dict) -> None:
    """Phase 53: `eval_all` over `cli_pretrain`'s checkpoints: exit 0, one
    line a saved step, in order, every metric finite, the last step's line
    equal to `want` (`eval_step` of a trainer restored in this process on
    the same batch and generator seed)."""
    rc, text, err, seconds = out
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    finite = all(np.isfinite(v) for r in rows for v in r.values())
    last_equal = bool(rows) and rows[-1] == {"step": saved[-1], **want}
    info(phase="eval_all_ckpts", card=card, rc=rc, seconds=seconds,
         saved=saved, rows=rows, finite=finite, reference=want,
         last_equal=last_equal, stderr=err[-2000:] if rc else "")
    if rc != 0 or [r["step"] for r in rows] != saved or not (
            finite and last_equal):
        raise AssertionError(f"eval_all_ckpts: rc {rc}, rows {rows}, "
                             f"saved {saved}, in-process {want}")


def debug_nan_replay(card: str, out: tuple, batch: dict,
                     dump_s: float) -> None:
    """Phase 54: `debug_nan` on the dump: exit 0, the report under float32
    and bfloat16, each with every loss term, and the terms that read image
    NAN_IMAGE (ITC, ITM, the total, and MLM where its text has masked
    tokens) non-finite under both, the others finite."""
    rc, text, err, seconds = out
    report = json.loads(text) if rc == 0 else {}
    reads = {"itc_loss", "itm_loss", "total_loss"}
    if (batch["text_labels_mlm"][NAN_IMAGE] != -100).any():
        reads.add("mlm_loss")
    nonfinite = {dt: sorted(k for k, v in terms.items()
                            if k.endswith("_loss") and not v["finite"])
                 for dt, terms in report.items()}
    info(phase="debug_nan_replay", card=card, rc=rc, seconds=seconds,
         dump_seconds=dump_s, report=report, nonfinite_losses=nonfinite,
         expected_nonfinite=sorted(reads), stderr=err[-2000:] if rc else "")
    if rc != 0 or set(report) != {"float32", "bfloat16"} or any(
            not {"mlm_loss", "itc_loss", "itm_loss", "total_loss"}
            <= set(terms) for terms in report.values()) or any(
            set(v) != reads for v in nonfinite.values()):
        raise AssertionError(f"debug_nan_replay: rc {rc}, non-finite "
                             f"{nonfinite}, expected {sorted(reads)}")


def window_flops_per_image(cfg: FiberConfig, stage: int) -> int:
    """One image's K1 FLOPs in one Swin block of `stage` (4 nW N^2 C)."""
    g = cfg.stage_resolution(stage)[0]
    win = min(cfg.derived_window_size, g)
    return profiling.window_attention_flops(
        1, (g // win) ** 2, win * win, 1, cfg.stage_dim(stage))


def rerank_flops(model: FiberCoarse, images: np.ndarray, ids: np.ndarray,
                 masks: np.ndarray, pair_batch: int) -> dict:
    """`summarize_model` of the ITM rerank of `model` (the trunk of the
    images, then the fused tail over every image's texts, pair_batch pairs
    a forward), and its K1 FLOPs (the counted `fiber_torch::count_flops`
    calls; none on the host, whose plain window attention is counted op by
    op) and launches."""
    with torch.inference_mode():
        img_emb, txt_emb = retrieval.encode_corpus(model, images, ids, masks,
                                                   batch_size=len(images))
        itc = retrieval.itc_score_matrix(img_emb, txt_emb)

        def rerank():
            return retrieval.itm_rerank_matrix(model, images, ids, masks, itc,
                                               rerank_topk=len(ids),
                                               pair_batch=pair_batch)
        reset_counts()
        t0 = time.perf_counter()
        # an outer counter sees every op the inner one counts: the K1 share
        with FlopCounterMode(display=False) as counter:
            summary = profiling.summarize_model(rerank, model)
        seconds = time.perf_counter() - t0
    k1 = counter.get_flop_counts()["Global"].get(
        torch.ops.fiber_torch.count_flops, 0)
    return dict(summary, count_params=profiling.count_params(model),
                k1_flops=int(k1), outer_flops=float(counter.get_total_flops()),
                k1_launches=window_attention.launches, seconds=seconds)


def summarize_model_384(card: str, model: FiberCoarse, images: np.ndarray,
                        ids: np.ndarray, masks: np.ndarray,
                        pair_batch: int) -> dict:
    """Phase 55, inside phase 5 on its model and corpus:
    `utils/profiling.py::summarize_model` on the FIBER-Base 384^2 bf16
    rerank: `params` equal to `count_params`, the K1 FLOPs the kernel
    reports equal to the analytic window-attention count; then a narrower
    FIBER at 192^2 (FLOPS_HOST_CFG) in fp32 on the card and on the host,
    the same seeded model and inputs: the same FLOPs."""
    cfg = model.cfg
    n_img, n_txt = len(images), len(ids)
    t0 = time.perf_counter()
    full = rerank_flops(model, images, ids, masks, pair_batch)
    fused2 = cfg.num_fuse_block - cfg.swin_depths[3]
    d = cfg.swin_depths
    f = [window_flops_per_image(cfg, s) for s in range(4)]
    analytic = (n_img * (d[0] * f[0] + d[1] * f[1] + (d[2] - fused2) * f[2])
                + n_img * n_txt * (fused2 * f[2] + d[3] * f[3]))
    small = FiberConfig.base(**FLOPS_HOST_CFG)
    n_img, n_txt, pb = FLOPS_HOST_CORPUS
    x = corpus(small, n_img, n_txt, SEED)
    runs = {}
    for device in ("cuda", "cpu"):
        m = FiberCoarse(small, device=device, seed=SEED).eval()
        seeded_gates(m, SEED)
        runs[device] = rerank_flops(m, *x, pb)
        del m
    info(phase="summarize_model_384", card=card, rerank=full,
         k1_flops_analytic=analytic, k1_share=full["k1_flops"] / full["flops"],
         host_cfg=str(FLOPS_HOST_CFG), card_small=runs["cuda"],
         host_small=runs["cpu"], seconds=time.perf_counter() - t0)
    on_card, on_host = runs["cuda"], runs["cpu"]
    if not (full["params"] == full["count_params"]
            and np.isfinite(full["flops"]) and full["k1_flops"] == analytic
            and full["outer_flops"] == full["flops"]
            and on_card["flops"] == on_host["flops"] > 0
            and on_card["k1_launches"] > 0 and on_host["k1_flops"] == 0
            and on_card["params"] == on_host["params"]):
        raise AssertionError(f"summarize_model_384: {full}, analytic K1 "
                             f"{analytic}; 192^2 card {on_card}, host "
                             f"{on_host}")
    return full


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    info(phase="device", nvidia_smi=card, kind=kind, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 2. build ----------------------------------------------------------
    # every nvcc starts now; K3's two sources (the build's longest) finish
    # in a thread while phases 3-8, which do not launch K3, run
    t_build = time.perf_counter()
    k3_sources = ["swin_stage", "swin_stage_tc", "swin_stage_tc_long",
                  "swin_stage_tf32", k3_ops._TF32_TIMED]
    sources = ["window_attention", "window_attention_tc",
               "window_attention_tc_long", "window_attention_f32",
               "window_attention_bwd", "window_attention_bwd_tc",
               "window_attention_bwd_tc_long", "window_attention_bwd_tf32",
               "window_attention_heads", "window_attention_heads_tc",
               "window_attention_heads_tc_long",
               "window_attention_heads_f32", "deform_im2col"]
    k3_build = ThreadPoolExecutor(max_workers=1).submit(
        lambda: (_build.build(k3_sources), time.perf_counter() - t_build))
    took = _build.build(sources)
    info(phase="build", seconds=time.perf_counter() - t_build,
         per_source=took, ptxas=ptxas_lines(sources))

    # ---- 3. K1 against its plain version ----------------------------------
    gen = torch.Generator().manual_seed(SEED)
    base = FiberConfig.base()
    win = base.derived_window_size
    rows, det_rows = {}, {}
    # `old` takes the draws `gen` would take if the detection stages 2-4
    # drew from a generator of their own (as they once did), so that
    # k1_check_long also runs on those draws (k1_check_long_old_draws)
    old = torch.Generator().manual_seed(SEED)

    def check_both(*args, **kw):
        consume_draws(old, *args[:6], shifted=kw["shifted"])
        return check_kernel(gen, *args, **kw)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for B in K1_BATCHES:
                for s in range(4):
                    g = base.stage_resolution(s)[0]
                    rows[(dtype, B, s)] = check_both(
                        B, g, g, win, base.swin_num_heads[s], 32, dtype,
                        shifted=g > win, timed=B == REPORT_SHAPE[1])
            g = base.stage_resolution(0)[0]
            check_both(2, g, g, win, 4, 32, dtype, shifted=False,
                       timed=False)                   # broadcast bias
            check_both(2, 7, 21, 7, 4, 32, dtype, shifted=True,
                       timed=False)                   # N = 49, nW = 3
            # the detection stages at 800 x 1344 (DET_WINDOWS), all on the
            # shared generator: the draws on which a one-ulp bound was found
            # too tight for the long K1 (ROADMAP queue 2 item 2)
            for s, (nh, nw, h) in enumerate(DET_WINDOWS):
                check = check_both if s == 0 else functools.partial(
                    check_kernel, gen)
                det_rows[(dtype, s)] = check(
                    DET_B, nh * win, nw * win, win, h, 32, dtype,
                    shifted=True, timed=True, phase="k1_check_detection")
            torch.cuda.empty_cache()
    # K1 at FIBER's 576^2 windows (18 x 18, N = 324), every stage
    cap_cfg = task_finetune_caption_mle()
    win18 = cap_cfg.derived_window_size
    long_rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                g = cap_cfg.stage_resolution(s)[0]
                long_rows[(dtype, s)] = check_kernel(
                    gen, K1_LONG_B, g, g, win18, cap_cfg.swin_num_heads[s],
                    32, dtype, shifted=g > win18, timed=True,
                    phase="k1_check_long")
                torch.cuda.empty_cache()
            g = cap_cfg.stage_resolution(0)[0]
            check_kernel(gen, 2, g, g, win18, 4, 32, dtype, shifted=False,
                         timed=False, phase="k1_check_long")  # broadcast
        for s in (0, 2):
            long_row_times(gen, cap_cfg, s, K1_LONG_B)
        # the same checks, untimed, on the draws `old` holds
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                g = cap_cfg.stage_resolution(s)[0]
                check_kernel(old, K1_LONG_B, g, g, win18,
                             cap_cfg.swin_num_heads[s], 32, dtype,
                             shifted=g > win18, timed=False,
                             phase="k1_check_long_old_draws")
            g = cap_cfg.stage_resolution(0)[0]
            check_kernel(old, 2, g, g, win18, 4, 32, dtype, shifted=False,
                         timed=False, phase="k1_check_long_old_draws")
    torch.cuda.empty_cache()

    # ---- 4. K2 against its plain version ----------------------------------
    bwd_rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for B in (2, 3 * TRAIN_B):
                for s in range(4):
                    g = base.stage_resolution(s)[0]
                    bwd_rows[(dtype, B, s)] = check_bwd_kernel(
                        gen, B, g, g, win, base.swin_num_heads[s], 32, dtype,
                        shifted=g > win, timed=B == REPORT_SHAPE_BWD[1])
            g = base.stage_resolution(0)[0]
            check_bwd_kernel(gen, 2, g, g, win, 4, 32, dtype, shifted=False,
                             timed=False)             # broadcast bias
            for s in range(4):
                g = base.stage_resolution(s)[0]
                bwd_split_times(gen, 3 * TRAIN_B, g, g, win,
                                base.swin_num_heads[s], 32, dtype,
                                shifted=g > win,
                                timed=s == REPORT_SHAPE_BWD[2])
    torch.cuda.empty_cache()
    # K2 at the detection stages of 800 x 1344 (DET_WINDOWS), B = DET_B, on
    # a generator of its own so that the other checks keep their draws:
    # bf16 shifted at every stage and unshifted at stage 1, fp32 at stage 1
    det_bwd_rows = {}
    det_bwd_gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for s, (nh, nw, h) in enumerate(DET_WINDOWS):
            det_bwd_rows[(torch.bfloat16, s)] = check_bwd_kernel(
                det_bwd_gen, DET_B, nh * win, nw * win, win, h, 32,
                torch.bfloat16, shifted=True, timed=True,
                phase="k2_check_detection")
        nh, nw, h = DET_WINDOWS[0]
        det_bwd_rows["unshifted"] = check_bwd_kernel(
            det_bwd_gen, DET_B, nh * win, nw * win, win, h, 32,
            torch.bfloat16, shifted=False, timed=True,
            phase="k2_check_detection")
        det_bwd_rows[(torch.float32, 0)] = check_bwd_kernel(
            det_bwd_gen, DET_B, nh * win, nw * win, win, h, 32,
            torch.float32, shifted=True, timed=True,
            phase="k2_check_detection")
    torch.cuda.empty_cache()
    # K2 at FIBER's 576^2 windows (18 x 18, N = 324), every stage
    bwd_long_rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                g = cap_cfg.stage_resolution(s)[0]
                bwd_long_rows[(dtype, s)] = check_bwd_kernel(
                    gen, VQA_B, g, g, win18, cap_cfg.swin_num_heads[s], 32,
                    dtype, shifted=g > win18, timed=True,
                    phase="k2_check_long")
                torch.cuda.empty_cache()
            g = cap_cfg.stage_resolution(0)[0]
            check_bwd_kernel(gen, 2, g, g, win18, 4, 32, dtype, shifted=False,
                             timed=False, phase="k2_check_long")  # broadcast
        for s in (0, 2):
            bwd_long_rows_times(gen, cap_cfg, s, VQA_B)
    torch.cuda.empty_cache()

    # ---- 5. the serving path: FIBER-Base 384^2 bf16 ITM rerank ------------
    cfg = FiberConfig.base()
    n_img, n_txt, pair_batch = 4, 8, 16
    t0 = time.perf_counter()
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    info(phase="model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()))
    images, ids, masks = corpus(cfg, n_img, n_txt, SEED)
    img_emb, txt_emb = retrieval.encode_corpus(model, images, ids, masks,
                                               batch_size=n_img)
    itc = retrieval.itc_score_matrix(img_emb, txt_emb)

    def rerank():
        return retrieval.itm_rerank_matrix(model, images, ids, masks, itc,
                                           rerank_topk=n_txt,
                                           pair_batch=pair_batch)

    rerank()                                          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    scores = rerank()                                 # ends on a host copy
    seconds = time.perf_counter() - t0
    launches = window_attention.launches
    rerank_routes = dict(window_attention.route_launches)
    n_pairs = n_img * n_txt
    trunk_blocks = sum(cfg.swin_depths[:3]) - (cfg.num_fuse_block
                                               - cfg.swin_depths[3])
    n_trunk_batches = 1                               # trunk batch = n_img
    expect = (n_trunk_batches * trunk_blocks
              + n_pairs // pair_batch * cfg.num_fuse_block)
    info(phase="rerank", pairs=n_pairs, seconds=seconds,
         pairs_per_s=n_pairs / seconds, card=card, launches=launches,
         route_launches=rerank_routes, expected_launches=expect)
    if launches != expect or rerank_routes["tc"] != launches:
        raise AssertionError(f"window attention launched {launches} times "
                             f"({rerank_routes} by route) on the main path, "
                             f"expected {expect}, all on the tensor cores")
    top = np.argsort(-itc, axis=1)[:, :n_txt]
    pair_img, pair_txt = np.repeat(np.arange(n_img), n_txt), top.reshape(-1)
    cached = scores[pair_img, pair_txt]
    if cached.shape != (n_pairs,) or not np.isfinite(cached).all():
        raise AssertionError(f"rerank scores not finite: {cached}")

    window_attention.launches = 0
    oracle = retrieval._rank_pairs_full(model, images, ids, masks, pair_img,
                                        pair_txt, pair_batch).cpu().numpy()
    oracle_launches = window_attention.launches
    if oracle_launches != n_pairs // pair_batch * sum(cfg.swin_depths):
        raise AssertionError(f"oracle launched the kernel {oracle_launches} "
                             f"times")
    # bf16: the trunk runs at batch 4 here and at 16 in the oracle, where the
    # matrix products may take other kernels and round differently
    diff = float(np.abs(cached - oracle).max())
    info(phase="rerank_vs_oracle", max_abs_diff=diff,
         max_abs_score=float(np.abs(oracle).max()), atol=5e-2, rtol=5e-2,
         oracle_launches=oracle_launches)
    np.testing.assert_allclose(cached, oracle, atol=5e-2, rtol=5e-2)
    info(phase="rerank_profile", card=card, **profile_share(rerank))
    # ---- 55. the rerank's parameters and FLOPs, card and host ------------
    summarize_model_384(card, model, images, ids, masks, pair_batch)
    del model
    torch.cuda.empty_cache()

    # ---- 6. kernel path on the card against the plain path on the host ----
    cfg32 = FiberConfig.base(compute_dtype=torch.float32)
    gpu = FiberCoarse(cfg32, device="cuda", seed=SEED).eval()
    cpu = FiberCoarse(cfg32, device="cpu", seed=SEED).eval()
    seeded_gates(gpu, SEED)
    seeded_gates(cpu, SEED)
    x = (torch.from_numpy(images[:2]), torch.from_numpy(ids[:2]),
         torch.from_numpy(masks[:2]))
    with torch.inference_mode():
        reset_counts()
        og = gpu.infer(*(t.cuda() for t in x))
        rg = gpu.rank_scores(og["cls_feats"])
        gpu_launches = window_attention.launches
        gpu_routes = dict(window_attention.route_launches)
        oc = cpu.infer(*x)
        rc = cpu.rank_scores(oc["cls_feats"])
    d_cls = (og["cls_feats"].cpu() - oc["cls_feats"]).abs().max().item()
    d_rank = (rg.cpu() - rc).abs().max().item()
    info(phase="fp32_card_vs_host", cls_feats_max_abs_diff=d_cls,
         rank_max_abs_diff=d_rank, atol=1e-3, launches=gpu_launches,
         route_launches=gpu_routes)
    if (gpu_launches != sum(cfg32.swin_depths)
            or gpu_routes[FP32_FWD_ROUTE] != gpu_launches):
        raise AssertionError(f"fp32 forward launched {gpu_launches} times "
                             f"({gpu_routes} by route), expected "
                             f"{sum(cfg32.swin_depths)} on route "
                             f"{FP32_FWD_ROUTE}")
    if not (d_cls <= 1e-3 and d_rank <= 1e-3):
        raise AssertionError("kernel path and plain path disagree at full "
                             "width in fp32")
    del gpu, cpu, og, oc
    torch.cuda.empty_cache()
    # ---- 7. the training path: FIBER-Base 384^2 bf16 train steps ----------
    train = run_training(card)

    # ---- 8. K2 inside the model: fp32 gradients, card against host --------
    fp32_grads = grads_card_vs_host(card)

    # ---- 9. K3 against its plain version ----------------------------------
    t_wait = time.perf_counter()
    took, seconds = k3_build.result()
    info(phase="build_k3", seconds=seconds, per_source=took,
         ptxas=ptxas_lines(k3_sources),
         waited_s=time.perf_counter() - t_wait)
    k3_rows = {}
    stage_blocks = (cfg.swin_depths[0], cfg.swin_depths[1], trunk_blocks
                    - sum(cfg.swin_depths[:2]), cfg.swin_depths[3])
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for B in K3_BATCHES:
                for s, n in enumerate(stage_blocks):
                    # timed at B = 4, and fp32 stage 3 at B = 16 as well
                    k3_rows[(dtype, B, s)] = check_k3(
                        gen, base, s, n, B, dtype,
                        timed=B == REPORT_SHAPE_K3[1]
                        or (dtype, s) == (torch.float32, 2))
                    torch.cuda.empty_cache()
        for s, B in ((2, 4), (2, 16), (3, 4)):
            k3_tile_times(gen, base, s, stage_blocks[s], B,
                          timed=(s, B) == (2, 4))
        k3_check_hd128(torch.Generator().manual_seed(SEED + 22))

    # ---- 10. K3 on the model: the rerank trunk and the ITC image tower ----
    k3_paths = {}
    for dtype in (torch.float32, torch.bfloat16):
        k3_paths[dtype] = k3_on_model(card, dtype)

    # ---- 11. K4 against its plain version ---------------------------------
    k4_rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for B in (2, 16):
                for s in range(4):
                    g = base.stage_resolution(s)[0]
                    k4_rows[(dtype, B, s)] = check_k4(
                        gen, B, g, g, win, base.swin_num_heads[s], 32, dtype,
                        shifted=g > win, timed=B == REPORT_SHAPE_K4[1])
            g = base.stage_resolution(2)[0]             # profile_tail's
            check_k4(gen, PROFILE_BATCH, g, g, win, base.swin_num_heads[2],
                     32, dtype, shifted=True, timed=False)
            g = base.stage_resolution(0)[0]
            check_k4(gen, 2, g, g, win, 4, 32, dtype, shifted=False,
                     timed=False)

    # ---- 12. the rerank tail's components (fiber_torch.tools.profile_tail)
    reset_counts()
    tail = profile_tail.run(FiberConfig.base(), batch=PROFILE_BATCH,
                            device="cuda", iters=20, seed=SEED)
    k4_launches = window_attention_heads.launches
    tail_routes = {"k1": dict(window_attention.route_launches),
                   "k4": dict(window_attention_heads.route_launches)}
    k4_splits = window_attention_heads.last_splits
    for row in tail:
        info(phase="profile_tail", card=card, **row)
    info(phase="profile_tail_routes", k1_launches=window_attention.launches,
         k4_launches=k4_launches, route_launches=tail_routes,
         k4_splits=k4_splits)
    if ([r["component"] for r in tail] != list(profile_tail.COMPONENTS)
            or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in tail)):
        raise AssertionError(f"profile_tail: {tail}")
    if k4_launches == 0:
        raise AssertionError("profile_tail launched K4 no time")
    if (tail_routes["k1"]["tc"] != window_attention.launches
            or tail_routes["k4"]["tc"] != k4_launches):
        raise AssertionError(f"profile_tail's bf16 K1 and K4 launches not "
                             f"all on the tensor cores: {tail_routes}")
    # K4 on the profile's own operands (the same seed), merged back to the
    # packed layout, against the plain version
    with torch.inference_mode():
        comps = profile_tail.build_components(FiberConfig.base(),
                                              PROFILE_BATCH, "cuda", SEED)
        ker, plain = comps["wa_ker"][0](), comps["wa_plain"][0]()
        Bq, nWq, hq, Nq, hdq = ker.shape
        ker = ker.transpose(2, 3).reshape(Bq, nWq, Nq, hq * hdq)
        err = (ker.float() - plain.float()).abs().max().item()
        ok = torch.allclose(ker.float(), plain.float(), **TOL[plain.dtype])
    info(phase="profile_tail_k4_check", shape=list(ker.shape),
         dtype=str(plain.dtype).replace("torch.", ""), max_abs_err=err, ok=ok)
    if not ok:
        raise AssertionError("K4 disagrees with the plain version on "
                             "profile_tail's operands")
    del comps, ker, plain
    torch.cuda.empty_cache()

    # ---- 13. captioning at 576^2 (K1 on the long-window route) -----------
    cap = run_captioning(card)

    # ---- 14. the VQA preset's fused forward at 576^2 ----------------------
    vqa = vqa_at_576(card)

    # ---- 15. VQA finetuning at 576^2: K2 on the long-window route -------
    vqa_train = run_vqa_training(card)
    vqa_grads_card_vs_host(card)

    # ---- 17. K3 and K4 at FIBER's 576^2 windows (N = 324) ---------------
    g3 = cap_cfg.stage_resolution(2)[0]
    k3_long_rows, k4_long_rows = {}, {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            # two blocks of stage 3, the second shifted, then one unshifted
            k3_long_rows[dtype] = check_k3(gen, cap_cfg, 2, 2, K3_LONG_B,
                                           dtype, phase="k3_check_long")
            check_k3(gen, cap_cfg, 3, 1, K3_LONG_B, dtype,
                     phase="k3_check_long")
            torch.cuda.empty_cache()
        k3_split = k3_long_breakdown(cap_cfg, 2, K3_LONG_B)
    k3_tower = k3_tower_576(card)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            g = cap_cfg.stage_resolution(0)[0]
            k4_long_rows[dtype] = check_k4(
                gen, K4_LONG_B, g, g, win18, cap_cfg.swin_num_heads[0], 32,
                dtype, shifted=True, phase="k4_check_long")
            check_k4(gen, K4_LONG_B, g3, g3, win18, cap_cfg.swin_num_heads[2],
                     32, dtype, shifted=True, phase="k4_check_long")
            torch.cuda.empty_cache()
        k1_k4_long_identity(cap_cfg)
    k4_tail = k4_tail_576(card)

    # ---- 18-21. caption finetuning at 576^2 ------------------------------
    cap_train = run_caption_mle_training(card)
    run_caption_gold(card)
    scst = run_scst(card)
    caption_grads_card_vs_host(card)

    # ---- 23-27. the coarse training loop: data, CLI, checkpoints ---------
    device_preprocess(card)
    # (52. a 384^2 checkpoint fuzzy-loaded into the 576^2 preset, while
    # phases 53-54's tools run)
    cli_pt = cli_pretrain(card, meanwhile=lambda: fuzzy_load_576(card))
    fuzzy = cli_pt["meanwhile"]
    cli_staged_step(card)
    irtr = cli_irtr(card)
    irtr384 = irtr["finetune_irtr_itm_itc"]["steps"][-1]
    irtr576 = irtr["finetune_irtr_itc"]["steps"][-1]
    nlvr2 = run_nlvr2_training(card)

    # ---- 28-31. zero-shot grounding detection at 800x1344 ----------------
    det = det_infer_800(card)
    # ---- 49-50. the ROI side and the dense heads on that model's levels --
    roi = roi_heads_800(card, det["model"])
    torch.cuda.empty_cache()
    roi_fp32_card_vs_host(card)
    torch.cuda.empty_cache()
    det_eval(card, det["model"])
    # ---- 51. every evaluator on that model's predictions -----------------
    det_ev = det_evaluators_800(card, det["model"])
    det_demo(card, det.pop("model"))
    torch.cuda.empty_cache()
    det_fp32_card_vs_host(card)

    # ---- 33-36. detection training at 800x1344 ---------------------------
    det_train = det_train_800(card)
    det_ms = det_multiscale(card)

    # ---- 29b, 35, 37. the tools and the world-1 CLI runs, all at once; --
    # while they run, phase 34 (host-heavy: three fp32 passes on the host)
    ddp1 = subprocess_round(card, meanwhile=lambda: det_grads_card_vs_host(
        card))["world1"]

    # ---- 38-40. data parallel on two ranks; while they run, phase 45 -----
    # (host-heavy: four fp32 forward-backward passes on the host a model)
    # ---- 56. tensor parallelism in the same two ranks --------------------
    ddp2, ddpd, tp2 = ddp_2rank(
        card, meanwhile=lambda: glip_fp32_card_vs_host(card))

    # ---- 41-47. GLIP's early fusion and the backbone registry ------------
    swint_k1, swint_k2 = swint_kernel_checks()
    glip = det_infer_800(card, phase="glip_infer_800", reps=GLIP_REPS, **GLIP)
    del glip["model"]
    torch.cuda.empty_cache()
    glip_train = glip_train_800(card)
    reg_swint = registry_swint_800(card)
    registry_conv_800(card)

    # ---- 48. the deformable conv's fp32 backward, card against host -------
    deform_bwd_card_vs_host(card)

    # ---- 16. result --------------------------------------------------------
    shape_keys = ("B", "nW", "N", "h", "hd", "dtype")
    r, rb = rows[REPORT_SHAPE], bwd_rows[REPORT_SHAPE_BWD]
    rl = long_rows[REPORT_SHAPE_LONG]
    rbl = bwd_long_rows[REPORT_SHAPE_BWD_LONG]
    r3, r4 = k3_rows[REPORT_SHAPE_K3], k4_rows[REPORT_SHAPE_K4]
    r3l, r4l = k3_long_rows[torch.bfloat16], k4_long_rows[torch.bfloat16]
    rd = det_rows[(torch.bfloat16, 0)]
    rdb = det_bwd_rows[(torch.bfloat16, 0)]
    rs, rsb = swint_k1[(torch.bfloat16, 0)], swint_k2[(torch.bfloat16, 0)]
    swint_bwd = reg_swint["backward"]
    stage_keys = ("nW", "h", "dtype", "shift_mask", "splits", "ms",
                  "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "max_abs_err")
    k3_launches = k3_paths[torch.bfloat16]
    # fp32 K3 (`tc_f32`): 384^2 stage 3 at B = 4, and its launches on the
    # model (phase 10 in fp32)
    r3f = k3_rows[(torch.float32,) + REPORT_SHAPE_K3[1:]]
    k3_f32 = k3_paths[torch.float32]
    # the fp32 rows: K1 and K4 at 384^2 stage 3, B = 16, K2 there at B = 24
    rf = rows[(torch.float32,) + REPORT_SHAPE[1:]]
    rbf = bwd_rows[(torch.float32,) + REPORT_SHAPE_BWD[1:]]
    r4f = k4_rows[(torch.float32,) + REPORT_SHAPE_K4[1:]]
    f32_numbers = lambda x: {k: x[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "tflops", "splits")}
    f32_stage = lambda x: {k: x.get(k) for k in (
        "phase", "B", "nW", "N", "h", "splits", "plan", "ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by", "max_abs_err", "rows_ms",
        "cols_ms")}
    info(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "window_attention", "route": "cuda",
        # the bf16 kernel the rerank and the train step run; fp32 (and bf16
        # beyond N = 144 or at hd = 128) runs the CUDA-core source
        "source": "fiber_torch/csrc/window_attention_tc.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention.cu",
            "tc_long": "fiber_torch/csrc/window_attention_tc_long.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "tflops": r["tflops"], "splits": r["splits"],
        "route_launches": {"rerank": rerank_routes,
                           "train_step": train["k1_routes"],
                           "cli_pretrain": cli_pt["k1_routes"],
                           "cli_irtr_384": irtr384["k1_route_launches"],
                           "nlvr2_train": nlvr2["k1_routes"],
                           "det_infer_800": det["routes"],
                           "roi_heads_800": roi["route_launches"]},
        "launches_by_path": {"rerank": launches, "train_step": train["k1"],
                             "cli_pretrain": cli_pt["k1"],
                             "cli_irtr_384": irtr384["k1_launches"],
                             "nlvr2_train": nlvr2["k1"],
                             "det_infer_800": det["k1"],
                             "roi_heads_800": roi["k1_launches"],
                             "ddp_world1_pretrain": ddp1["k1"],
                             "ddp_2rank_pretrain_per_rank": ddp2["k1"],
                             "tp_2rank_pretrain_per_rank": tp2["k1"]},
        "shape": {k: r[k] for k in shape_keys}}, {
        "name": "window_attention_bwd", "route": "cuda",
        # the bf16 kernel the train step runs; fp32 runs the other source
        "source": "fiber_torch/csrc/window_attention_bwd_tc.cu",
        "other_sources": {
            "fp32": "fiber_torch/csrc/window_attention_bwd.cu",
            "shared": ["fiber_torch/csrc/window_attention_bwd_common.cuh",
                   "fiber_torch/csrc/mma_bf16.cuh"]},
        "splits": rb["splits"],
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": train["k2"], "max_abs_err": rb["max_abs_err"],
        "ms": rb["ms"], "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"], "bound_by": rb["bound_by"],
        "library_ms": rb["library_ms"], "library": rb["library"],
        "route_launches": {"cli_pretrain": cli_pt["k2_routes"],
                           "cli_irtr_384": irtr384["k2_route_launches"],
                           "nlvr2_train": nlvr2["k2_routes"]},
        "launches_by_path": {"train_step": train["k2"],
                             "cli_pretrain": cli_pt["k2"],
                             "cli_irtr_384": irtr384["k2_launches"],
                             "nlvr2_train": nlvr2["k2"],
                             "ddp_world1_pretrain": ddp1["k2"],
                             "ddp_2rank_pretrain_per_rank": ddp2["k2"],
                             "tp_2rank_pretrain_per_rank": tp2["k2"]},
        "shape": {k: rb[k] for k in shape_keys}}, {
        "name": "fused_swin_blocks", "route": "cuda",
        # the bf16 kernel the stacked trunk and tower run; fp32 runs the
        # split-TF32 source (its own row), hd = 128 the CUDA-core source
        "source": "fiber_torch/csrc/swin_stage_tc.cu",
        "other_sources": {
            "tc_f32": "fiber_torch/csrc/swin_stage_tf32.cu",
            "cuda_core (hd = 128)": "fiber_torch/csrc/swin_stage.cu",
            "shared": ["fiber_torch/csrc/swin_stage_common.cuh",
                       "fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/swin_stage.py:160",
        "launches": k3_launches["k3_trunk"],
        "max_abs_err": r3["max_abs_err"], "ms": r3["ms"],
        "plain_ms": r3["plain_ms"], "bound_ms": r3["bound_ms"],
        "bound_by": r3["bound_by"], "library_ms": r3["library_ms"],
        "library": r3["library"], "tflops": r3["tflops"],
        "grid": r3["grid"], "tile_plan": r3["tile_plan"],
        "route_launches": {
            "k3_trunk": k3_launches["k3_trunk_routes"],
            "k3_itc_tower": k3_launches["k3_itc_tower_routes"]},
        "launches_by_path": {k: k3_launches[k]
                             for k in ("k3_trunk", "k3_itc_tower")},
        "shape": {k: r3[k] for k in ("stage", "blocks", "B", "H", "C", "h",
                                     "N", "dtype")}}, {
        "name": "window_attention_heads", "route": "cuda",
        "source": "fiber_torch/csrc/window_attention_heads_tc.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention_heads.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:70",
        "launches": k4_launches, "max_abs_err": r4["max_abs_err"],
        "ms": r4["ms"], "plain_ms": r4["plain_ms"],
        "bound_ms": r4["bound_ms"], "bound_by": r4["bound_by"],
        "library_ms": r4["library_ms"], "tflops": r4["tflops"],
        "splits": r4["splits"],
        "route_launches": {"profile_tail": tail_routes["k4"]},
        "launches_by_path": {"profile_tail": k4_launches},
        "shape": {k: r4[k] for k in shape_keys}}, {
        "name": "window_attention_detection", "route": "cuda",
        # K1 at the detection backbone's pad-to-window shapes (stage 1 of
        # 800x1344: 17 x 28 windows of 12 x 12, shifted) in bf16, the kernel
        # detection_inference runs; fp32 there runs the CUDA-core source
        "source": "fiber_torch/csrc/window_attention_tc.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": det["k1"], "max_abs_err": rd["max_abs_err"],
        "ms": rd["ms"], "plain_ms": rd["plain_ms"],
        "bound_ms": rd["bound_ms"], "bound_by": rd["bound_by"],
        "library_ms": rd["library_ms"], "tflops": rd["tflops"],
        "splits": rd["splits"],
        "route_launches": {"det_infer_800": det["routes"],
                           "det_evaluators_800": det_ev["routes"],
                           "det_train_800": det_train["k1_routes"],
                           "glip_infer_800": glip["routes"],
                           "glip_train_800": glip_train["k1_routes"]},
        "launches_by_path": {"det_infer_800": det["k1"],
                             "det_evaluators_800": det_ev["k1"],
                             "det_train_800": det_train["k1"],
                             "det_multiscale": det_ms["k1"],
                             "ddp_2rank_det_per_rank": ddpd["k1"],
                             "glip_infer_800": glip["k1"],
                             "glip_train_800": glip_train["k1"]},
        "stages_ms": [det_rows[(torch.bfloat16, s)]["ms"]
                      for s in range(len(DET_WINDOWS))],
        "shape": {k: rd[k] for k in shape_keys}}, {
        "name": "window_attention_bwd_detection", "route": "cuda",
        # K2 at the detection backbone's pad-to-window shapes (stage 1 of
        # 800x1344: 17 x 28 windows of 12 x 12, shifted) in bf16, the kernel
        # the detection train step runs; fp32 there runs the CUDA-core
        # source
        "source": "fiber_torch/csrc/window_attention_bwd_tc.cu",
        "other_sources": {
            "fp32": "fiber_torch/csrc/window_attention_bwd.cu",
            "shared": ["fiber_torch/csrc/window_attention_bwd_common.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": det_train["k2"], "max_abs_err": rdb["max_abs_err"],
        "ms": rdb["ms"], "plain_ms": rdb["plain_ms"],
        "bound_ms": rdb["bound_ms"], "bound_by": rdb["bound_by"],
        "library_ms": rdb["library_ms"], "library": rdb["library"],
        "tflops": rdb["tflops"], "splits": rdb["splits"],
        "route_launches": {"det_train_800": det_train["k2_routes"],
                           "glip_train_800": glip_train["k2_routes"]},
        "launches_by_path": {"det_train_800": det_train["k2"],
                             "det_multiscale": det_ms["k2"],
                             "ddp_2rank_det_per_rank": ddpd["k2"],
                             "glip_train_800": glip_train["k2"]},
        "stages": [{k: det_bwd_rows[key][k] for k in (
            "nW", "h", "dtype", "shift_mask", "splits", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err")}
            for key in [(torch.bfloat16, s) for s in range(len(DET_WINDOWS))]
            + ["unshifted", (torch.float32, 0)]],
        "shape": {k: rdb[k] for k in shape_keys}}, {
        "name": "window_attention_long", "route": "cuda",
        # K1 at FIBER's 576^2 windows (N = 324) in bf16, the kernel the
        # caption path runs; fp32 there runs the CUDA-core source
        "source": "fiber_torch/csrc/window_attention_tc_long.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc_long.cuh",
                       "fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": cap["k1"], "max_abs_err": rl["max_abs_err"],
        "ms": rl["ms"], "plain_ms": rl["plain_ms"],
        "bound_ms": rl["bound_ms"], "bound_by": rl["bound_by"],
        "library_ms": rl["library_ms"], "tflops": rl["tflops"],
        "rows": rl["rows"], "parts": rl["parts"], "splits": rl["splits"],
        "bit_equal_share": rl["bit_equal_share"],
        "route_launches": {"caption": cap["routes"],
                           "vqa_576": vqa["routes"],
                           "fuzzy_load_576": fuzzy["routes"],
                           "vqa_576_train": vqa_train["k1_routes"],
                           "caption_mle_576_train": cap_train["k1_routes"],
                           "scst_576": scst["routes"][0],
                           "cli_irtr_576": irtr576["k1_route_launches"]},
        "launches_by_path": {"caption": cap["k1"], "vqa_576": vqa["k1"],
                             "fuzzy_load_576": fuzzy["k1"],
                             "vqa_576_train": vqa_train["k1"],
                             "caption_mle_576_train": cap_train["k1"],
                             "scst_576": scst["k1"],
                             "cli_irtr_576": irtr576["k1_launches"]},
        "shape": {k: rl[k] for k in shape_keys}}, {
        "name": "window_attention_bwd_long", "route": "cuda",
        # K2 at FIBER's 576^2 windows (N = 324) in bf16, the kernels the
        # VQA finetuning step runs; fp32 there runs the long-window
        # CUDA-core kernels of window_attention_bwd.cu
        "source": "fiber_torch/csrc/window_attention_bwd_tc_long.cu",
        "other_sources": {
            "cuda_core_long": "fiber_torch/csrc/window_attention_bwd.cu",
            "shared": ["fiber_torch/csrc/wgmma_bf16.cuh",
                       "fiber_torch/csrc/window_attention_tc_long.cuh",
                       "fiber_torch/csrc/window_attention_bwd_common.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": vqa_train["k2"], "max_abs_err": rbl["max_abs_err"],
        "rel_err_dqkv": rbl["rel_err_dqkv"],
        "rel_err_dbias": rbl["rel_err_dbias"],
        "ms": rbl["ms"], "plain_ms": rbl["plain_ms"],
        "bound_ms": rbl["bound_ms"], "bound_by": rbl["bound_by"],
        "library_ms": rbl["library_ms"], "library": rbl["library"],
        "tflops": rbl["tflops"], "plan": rbl["plan"],
        "rows_ms": rbl["rows_ms"], "cols_ms": rbl["cols_ms"],
        "rows_tflops_as_run": rbl["rows_tflops_as_run"],
        "cols_tflops_as_run": rbl["cols_tflops_as_run"],
        "k2_ms_vqa_576_profile": vqa_train["k2_profile"],
        "route_launches": {"vqa_576_train": vqa_train["k2_routes"],
                           "caption_mle_576_train": cap_train["k2_routes"],
                           "scst_576": scst["routes"][1],
                           "cli_irtr_576": irtr576["k2_route_launches"]},
        "launches_by_path": {"vqa_576_train": vqa_train["k2"],
                             "caption_mle_576_train": cap_train["k2"],
                             "scst_576": scst["k2"],
                             "cli_irtr_576": irtr576["k2_launches"]},
        "shape": {k: rbl[k] for k in shape_keys}}, {
        "name": "fused_swin_blocks_long", "route": "cuda",
        # K3 at FIBER's 576^2 windows (N = 324) in bf16: the tensor-core
        # phases with K1's long-window attention routine at K3's rounding;
        # fp32 there runs the split-TF32 source (the fp32 row's stages)
        "source": "fiber_torch/csrc/swin_stage_tc_long.cu",
        "other_sources": {
            "tc_f32": "fiber_torch/csrc/swin_stage_tf32.cu",
            "shared": ["fiber_torch/csrc/swin_stage_tc.cuh",
                       "fiber_torch/csrc/swin_stage_common.cuh",
                       "fiber_torch/csrc/window_attention_tc_long.cuh",
                       "fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh",
                       "fiber_torch/csrc/window_attention_common.cuh"]},
        "replaces": "fiber_tpu/ops/swin_stage.py:160",
        "launches": k3_tower["k3"], "max_abs_err": r3l["max_abs_err"],
        "rel_err": r3l["rel_err"], "ms": r3l["ms"],
        "plain_ms": r3l["plain_ms"], "bound_ms": r3l["bound_ms"],
        "bound_by": r3l["bound_by"], "library_ms": r3l["library_ms"],
        "library": r3l["library"], "tflops": r3l["tflops"],
        "grid": r3l["grid"], "plan": r3l["tile_plan"],
        "bit_equal_two_calls": r3l["bit_equal_two_calls"],
        "stages_ms": k3_tower["stages"],
        "breakdown_ms": {k: v for k, v in k3_split.items()
                         if k.endswith("_ms")},
        "route_launches": {"k3_itc_tower_576": k3_tower["routes"]},
        "launches_by_path": {"k3_itc_tower_576": k3_tower["k3"]},
        "shape": {k: r3l[k] for k in ("stage", "blocks", "B", "H", "C", "h",
                                      "N", "dtype")}}, {
        "name": "window_attention_heads_long", "route": "cuda",
        # K4 at FIBER's 576^2 windows (N = 324) in bf16, K1's long-window
        # routine on per-head rows; fp32 there runs the CUDA cores'
        # 11-chunk instance
        "source": "fiber_torch/csrc/window_attention_heads_tc_long.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention_heads.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc_long.cuh",
                       "fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh",
                       "fiber_torch/csrc/window_attention_common.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:70",
        "launches": k4_tail["k4"], "max_abs_err": r4l["max_abs_err"],
        "ms": r4l["ms"], "plain_ms": r4l["plain_ms"],
        "bound_ms": r4l["bound_ms"], "bound_by": r4l["bound_by"],
        "library_ms": r4l["library_ms"], "tflops": r4l["tflops"],
        "splits": r4l["splits"], "rows": r4l["rows"], "parts": r4l["parts"],
        "route_launches": {"profile_tail_576": k4_tail["routes"]},
        "launches_by_path": {"profile_tail_576": k4_tail["k4"]},
        "shape": {k: r4l[k] for k in shape_keys}}, {
        "name": "window_attention_swint", "route": "cuda",
        # K1 at the registry's Swin-T shapes (window 7, N = 49; stage 1 of
        # 800x1344: 29 x 48 windows, shifted) in bf16; fp32 there runs the
        # CUDA-core source
        "source": "fiber_torch/csrc/window_attention_tc.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention.cu",
            "shared": ["fiber_torch/csrc/window_attention_tc.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": reg_swint["SWINT-VL-FPN-RETINANET"]["k1_launches"],
        "max_abs_err": rs["max_abs_err"], "ms": rs["ms"],
        "plain_ms": rs["plain_ms"], "bound_ms": rs["bound_ms"],
        "bound_by": rs["bound_by"], "library_ms": rs["library_ms"],
        "tflops": rs["tflops"], "splits": rs["splits"],
        "route_launches": {n: reg_swint[n]["route_launches"]
                           for n in REGISTRY_SWINT},
        "launches_by_path": {**{n: reg_swint[n]["k1_launches"]
                                for n in REGISTRY_SWINT},
                             "SWINT-VL-FPN-RETINANET_backward":
                                 swint_bwd["k1_launches"]},
        "stages": [{k: swint_k1[(d, s)][k] for k in stage_keys}
                   for d in (torch.bfloat16, torch.float32)
                   for s in range(len(SWINT_WINDOWS))],
        "shape": {k: rs[k] for k in shape_keys}}, {
        "name": "window_attention_bwd_swint", "route": "cuda",
        # K2 at the registry's Swin-T shapes in bf16; fp32 there runs the
        # CUDA-core source
        "source": "fiber_torch/csrc/window_attention_bwd_tc.cu",
        "other_sources": {
            "fp32": "fiber_torch/csrc/window_attention_bwd.cu",
            "shared": ["fiber_torch/csrc/window_attention_bwd_common.cuh",
                       "fiber_torch/csrc/mma_bf16.cuh"]},
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": swint_bwd["k2_launches"],
        "max_abs_err": rsb["max_abs_err"], "ms": rsb["ms"],
        "plain_ms": rsb["plain_ms"], "bound_ms": rsb["bound_ms"],
        "bound_by": rsb["bound_by"], "library_ms": rsb["library_ms"],
        "library": rsb["library"], "tflops": rsb["tflops"],
        "splits": rsb["splits"],
        "route_launches": {"SWINT-VL-FPN-RETINANET_backward":
                           swint_bwd["k2_route_launches"]},
        "launches_by_path": {"SWINT-VL-FPN-RETINANET_backward":
                             swint_bwd["k2_launches"]},
        "stages": [{k: swint_k2[(d, s)][k] for k in stage_keys}
                   for d in (torch.bfloat16, torch.float32)
                   for s in range(len(SWINT_WINDOWS))],
        "shape": {k: rsb[k] for k in shape_keys}}, {
        "name": "window_attention_fp32", "route": "cuda",
        # K1 in fp32 at hd <= 64 on the CUDA cores, register-tiled, the
        # plain version's bits: the fp32 card-vs-host phases' K1 (the
        # detector's default dtype); hd = 128 runs the older CUDA-core source
        "source": "fiber_torch/csrc/window_attention_f32.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention.cu",
            "shared": F32_SHARED},
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": fp32_grads["k1"], **f32_numbers(rf),
        "route_launches": {"fp32_grad_card_vs_host": fp32_grads["routes"]},
        "launches_by_path": {"fp32_grad_card_vs_host": fp32_grads["k1"]},
        "stages": [f32_stage(x) for x in
                   [long_rows[(torch.float32, s)] for s in range(4)]
                   + [det_rows[(torch.float32, s)]
                      for s in range(len(DET_WINDOWS))]
                   + [swint_k1[(torch.float32, s)]
                      for s in range(len(SWINT_WINDOWS))]],
        "shape": {k: rf[k] for k in shape_keys}}, {
        "name": "window_attention_bwd_fp32", "route": "cuda",
        # K2 in fp32 at hd <= 64: split-TF32 row and column kernels
        "source": "fiber_torch/csrc/window_attention_bwd_tf32.cu",
        "other_sources": {
            "cuda_core (hd = 128)": "fiber_torch/csrc/window_attention_bwd.cu",
            "shared": F32_SHARED},
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": fp32_grads["k2"], **f32_numbers(rbf),
        "library": rbf["library"], "plan": rbf["plan"],
        "route_launches": {"fp32_grad_card_vs_host": fp32_grads["routes"]},
        "launches_by_path": {"fp32_grad_card_vs_host": fp32_grads["k2"]},
        "stages": [f32_stage(x) for x in
                   [bwd_long_rows[(torch.float32, s)] for s in range(4)]
                   + [det_bwd_rows[(torch.float32, 0)]]
                   + [swint_k2[(torch.float32, s)]
                      for s in range(len(SWINT_WINDOWS))]],
        "shape": {k: rbf[k] for k in shape_keys}}, {
        "name": "window_attention_heads_fp32", "route": "cuda",
        # K4 in fp32 at hd <= 64: K1's fp32 routine on per-head rows
        "source": "fiber_torch/csrc/window_attention_heads_f32.cu",
        "other_sources": {
            "cuda_core": "fiber_torch/csrc/window_attention_heads.cu",
            "shared": F32_SHARED},
        "replaces": "fiber_tpu/ops/window_attention.py:70",
        "launches": k4_tail["k4_fp32"], **f32_numbers(r4f),
        "route_launches": {"profile_tail_576_fp32": k4_tail["routes_fp32"]},
        "launches_by_path": {"profile_tail_576_fp32": k4_tail["k4_fp32"]},
        "stages": [f32_stage(k4_long_rows[torch.float32])],
        "shape": {k: r4f[k] for k in shape_keys}}, {
        "name": "fused_swin_blocks_fp32", "route": "cuda",
        # K3 in fp32 at hd <= 64: every product as three TF32 products on
        # the tensor cores, the attention by K1's fp32 routine at K3's
        # rounding; hd = 128 runs the CUDA-core source (k3_check_hd128)
        "source": "fiber_torch/csrc/swin_stage_tf32.cu",
        "other_sources": {
            "cuda_core (hd = 128)": "fiber_torch/csrc/swin_stage.cu",
            "shared": ["fiber_torch/csrc/swin_stage_tc.cuh",
                       "fiber_torch/csrc/swin_stage_common.cuh"]
            + F32_SHARED},
        "replaces": "fiber_tpu/ops/swin_stage.py:160",
        "launches": k3_f32["k3_trunk"],
        **{k: r3f[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "tflops")},
        "library": r3f["library"], "plan": r3f["tile_plan"],
        "grid": r3f["grid"], "attrs": r3f["attrs"],
        "bound_cuda_cores_ms": r3f["bound_cuda_cores_ms"],
        "bit_equal_two_calls": r3f["bit_equal_two_calls"],
        "route_launches": {
            "k3_trunk": k3_f32["k3_trunk_routes"],
            "k3_itc_tower": k3_f32["k3_itc_tower_routes"]},
        "launches_by_path": {k: k3_f32[k]
                             for k in ("k3_trunk", "k3_itc_tower")},
        "phase_ms": r3f["phase_ms"],
        "stages": [{k: x.get(k) for k in (
            "phase", "stage", "blocks", "B", "N", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_cuda_cores_ms", "bound_by",
            "max_abs_err", "rel_err", "tflops", "phase_ms")} for x in
            [k3_rows[(torch.float32, B, s)] for B in K3_BATCHES
             for s in range(4)] + [k3_long_rows[torch.float32]]],
        "shape": {k: r3f[k] for k in ("stage", "blocks", "B", "H", "C", "h",
                                      "N", "dtype")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ddp_worker(sys.argv[2:]) if sys.argv[1:2] == ["--ddp-worker"]
             else main())
