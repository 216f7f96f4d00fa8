#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through the
kernels written for Hopper, and check them: the zero-shot dual encoder
(serving), the dual-encoder pretraining step (with the CLIP loss, and
with the SSL loss over human and pseudo narrations), the EK-100 MIR
retrieval fine-tune, the EK-100 CLS classification fine-tune, the
narrator's sampled and beam decoding, its caption step and its
evaluation, at TSF-B width, with the
TSF-L@224 dual encoder (N = 256: K1's tensor-core kernels), with the
336px TSF-L towers (the high-resolution dual encoder and LaViLa's
flagship narrator), with the CLIP ViT towers (ViT-L/14@336 and
ViT-B/16 dual encoders, the ViT-L/14@336 + GPT-2 XL and ViT-B/16 +
GPT-2 large narrators), and with the single-device options: the gated
time attention, the remat policies, the OpenAI-CLIP init of the
TimeSformer and CLIP's ModifiedResNet.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-ranks 4   # only NCCL across 4 cards

Needs one CUDA device and ``nvcc`` (PATH or $CUDA_HOME, default
/usr/local/cuda); with no CUDA device it exits non-zero and prints no
result. Phases, each printing JSON lines:

  1. device: ``nvidia-smi`` name and power limit, torch's device name.
  2. build: nvcc builds ``lavila_tpu_torch/csrc/*.cu`` (timed).
  3. kernels: K1 (spatial phase; TSF-B's N = 196 at batch 8 and 32 and
     TSF-L@224's 256; each K1, K2 and K6 case also gives the branch it
     took and the profiler's device time of the kernel and of the
     library call beside their event times),
     K2 (temporal phase, F=4 and F=16, and at TSF-L@336; bf16 on the
     slab kernels' tensor cores), K3 (LayerNorm;
     the towers' widths and the narrator's: a decode step's (160, 1,
     1600) and the pooler's bias-free (4096, 1600)), K4/K5 (add +
     LayerNorm at TSF-L@336's and TSF-B's patch rows; every LayerNorm
     forward case within max(2e-2, 2^-8·|plain|) in bf16, bit-identical
     over two calls, with the profiler's device time), K6 (spatial phase
     over 576 patches, batch 8 and 32: the same tensor-core kernels as
     K1, their keys streamed through a refilled ring; fp32 on its SIMT
     kernels), K9 (decode attention; GPT-2 XL and TSF-B
     widths, ``num_valid`` 0, 1, 15 and 77) and K7/K8 forward (flash
     attention: the CLIP text towers' causal attention, 16 captions of
     77 tokens, 8 and 12 heads of 64, and 256 captions; one uneven
     non-causal case, 130 queries over 260 keys; each with its branch
     and, in bf16, the profiler's device time beside SDPA's), and
     DistilBERT's K3 and K5 at (16·77, 768) with eps 1e-12, 16 of the
     rows flat (variance 0, rstd 1e6), forward and backward, against
     their plain PyTorch versions on seeded inputs, fp32 and bf16, with
     errors, tolerances, CUDA-event times, the card's bound for the same
     work and the time of one PyTorch library call computing it
     (``scripts/time_library_calls.py``); GPT-2 XL's K3 rows (8·76,
     1600) and its two attentions in the caption step, 8 captions × 25
     heads: causal 76 × 76 and 76 queries over 256 image tokens (K7, K8
     forward and backward, the split backward past 128 keys), from
     their own generator after the other cases; the CLS row's forward
     and backward kernels at TSF-L@336's 16 heads of 64 over 4 × 576
     patches, 16 and 32 clips, on strided row views, against the plain
     row in fp32 (the forward's lse within 1e-4; the backward against
     ``cls_row_bwd_reference``), beside SDPA over head-major copies; and
     the launch floor,
     the profiler's device time of an empty kernel, beside the short K3
     calls and K9 (``launch_floor`` line). kernel_bwd: the same for the
     backward kernels (K8's whole backward: the fused kernel up to 128
     tokens, dq then dk/dv past it and in fp32; K1 also at
     TSF-L@224's N = 256, bf16 at batch 8 and fp32 at batch 1; the
     LayerNorm backward, K3/K4/K5 bwd, one CUDA kernel: also on ragged
     rows (6273), one row, CLS rows (8, 1024), the fine-tune's (25088,
     768), D = 1600 and bf16 rows with fp32 γ, each with the branch it
     took), on strided qkv views, errors relative to the reference's
     largest value, and two calls checked bit-identical; K1's and K6's
     with the floor of their tensor-core split (9 products against the
     bound's 5: S and dP twice in dq for delta = rowsum(P·dP)); and K1,
     K2 (TSF-B, F = 4) and K6 (N = 576) at keys and values sharing a
     common part 20x their spread, fp32 and bf16, dq, dck and dcv against
     an fp64 autograd witness within 1% and 10% of its norm beside the
     Pallas kernels' form's error, delta from the output as written
     (``near_copy_keys``).
  4. model: CLIP_OPENAI_TIMESFORMER_BASE from a seeded generator, time
     attention given seeded noise (its zero init would make K2's check
     vacuous), embeddings on the kernel path against the plain functions
     on the same weights, launch counts per call, and encode_image
     clips/s at batch 32 in bf16 on both paths.
  5. cli: the port CLI's ``load_model_from_checkpoint`` (BASE, bf16) and
     ``embed_dataset`` over the synthetic dataset, scored by the port's
     ``lavila_tpu_torch.eval.metrics`` on an identity relevancy matrix.
  6. train_step: 2 AdamW steps of BASE at full depth (``norm_embed``),
     fp32 and bf16, kernel path against the plain path from the same
     weights and batch (losses and every gradient), launches per step,
     then train clips/s and peak memory at batch 16 and 48 in bf16 on
     both paths.
  7. pretrain_cli: the port's pretraining CLI for 5 steps (BASE, bf16,
     batch 16, synthetic data), then the zero-shot loader reads its
     checkpoint and embeds a batch.
  7b. finetune_step: the retrieval fine-tune's step (adaptive max-margin
     with relevancy weights, logit_scale frozen) on BASE at 16 frames, 2
     fp32 steps kernel path against plain path; bf16 clips/s and peak
     memory at batch 8. finetune_cli: the port's
     ``main_finetune_retrieval`` for 3 steps (BASE, 16 frames, bf16,
     batch 8, synthetic data): a finite loss, logit_scale unchanged.
  7b'. ssl_train_step: phase 6 with the SSL loss (``gt_indicators``
     human and pseudo in turn, the pseudo scale's gradient among those
     compared), fp32 at batch 4 and bf16 at batch 16; bf16 clips/s and
     peak memory at 16 in turns, and the profiler's busy time of the SSL
     and the CLIP step on the same weights and batch. ssl_pretrain_cli:
     phase 7 with ``--metadata-aux synthetic_aux`` for 3 steps at batch
     16: ``logit_scale_pseudo`` moved and saved in the checkpoint, which
     classify_cli reads. classify_step: ``VideoClassifierMultiHead``
     over TSF-B at 16 frames with EK-100's 97 verb, 300 noun and 3806
     action heads (SGD, backbone x 0.1, each group clipped by its own
     norm, label smoothing 0.1, dropout 0.5, drop-path 0.1), 2 steps
     kernel path against plain path in fp32 at batch 4 and bf16 at batch
     16; bf16 clips/s and peak memory at 16 in turns; busy time beside
     the retrieval fine-tune step's at the same batch. classify_cli: the
     port's ``main_finetune_classification`` for 3 steps (3806 classes,
     16 frames, SGD, bf16, batch 16) from ssl_pretrain_cli's checkpoint:
     the video tower arrives bit-equal, the loss is finite.
  7c. large224_model, large224_train_step, large224_cli:
     CLIP_OPENAI_TIMESFORMER_LARGE (TSF-L@224: 24 blocks 1024 wide, 16
     heads, N = 256, K1 in every block) as phases 4, 6 and 5: embeddings
     kernels vs plain and encode_image clips/s at batch 8; 2 AdamW steps
     kernels vs plain in fp32 at batch 2 and bf16 at batch 4, then bf16
     train clips/s and peak memory at batch 8; the zero-shot CLI.
 8. narrator: VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL (48 layers, 1600
     wide) initialised on the card from a seeded generator, its
     cross-attention gates and time attention given seeded non-zero
     values; kernel path against plain path on the same weights: cached
     decode logits of 8 teacher-fed tokens against the full
     teacher-forced forward, greedy ``generate`` ids and perplexities
     (fp32, then bf16), launches per decode step; a profile of decode
     steps (host time against device time, K9's share, the idle share
     of the untraced step); then narrations/s at 16 clips x 10 return
     sequences, 77 tokens, temperature 0.7, top-p 0.95, bf16,
     kernels/plain/plain/kernels.
  9. infer_narrator_cli: the port's ``main_infer_narrator`` on one batch
     of the synthetic dataset (GPT-2 XL narrator, bf16); checks
     ``total.pkl``. The narrator phase also holds GPT-2's full forward
     under inference (K7 at its 72 attentions) against the plain one.
 9b. narrator_train_step: LaViLa's narrator recipe (``--gated-xattn
     --freeze-lm-vclm --freeze-visual-vclm``) on the TSF-B narrator at
     full width and depth, 2 AdamW caption steps kernels vs plain (fp32
     at batch 2, bf16 at 4; every trainable gradient; frozen parameters
     bit-equal without a gradient), remat vs none, launches by kernel
     and branch as ``_caption_launches`` predicts, bf16 clips/s and peak
     memory at batch 16 in turns, busy time and idle share.
 9c. eval_narrator_cli: the port's ``eval_narrator`` (bf16, 8 clips)
     with each ``--decoding`` (3 beams; 6 in 3 groups): finite
     teacher-forced perplexities, the NLG scores, launches against the
     decode steps run; one-beam ``beam_search`` against greedy (fp32).
 10. large_model, large_cli: phases 4 and 5 with
     CLIP_OPENAI_TIMESFORMER_LARGE_336PX (24 blocks 1024 wide, 576
     patches a frame: K6, K4, K5 in every block), encode_image clips/s
     at batch 8.
 11. large_train_step: 2 AdamW steps of TSF-L@336 at batch 2 in fp32,
     kernel path against plain path; the same with remat against
     without, drop-path 0.1 from one seeded generator; then bf16 train
     clips/s and peak memory at batch 8 (kernels/plain/plain/kernels,
     remat off), and with remat at batch 8 and at the largest of 32 and
     16 that fits.
 12. large_pretrain_cli: phase 7 with TSF-L@336, ``--use-checkpoint``,
     3 steps at batch 8.
 13. flagship_narrator, flagship_infer_narrator_cli: phases 8 and 9 with
     VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL (cross-attention on 16
     of the 48 layers, 4·576 + 1 image tokens into the pooler).
 13b. vclm_pretrain_cli: the port's ``main_pretrain`` with the flagship
     and LaViLa's recipe (fp32, ``--disable-amp``) plus
     ``--use-checkpoint``, 2 steps at batch 8 on the synthetic dataset
     and a fixture GPT-2 vocabulary: a finite loss, the gates moved,
     frozen tensors bit-equal in the checkpoint; then
     ``main_infer_narrator`` narrates a batch from that checkpoint. Its
     launches by branch (SIMT) are on their own line.
 14. distilbert_model: CLIP_OPENAI_TIMESFORMER_LARGE_336PX_DISTILBERT_BASE
     (LaViLa's TSF-L@HR recipe: TSF-L@336 with DistilBERT, 6 post-LN
     layers 768 wide, plain masked attention, K3 on the embeddings and
     K5 on the residual norms at eps 1e-12) serving at batch 8: captions
     of 2 to 77 tokens under their masks, embeddings kernels vs plain
     (fp32, bf16), launches per call, ids past each mask redrawn without
     moving a text embedding; bf16 clips/s and captions/s, busy time,
     idle share and peak memory. hf_model: the same with
     CLIP_HF_TIMESFORMER_DISTILBERT_BASE (no ln_pre, a patch-embed bias,
     erf GELU).
 15. distilbert_cli: phase 5 with the TSF-L@336 DistilBERT model, its
     WordPiece vocabulary a fixture written to a temporary directory
     (``LAVILA_TOKENIZER_DIR``), the masks passed with the text.
 16. distilbert_train_step, distilbert_pretrain_cli: phases 6 and 7 with
     CLIP_OPENAI_TIMESFORMER_BASE_DISTILBERT_BASE and masked captions:
     2 steps kernels vs plain in fp32 at batch 4 and bf16 at batch 16,
     bf16 train clips/s, peak memory, busy time and idle share at batch
     16; the pretraining CLI for 3 steps at batch 16.
 17. vit_model: CLIP_OPENAI_VITL14_336PX (577 tokens, K7 without the
     causal mask in every block, K3 at every norm) serving at batch 8 x 4
     frames and CLIP_OPENAI_VITB16 (197 tokens) at batch 32 x 4, as
     phase 4, plus the kernel path's busy time, idle share and peak
     memory (``serve_profile``). The kernels phase holds K7 and K8 at the
     ViTs' shapes (32 images x 16 heads x 577² and 257², 128 x 12 x 197²
     and 50², non-causal) and K9 at GPT-2 large's 20 heads.
 18. vit_train_step: phase 6 with CLIP_OPENAI_VITB16 (fp32 at batch 2,
     bf16 at 8; K8's split backward at 197 tokens, launches by branch),
     bf16 clips/s, peak memory, busy time and idle share at batch 16.
 19. vit_cli: phase 5 with ViT-L/14@336 reading a ``.pt`` written in
     OpenAI's layout (seeded fp16 weights, the three metadata entries),
     which must arrive as written.
 20. vit_narrator: phase 8 with VCLM_OPENAI_VITL14_336PX_GPT2_XL (4·576
     patch tokens into the pooler), then the kernels-vs-plain checks
     alone with VCLM_OPENAI_VITB16_GPT2_LARGE (K9 at 1280 wide).
     vit_infer_narrator_cli: phase 9 with the ViT-L/14@336 narrator.
 21. gated_timesformer: TSF-B with ``timesformer_gated_xattn`` (the tanh
     gate on the time attention, each block's ``alpha_timeattn`` and
     time attention seeded): phase 4's checks at batch 8, two bf16 train
     steps kernels vs plain at batch 8, the gates' gradients nonzero and
     their parameters fp32 in the bf16 working copy, then
     ``main_pretrain --timesformer-gated-xattn`` for 2 steps.
 22. remat_policies: TSF-L@336's bf16 train step at batch 32 under the
     remat policies ``full``, ``dots``, ``save_attn`` and ``dots_attn``
     from one set of weights: gradients against ``full``'s, launches (K6
     and K2 forward 24 a step where the policy keeps the phases' outputs,
     48 where the recompute runs them), step ms, busy ms, idle share and
     peak memory (batch 16 where 32 does not fit).
 23. openai_init: a synthetic ViT-B/16 checkpoint in OpenAI's layout,
     fetched from a ``file://`` URL into a temporary cache, loaded by
     ``load_into_timesformer_dual_encoder`` into TSF-B, which then serves
     as phase 4 at batch 8.
 24. resnet: ModifiedResNet RN50 at 224² (seeded weights and running
     statistics) encoding batch 8 kernels vs plain, its attention pool
     on K7, and images/s.
 25. Data parallelism (``lavila_tpu_torch/parallel/mesh.py``), each
     phase's ranks in processes of their own under a timeout, each
     line with the card's name and power limit. The machine shows one
     card: two ranks share it through gloo (NCCL refuses two ranks on
     one device), and NCCL runs at a world of one; no line is a scaling
     number. ddp_nccl_world1: ``main_pretrain`` on TSF-B (bf16, batch
     16, 3 steps) directly and through ``cli.launch --num-processes 1``
     (NCCL), in turns: every loss and the final masters bit-identical,
     the same launches, the step ms of each run. ddp_two_ranks: two
     ranks each stepping 8 rows of a batch of 16 (bf16 on fp32 masters,
     2 AdamW steps) with the global CLIP loss, the local one
     (``--contrastive-use-vissl``) and the local SSL loss: the ranks'
     masters bit-identical and losses equal, against one process on
     the 16 rows (loss within 1e-2, gradient cosines at least 0.99, the
     global gradient norm within 1 ± 0.1 of one process's, the masters
     within 2.5·Σ lr), each rank's launches a step the single-process
     step's. ddp_infer_narrator: ``main_infer_narrator``
     over two ranks on the TSF-B + GPT-2 XL narrator (bf16, greedy, 6
     clips): ``cache.{0,1}.pkl`` the sampler's shards and ``total.pkl``
     their merge in dataset order, against a one-process run clip by
     clip; K9 on each rank. With ``--nccl-ranks N`` (N cards) only
     ddp_nccl_cards runs: ddp_two_ranks's checks at N NCCL ranks, one a
     card, then ``main_pretrain`` through ``cli.launch --num-processes N
     --process-id i``: each rank's masters on its card, bit-identical
     over the ranks, equal losses, 3 steps' launches on each rank.
 26. Tensor parallelism and the ring attention (``parallel/sharding.py``,
     ``parallel/tensor.py``, ``ops/ring_attention.py``), two gloo ranks
     on the one card, each line with the card's name and power limit, no
     line a scaling number. tp_two_ranks: TSF-B at full width and depth,
     its wide layers sharded at model=2 (6 heads a rank, the text tower
     4), 2 bf16 AdamW steps on a batch of 16 against one process (loss
     within 1e-2, the gathered gradients' cosine at least 0.99 and global
     norm within 1 ± 0.1, masters within 2.5·Σ lr), the ranks'
     replicated masters bit-identical, each rank's launches a step the
     one-process step's, on the tensor cores only. tp_narrator: TSF-B +
     GPT-2 XL at full width (25 heads 13/12: K9 at 832 and 768 wide), 16
     of its 48 layers, bf16: encode, 8 teacher-fed cached steps and
     greedy generation against one process by the bf16 narrator rule,
     the ranks' ids equal, K9 a layer a decode step. ring_two_ranks: the
     time phase at TSF-B width (2 clips, 16 frames over the two ranks),
     fp32 with gradients and bf16, against K2's time phase in one
     process, then a TSF-B encode at 16 frames with the ring group set
     (no K2 launch) against one process's. With ``--nccl-ranks N`` the
     phases tp_nccl_cards (the TSF-B step at model=N and at data=N/2 x
     model=2; ``main_pretrain --mesh-model 2`` through the launcher:
     each rank's shards on its card, the checkpoint the whole layout)
     and ring_nccl_cards (the ring over N cards) run after
     ddp_nccl_cards.

For the time limit the phases that build their models here run them cut
in depth, never in width (the ``depth_cuts`` line; PERF.md §4): TSF-B's
SSL, fine-tune, classify, DistilBERT, gated and data-parallel steps at 4
of 12 blocks, TSF-L's steps and remat policies at 8 of 24, ViT-B/16's
step at 4 of 12, the GPT-2 XL narrators' decode and caption phases at 16
of 48 layers. The serving phases, TSF-B's train step, tp_two_ranks and
every CLI run at full depth.

Every path phase (5, 7, finetune_cli, ssl_pretrain_cli, classify_cli,
large224_cli, 9, 9c, 10-13b, 15, 16's CLI, 19, vit_infer_narrator_cli,
21's CLI, 22's gradient steps, 23's and 24's bf16 encodes, 25's first
launcher run and rank 0 of the narration) zeroes
the launch counters before it runs and reads them after; the kernel
summary line sums those runs' counts (K1's, K2's and K6's also by
branch: every divided-phase launch of a path runs bf16 at head_dim 64
and at most 16 frames, so on the tensor cores, which the bf16 encodes,
the bf16 train steps (TSF-B, TSF-L@224, the fine-tune, TSF-L@336 with
and without remat) and the narrators' bf16 encodes check too; the
LayerNorm backward's by branch, one launch a call: the one-block branch
for the CLS rows of a batch that one block's rings hold, the cooperative
grid for the rest, which every train step on the kernels checks; K7's
and K8's by branch as well: the bf16 text towers take the tensor-core
forward and the fused backward only, GPT-2's cross-attention the split
backward past 128 keys, which the bf16 encodes and steps check too).
The path run of the flagship's fp32 recipe (13b) runs SIMT: its
launches by branch go to their own line and out of that check. The
text tower runs K7 under inference_mode (serving) and K8's forward and
backward (one fused launch a layer in bf16) in every train step.
TF32 is off for matmuls and cuDNN convolutions, so fp32 comparisons are
fp32. Any failed check exits non-zero without the final line; the final
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext
from unittest import mock

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"
# the dual encoders of the paths: TSF-B (12 blocks, N = 196: K1),
# TSF-L@224 (24 blocks 1024 wide, N = 256: K1) and TSF-L@336 (N = 576:
# K6), each with the CLIP text tower; "space" names the spatial phase's
# kernel
MODEL = {"name": "CLIP_OPENAI_TIMESFORMER_BASE", "img": 224, "depth": 12,
         "width": 768, "text_depth": 12, "embed": 256, "space": "K1",
         "serve_batch": 32}
LARGE224 = {"name": "CLIP_OPENAI_TIMESFORMER_LARGE", "img": 224,
            "depth": 24, "width": 1024, "text_depth": 12, "embed": 256,
            "space": "K1", "serve_batch": 8}
LARGE = {"name": "CLIP_OPENAI_TIMESFORMER_LARGE_336PX", "img": 336,
         "depth": 24, "width": 1024, "text_depth": 12, "embed": 256,
         "space": "K6", "serve_batch": 8}
# the DistilBERT dual encoders ("text": 6 post-LN layers, 768 wide, plain
# masked attention; K3 on the embeddings, K5 on the two residual norms):
# LaViLa's TSF-L@HR recipe (TSF-L@336), the CLIP_HF tower (no ln_pre, a
# patch-embed bias, erf GELU) and TSF-B, whose train step runs
DISTIL_LARGE = dict(LARGE, name="CLIP_OPENAI_TIMESFORMER_LARGE_336PX_"
                    "DISTILBERT_BASE", text="distilbert", text_depth=6)
HF_MODEL = dict(MODEL, name="CLIP_HF_TIMESFORMER_DISTILBERT_BASE",
                text="distilbert", text_depth=6, ln_pre=False, serve_batch=8)
DISTIL_BASE = dict(MODEL, name="CLIP_OPENAI_TIMESFORMER_BASE_DISTILBERT_BASE",
                   text="distilbert", text_depth=6, serve_batch=8)
# the CLIP ViT dual encoders (the ViT per frame, its projected CLS feature
# mean-pooled over 4 frames; no image projection; self-attention over
# every token, K7/K8 without the causal mask): ViT-L/14@336 (577 tokens,
# 24 blocks 1024 wide, 16 heads; text 768 wide, 12 heads) and ViT-B/16
# (197 tokens, 12 blocks 768 wide, 12 heads; text 512 wide, 8 heads)
VIT_L336 = {"name": "CLIP_OPENAI_VITL14_336PX", "img": 336, "depth": 24,
            "width": 1024, "text_depth": 12, "embed": 768, "tower": "vit",
            "tokens": 577, "serve_batch": 8}
VIT_B16 = {"name": "CLIP_OPENAI_VITB16", "img": 224, "depth": 12,
           "width": 768, "text_depth": 12, "embed": 512, "tower": "vit",
           "tokens": 197, "serve_batch": 32}
# DistilBERT's special ids in the distilbert-base-uncased vocabulary
BERT_PAD, BERT_CLS, BERT_SEP, BERT_VOCAB = 0, 101, 102, 30522
# DistilBERT's LayerNorm eps, a runtime float in the K3/K5 kernels
BERT_EPS = 1e-12
# DistilBERT's norm rows at 16 captions of 77 tokens
BERT_ROWS = (16 * 77, 768)
# Each kernel case is held against the plain version run in fp32 on the
# same input values, so the bound is the kernel's own error. fp32:
# summation order only; bf16: the kernels compute in fp32 and round the
# output to bf16 once, half an ulp (<= 1/64 below 8 for unit-scale data).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FAILURES: list[str] = []
# the narrators of the decode path: TSF-B + GPT-2 XL (48 layers, 24 with
# cross-attention) and the flagship TSF-L@336 + GPT-2 XL (16 with
# cross-attention); BOS = EOS = GPT-2's <|endoftext|>
NARRATOR = {"name": "VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL", "layers": 48,
            "cross": 24, "bos": 50256, "eos": 50256, "img": 224,
            "depth": 12, "width": 768, "space": "K1"}
FLAGSHIP = {"name": "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL",
            "layers": 48, "cross": 16, "bos": 50256, "eos": 50256,
            "img": 336, "depth": 24, "width": 1024, "space": "K6"}
# the ViT narrators: ViT-L/14@336's patch tokens (4·576 a clip) into
# GPT-2 XL, and ViT-B/16's (4·196) into GPT-2 large (36 layers, 20 heads
# of 64 = 1280: K9 at that width), cross-attention on every second layer
VIT_NARRATOR = {"name": "VCLM_OPENAI_VITL14_336PX_GPT2_XL", "layers": 48,
                "cross": 24, "bos": 50256, "eos": 50256, "img": 336,
                "depth": 24, "width": 1024, "tower": "vit",
                "text_width": 1600}
VIT_NARRATOR_LARGE = {"name": "VCLM_OPENAI_VITB16_GPT2_LARGE", "layers": 36,
                      "cross": 18, "bos": 50256, "eos": 50256, "img": 224,
                      "depth": 12, "width": 768, "tower": "vit",
                      "text_width": 1280}
# GPT-2 XL's attentions in the narrator's caption step at 8 captions of
# 76 tokens (77 less the shifted label), 25 heads of 64: the causal
# self-attention on c_attn's row views and the cross-attention over the
# 256 pooled image tokens (B, H, Lq, Lk, d); its norms' rows
GPT2_SELF = (8, 25, 76, 76, 64)
GPT2_CROSS = (8, 25, 76, 256, 64)
GPT2_ROWS = (8 * 76, 1600)
# the CLIP ViTs' self-attention (B·T images, heads, Lq, Lk, head_dim):
# ViT-L/14@336 and ViT-L/14 at 8 clips x 4 frames, ViT-B/16 and ViT-B/32
# at 32 clips x 4 frames
VIT_FLASH_CASES = (("full", (32, 16, 577, 577, 64)),
                   ("full", (32, 16, 257, 257, 64)),
                   ("full", (128, 12, 197, 197, 64)),
                   ("full", (128, 12, 50, 50, 64)))
# K9 at GPT-2 large's width: the ViT-B/16 narrator's 160 decode rows
GPT2_LARGE_K9 = (160, 77, 1280, 20, 15)
# the K3 backward rows timed by the profiler beside F.layer_norm's (as
# DistilBERT's): a decode step's and the caption step's (every forward
# case has its device time)
LN_DEVICE_ROWS = ((160, 1, 1600), GPT2_ROWS)
# the LayerNorm forward's limit in bf16: one rounding of an output v to
# bf16 errs by at most 2^-8·|v|, so an element passes when |kernel −
# plain| <= max(TOL, 2^-8·|plain|) (the same as TOL below |v| = 5.12;
# K4's sum of two unit normals reaches past 8, where TOL is under half an
# ulp)
LN_BF16_REL = 2.0 ** -8
# the least time the card could take: bytes over HBM3's 3.35 TB/s, or
# operations over the dense peak of their type (bf16 tensor cores, fp32
# outside them); NVIDIA's H100 SXM data sheet, at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# where ssl_pretrain_cli leaves its checkpoint for classify_cli: a
# temporary directory that main() makes, removed at exit
SSL_CHECKPOINT = ""


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> dict:
    """``bound_ms`` (the larger of the byte and the operation time) and
    which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@functools.cache
def library():
    """``scripts/time_library_calls.py``: the PyTorch library call timed
    beside each kernel as a yardstick (the port never calls one)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import time_library_calls
    return time_library_calls


@functools.cache
def encoder_profiler():
    """``scripts/profile_torch_encode.py``: busy time and idle share."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import profile_torch_encode
    return profile_torch_encode


@functools.cache
def spatial():
    """``scripts/time_spatial_phase.py``: device time by the profiler."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import time_spatial_phase
    return time_spatial_phase


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@contextmanager
def plain_path():
    """Route the model's dispatch sites to the plain versions."""
    from lavila_tpu_torch.kernels import cls_row as KC
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    with mock.patch("lavila_tpu_torch.ops.attention.divided_phase",
                    KD.divided_phase_reference), \
            mock.patch("lavila_tpu_torch.ops.attention.cls_row",
                       KC.cls_row_attention_reference), \
            mock.patch("lavila_tpu_torch.ops.attention.flash_attention",
                       KF.flash_attention_reference), \
            mock.patch("lavila_tpu_torch.models.gpt2.flash_attention",
                       KF.flash_attention_reference), \
            mock.patch("lavila_tpu_torch.ops.basic.layer_norm",
                       KL.layer_norm_reference), \
            mock.patch("lavila_tpu_torch.ops.basic.add_layer_norm",
                       KL.add_layer_norm_reference), \
            mock.patch("lavila_tpu_torch.models.gpt2.decode_attention",
                       KDec.decode_attention_reference):
        yield


# kernel name -> (module's launch counter, its key); the divided phases'
# kernels (K1, K2, K6) sum their two branches' counters (BRANCHES)
COUNTERS = {"K1": ("divided", "space"), "K2": ("divided", "time"),
            "K3": ("layernorm", "layernorm"),
            "K4": ("layernorm", "add_layernorm"),
            "K5": ("layernorm", "add_layernorm_nosum"),
            "K6": ("divided", "space_big"),
            "K1 bwd": ("divided", "space_bwd"),
            "K2 bwd": ("divided", "time_bwd"),
            "K3 bwd": ("layernorm", "layernorm_bwd"),
            "K4 bwd": ("layernorm", "add_layernorm_bwd"),
            "K5 bwd": ("layernorm", "add_layernorm_nosum_bwd"),
            "K6 bwd": ("divided", "space_big_bwd"),
            "K9": ("decode", "decode"),
            "K7": ("flash", "flash"), "K8 fwd": ("flash", "flash_fwd"),
            "K8 bwd": ("flash", "flash_bwd"),
            "K8 dq": ("flash", "flash_dq"), "K8 dkv": ("flash", "flash_dkv"),
            "CLS row": ("cls_row", "cls_row_fwd"),
            "CLS row bwd": ("cls_row", "cls_row_bwd")}
# K8's backward kernels: the fused one ("K8 bwd") does the work of the
# TPU's dq and dk/dv kernels up to 128 tokens; their rows sum it in
FUSED_INTO = {"K8 dq": "K8 bwd", "K8 dkv": "K8 bwd"}


def _counter(module: str) -> dict:
    from lavila_tpu_torch.kernels import cls_row as KC
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    return {"divided": KD, "layernorm": KL, "decode": KDec,
            "flash": KF, "cls_row": KC}[module].launches


BRANCHES = ("tc", "simt")
# the flash kernels' counters by branch (kernels/flash.py:flash_branch)
FLASH_BRANCHES = {"flash": BRANCHES, "flash_fwd": BRANCHES,
                  "flash_bwd": ("fused",), "flash_dq": ("split", "simt"),
                  "flash_dkv": ("split", "simt")}
# the branches a bf16 path at head_dim 64 may take: the tensor cores (K8's
# split backward past 128 keys, GPT-2's cross-attention's, too)
TC_BRANCHES = ("tc", "fused", "split")
# K1's, K2's, K6's, K7's and K8's launches on the path runs by branch,
# filled by path_counts()
PATH_BRANCHES = {k: dict.fromkeys(BRANCHES, 0)
                 for k in ("K1", "K1 bwd", "K2", "K2 bwd", "K6", "K6 bwd",
                           "K7", "K8 fwd")}
PATH_BRANCHES.update({k: dict.fromkeys(("fused", "split", "simt"), 0)
                      for k in ("K8 dq", "K8 dkv")})
# the same for the path run of LaViLa's fp32 narrator recipe
# (vclm_pretrain_cli: SIMT), reported on its own line and kept out of the
# tensor-core check
RECIPE_BRANCHES = copy.deepcopy(PATH_BRANCHES)


def _counter_keys(m: str, key: str) -> list:
    """The counter keys behind one kernel: the divided phases' and the
    flash kernels' by branch."""
    if m == "divided":
        return [f"{key}_{b}" for b in BRANCHES]
    if m == "flash":
        return [f"{key}_{b}" for b in FLASH_BRANCHES[key]]
    return [key]


def launch_counts() -> dict:
    return {name: sum(_counter(m)[k] for k in _counter_keys(m, key))
            for name, (m, key) in COUNTERS.items()}


def path_counts(branches=None) -> dict:
    """:func:`launch_counts` at the end of a path run, whose K1, K2, K6,
    K7 and K8 launches by branch are added to ``branches`` (PATH_BRANCHES
    by default; K8 dq's and dkv's with the fused kernel's)."""
    for name, by in (PATH_BRANCHES if branches is None
                     else branches).items():
        m, key = COUNTERS[name]
        for b in by:
            by[b] += _counter(m).get(f"{key}_{b}", 0)
        if name in FUSED_INTO:
            by["fused"] += _counter("flash")["flash_bwd_fused"]
    for b in LN_BWD_BRANCHES:
        PATH_LN_BWD[b] += _counter("layernorm")[b]
    return launch_counts()


def check_tensor_cores(what: str, *kernels: str) -> None:
    """After a bf16 run at head_dim 64 (the counters zeroed before it):
    each of ``kernels`` (K1, K2 or K6, forward or backward) launched, and
    every divided-phase launch took the tensor cores, none the SIMT
    kernels."""
    from lavila_tpu_torch.kernels import divided as KD
    by = dict(KD.launches)
    check(all(by[f"{COUNTERS[k][1]}_tc"] > 0 for k in kernels)
          and not any(n for k, n in by.items() if k.endswith("_simt")),
          f"{what}: {', '.join(kernels)} not on the tensor cores only: "
          f"{by}")


def check_flash_tc(what: str) -> None:
    """After a bf16 run of a text tower at head_dim 64 (the counters
    zeroed before it): K7 or K8 launched, and every launch took the
    tensor cores (the forward's TMA kernel, the fused backward)."""
    from lavila_tpu_torch.kernels import flash as KF
    off = {k: n for k, n in KF.launches.items()
           if n and not k.endswith(tuple(f"_{b}" for b in TC_BRANCHES))}
    check(any(KF.launches.values()) and not off,
          f"{what}: K7/K8 not on the tensor cores only: {KF.launches}")


def reset_launch_counts() -> None:
    for m in ("divided", "layernorm", "decode", "flash", "cls_row"):
        counter = _counter(m)
        for k in counter:
            counter[k] = 0


LN_BWD_CALLS = ("layernorm_bwd", "add_layernorm_bwd",
                "add_layernorm_nosum_bwd")
LN_BWD_BRANCHES = ("ln_bwd_grid", "ln_bwd_block")
# the LayerNorm backward's launches on the path runs by branch, filled by
# path_counts()
PATH_LN_BWD = dict.fromkeys(LN_BWD_BRANCHES, 0)


def _bert(m) -> bool:
    return m.get("text") == "distilbert"


def _vit(m) -> bool:
    """Whether ``m``'s image tower is a CLIP ViT (every LayerNorm K3, the
    blocks' attention K7/K8 over every token, no divided phase)."""
    return m.get("tower") == "vit"


def _ln_pre(m) -> int:
    """1 where tower ``m`` has ``ln_pre`` (every tower but the CLIP_HF
    one's), else 0."""
    return int(m.get("ln_pre", True))


def _ln_bwd_block_calls(m, batch: int, dtype) -> int:
    """LayerNorm backward calls of one train step of dual encoder ``m``
    at ``batch`` clips whose rows one block's rings hold at once: the CLS
    rows' (norm3, norm1, norm2 a block, ln_pre's CLS half and the final
    norm), where ``batch`` rows fit; the patches', the text tower's (77
    rows a caption) and K4's/K5's take the grid. A ViT's one CLS call is
    ``ln_post``'s, a row a frame (4 a clip); its other norms take the
    whole token sequence."""
    from lavila_tpu_torch.kernels import layernorm as KL
    plan = KL.bwd_shape(m["width"], torch.empty((), dtype=dtype)
                        .element_size(), 2)
    if _vit(m):  # ln_post's CLS rows, one a frame of each clip
        return int(4 * batch <= plan.warps * plan.slots)
    return (3 * m["depth"] + 1 + _ln_pre(m)
            if batch <= plan.warps * plan.slots else 0)


@contextmanager
def trace_ln_bwd_kernels(out: list):
    """Appends to ``out`` the launches of the LayerNorm backward kernel
    (``ln_bwd_kernel``, any instantiation) that the profiler saw on the
    device while the block ran."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
        torch.cuda.synchronize()
    out.append(sum(1 for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and "ln_bwd" in ev.name))


def check_ln_bwd(what: str, m=None, batch: int = 0, steps: int = 1,
                 dtype=torch.bfloat16, device_launches=None) -> None:
    """After a run on the kernels (the counters zeroed before it): every
    LayerNorm backward call (K3, K4, K5) took one of the CUDA kernel's two
    branches; with dual encoder ``m`` trained ``steps`` steps at
    ``batch`` clips, the one-block branch exactly for the calls
    :func:`_ln_bwd_block_calls` names. Where the run was traced
    (:func:`trace_ln_bwd_kernels`), ``device_launches``, the kernel's
    launches on the device, is one a call."""
    from lavila_tpu_torch.kernels import layernorm as KL
    n = KL.launches
    calls = sum(n[k] for k in LN_BWD_CALLS)
    ok = calls > 0 and sum(n[k] for k in LN_BWD_BRANCHES) == calls
    if m is not None:
        ok = ok and n["ln_bwd_block"] == steps * _ln_bwd_block_calls(
            m, batch, dtype)
    if device_launches is not None:
        ok = ok and device_launches == calls
    check(ok, f"{what}: LayerNorm backward calls by branch "
          f"{ {k: n[k] for k in LN_BWD_CALLS + LN_BWD_BRANCHES} }, "
          f"device launches {device_launches}")


def _encode_launches(m) -> dict:
    """Kernel launches of one ``encode_image`` of tower ``m``: per block
    the two phases, K3 on norm3 (both halves), norm1 and norm2 (CLS
    half), K5 (norm1) and K4 (norm2) on the patch half, and the CLS row
    of both phases; ln_pre on both halves (where the tower has it) and the
    final norm. A ViT: K7 and
    K3 on ln_1 and ln_2 a block, ln_pre, and ln_post but in a narrator
    (which reads the patch tokens before it)."""
    depth = m["depth"]
    want = dict.fromkeys(COUNTERS, 0)
    if _vit(m):
        want.update({"K7": depth,
                     "K3": 2 * depth + 1 + int("layers" not in m)})
        return want
    want.update({m["space"]: depth, "K2": depth,
                 "K3": 4 * depth + 1 + 2 * _ln_pre(m), "K4": depth,
                 "K5": depth, "CLS row": 2 * depth})
    return want


def _text_launches(m) -> dict:
    """Kernel launches of one ``encode_text`` under inference_mode: the
    CLIP text tower's ln_1, ln_2 (K3) and causal attention (K7) a block,
    and ln_final; DistilBERT's embedding norm (K3) and its two residual
    norms a block (K5), its masked attention plain."""
    want = dict.fromkeys(COUNTERS, 0)
    depth = m["text_depth"]
    if _bert(m):
        want.update({"K3": 1, "K5": 2 * depth})
    else:
        want.update({"K3": 2 * depth + 1, "K7": depth})
    return want


def _step_launches(m, remat: bool = False,
                   dtype=torch.bfloat16, text: bool = True) -> dict:
    """Kernel launches of one train step of dual encoder ``m`` in
    ``dtype``: the encode's, the text tower's LayerNorms (ln_1, ln_2 per
    block, ln_final) and causal attention (K8's forward), and one
    backward each (K8's: one fused launch a layer in bf16, dq and dk/dv
    in fp32), except that the tower returns only the CLS row, so the last
    block's patch outputs never reach the loss: autograd runs no backward
    for its spatial phase or its K4; the CLS row, which the loss reads,
    runs its backward in both phases of every block. With remat every
    video block runs its forward again in the backward (the text tower
    has no remat).
    DistilBERT's norms run K3 and K5 forward and backward, its attention
    no kernel. The SSL loss adds no launch; without ``text`` (the
    classifier's step over ``m``'s video tower) the text tower's
    launches go. A ViT returns one tensor, so every norm and attention
    of its forward runs its backward: K8's in bf16 fused up to 128
    tokens, split past it."""
    depth = m["depth"]
    want = _encode_launches(m)
    text = _text_launches(m) if text else dict.fromkeys(COUNTERS, 0)
    if _vit(m):
        steps = dict.fromkeys(COUNTERS, 0)
        steps["K3"] = steps["K3 bwd"] = want["K3"] + text["K3"]
        steps["K8 fwd"] = want["K7"] + text["K7"]
        if dtype != torch.bfloat16:
            steps["K8 dq"] = steps["K8 dkv"] = steps["K8 fwd"]
        else:
            steps["K8 bwd"] = text["K7"]
            for k in (("K8 bwd",) if m["tokens"] <= 128
                      else ("K8 dq", "K8 dkv")):
                steps[k] += depth
        return steps
    r = 2 if remat else 1
    blocks = {k: v * r for k, v in want.items()}
    # ln_pre and the final norm run once, outside the blocks
    blocks["K3"] = want["K3"] + 4 * depth * (r - 1) + text["K3"]
    blocks["K5"] += text["K5"]
    blocks.update({f"{m['space']} bwd": depth - 1, "K2 bwd": depth,
                   "K3 bwd": want["K3"] + text["K3"], "K4 bwd": depth - 1,
                   "K5 bwd": depth + text["K5"], "CLS row bwd": 2 * depth})
    if text["K7"]:  # the CLIP text tower: K8 in training
        blocks["K8 fwd"] = text["K7"]
        text_bwd = ("K8 bwd",) if dtype == torch.bfloat16 else ("K8 dq",
                                                                 "K8 dkv")
        blocks.update(dict.fromkeys(text_bwd, text["K7"]))
    return blocks


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, torch_version=torch.__version__,
         cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False,
         **info)
    return info


def phase_build() -> float:
    from lavila_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=seconds, nvcc_seconds=build.build_seconds,
         so=build.library_path().name, ptxas=ptxas)
    return seconds


def _keys(axis, F, N) -> int:
    return N + 1 if axis == "space" else F + 1


def _phase_extras(args, run, library_call, do=None) -> dict:
    """For a divided-phase case, K1's, K2's or K6's (``args`` the
    forward's): the branch it took (with ``do`` the backward's), and the
    profiler's device time of ``run`` and of the
    library call on the same input (``scripts/time_spatial_phase.py``),
    beside their event times."""
    from lavila_tpu_torch.kernels import divided as KD
    q, k, v, ck, cv, axis, H, _ = args
    return {"branch": KD.phase_branch(q, k, v, ck, cv, axis, H, do),
            "device_ms": profiled_ms(run),
            "library_device_ms": profiled_ms(library_call)}


def measure(fn, iters: int = 20, tries: int = 3) -> dict:
    """``scripts/time_spatial_phase.py``'s measure of ``fn`` (the
    profiler's device ms per call under ``device_ms``), taken again, up
    to ``tries`` times, while its trace comes back with no kernel in it
    (``device_ms`` "not measured")."""
    for _ in range(tries):
        m = spatial().measure(fn, iters)
        if isinstance(m["device_ms"], float):
            break
    return m


def profiled_ms(fn):
    return measure(fn)["device_ms"]


def _branch_ok(branch: str, dtype, d: int) -> bool:
    """Every kernel case runs F <= 16 on aligned rows: bf16 at head_dim
    64 takes the tensor cores, everything else SIMT."""
    return branch == ("tc" if dtype == torch.bfloat16 and d == 64
                      else "simt")


def _phase_case(axis, B, F, N, D, H, dtype, gen) -> dict:
    """One K1/K2/K6 case on strided q/k/v views of a (B, F, N, 3D)
    tensor, as the attention block hands them over, with
    :func:`_phase_extras`."""
    from lavila_tpu_torch.kernels import divided as KD
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device=DEVICE).to(
        dtype)
    cls = torch.randn(B, 3 * D, generator=gen, device=DEVICE).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = cls.chunk(3, dim=-1)
    args = (q, k, v, ck, cv, axis, H, (D // H) ** -0.5)
    out, lse = KD.divided_phase(*args)
    ref, ref_lse = KD.divided_phase_reference(
        *(t.float() for t in args[:5]), *args[5:])
    torch.cuda.synchronize()
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    del ref, ref_lse
    tol = TOL[dtype]
    it, rows = q.element_size(), B * F * N
    lib = library().divided_fwd_call(q, k, v, ck, cv, axis, H)
    extras = _phase_extras(args, lambda: KD.divided_phase(*args), lib)
    return {"out_err": err, "lse_err": lse_err, "tol": tol,
            "ok": err <= tol and lse_err <= tol
            and _branch_ok(extras["branch"], dtype, D // H), **extras,
            "ms": time_ms(lambda: KD.divided_phase(*args)),
            "plain_ms": time_ms(lambda: KD.divided_phase_reference(*args)),
            **bound((4 * rows * D + 2 * B * D) * it + rows * H * 4,
                    4 * rows * _keys(axis, F, N) * D, dtype),
            "library_ms": time_ms(lib)}


def _flat_rows(*ts) -> float:
    """DistilBERT's LayerNorm cases: rows 0-15 of each of ``ts`` set to
    multiples of 1/8 (the second tensor's of 1/16), whose fp32 sums are
    exact, so their variance is 0 and LN's rstd is 1/sqrt(eps) = 1e6 in
    every version. Returns DistilBERT's eps."""
    k = torch.arange(16, device=DEVICE)[:, None]
    for t, div in zip(ts, (8, 16)):
        t[:16] = k / div
    return BERT_EPS


def _ln_fwd_checks(run, got, ref, dtype) -> dict:
    """A LayerNorm forward case's checks: the largest ratio of an
    element's error to its own limit (fp32: TOL; bf16: max(TOL,
    ``LN_BF16_REL``·|plain|)), and a second call bit-identical to the
    first."""
    ratio = 0.0
    for g, r in zip(got, ref):
        lim = torch.full_like(r, TOL[dtype])
        if dtype == torch.bfloat16:
            lim = torch.maximum(lim, r.abs() * LN_BF16_REL)
        ratio = max(ratio, ((g.float() - r).abs() / lim).max().item())
    again = run()
    again = again if isinstance(again, tuple) else (again,)
    return {"limit_ratio": ratio, "bit_identical": _all_equal(got, again)}


def _ln_case(shape, dtype, gen, bias: bool = True, bert: bool = False
             ) -> dict:
    """One K3 case; ``bias=False`` hands the kernel a zero bias, as
    ``BiasFreeLayerNorm`` (the pooler's norms) does; ``bert``:
    DistilBERT's eps and flat rows (:func:`_flat_rows`). Each case has the
    profiler's device times beside its event times."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    eps = _flat_rows(x) if bert else 1e-6
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    b = (0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    if not bias:
        b = torch.zeros_like(b)

    def run():
        return KL.layer_norm(x, w, b, eps)
    y = run()
    ref = KL.layer_norm_reference(x.float(), w.float(), b.float(), eps)
    torch.cuda.synchronize()
    err, tol = max_err(y, ref), TOL[dtype]
    checks = _ln_fwd_checks(run, (y,), (ref,), dtype)
    del ref
    lib = library().layer_norm_call(x, w, b, eps)
    extras = {"device_ms": profiled_ms(run),
              "library_device_ms": profiled_ms(lib)}
    # ~8 fp32 operations per element (statistics, normalise, scale, shift)
    return {"out_err": err, "tol": tol, **checks,
            "ok": checks["limit_ratio"] <= 1 and checks["bit_identical"],
            **extras,
            "ms": time_ms(run),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_reference(x, w, b, eps)),
            **bound((2 * x.numel() + 2 * D) * x.element_size(),
                    8 * x.numel(), torch.float32),
            "library_ms": time_ms(lib)}


def _add_ln_case(shape, dtype, gen, return_sum: bool,
                 bert: bool = False) -> dict:
    """One K4 (``return_sum``) or K5 case: LN(a + b), and the sum;
    ``bert`` as :func:`_ln_case`."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    a, b = (torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
            for _ in range(2))
    eps = _flat_rows(a, b) if bert else 1e-6
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    bias = (0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    args = (a, b, w, bias, eps, return_sum)

    def run():
        return KL.add_layer_norm(*args)
    got = run()
    ref = KL.add_layer_norm_reference(*(t.float() for t in args[:4]),
                                      *args[4:])
    torch.cuda.synchronize()
    got, ref = (got, ref) if return_sum else ((got,), (ref,))
    err, tol = max(map(max_err, got, ref)), TOL[dtype]
    checks = _ln_fwd_checks(run, got, ref, dtype)
    del ref
    lib = library().add_layer_norm_call(*args)
    extras = {"device_ms": profiled_ms(run),
              "library_device_ms": profiled_ms(lib)}
    # reads a, b, w, bias; writes y (and the sum); ~9 fp32 operations
    # per element (the add, statistics, normalise, scale, shift)
    return {"out_err": err, "tol": tol, **checks,
            "ok": checks["limit_ratio"] <= 1 and checks["bit_identical"],
            **extras,
            "ms": time_ms(run),
            "plain_ms": time_ms(
                lambda: KL.add_layer_norm_reference(*args)),
            **bound(((4 if return_sum else 3) * a.numel() + 2 * D)
                    * a.element_size(), 9 * a.numel(), torch.float32),
            "library_ms": time_ms(lib), "library_calls": 2}


def _decode_case(B, K, D, H, nv, dtype, gen) -> dict:
    """One K9 case: q/k_new/v_new as the column blocks of one (B, 3D)
    c_attn output, a (B, K, D) cache of which ``nv`` rows are valid."""
    from lavila_tpu_torch.kernels import decode as KDec
    qkv = torch.randn(B, 3 * D, generator=gen, device=DEVICE).to(dtype)
    q, kn, vn = qkv.chunk(3, dim=-1)
    kc, vc = (torch.randn(B, K, D, generator=gen, device=DEVICE).to(dtype)
              for _ in range(2))
    args = (q, kc, vc, kn, vn, nv, H)
    out = KDec.decode_attention(*args)
    ref = KDec.decode_attention_reference(
        *(t.float() for t in args[:5]), nv, H)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), TOL[dtype]
    exact = nv > 0 or torch.equal(out, vn)  # an empty cache returns v_new
    it = q.element_size()
    lib = library().decode_call(*args)
    # the main case and GPT-2 large's by the profiler too, beside the
    # launch floor
    extras = (_device_extras(lambda: KDec.decode_attention(*args), lib,
                             dtype)
              if (B, K, D, H, nv) in (MAIN_CASE["K9"], GPT2_LARGE_K9)
              else {})
    return {"out_err": err, "tol": tol, "v_new_exact": exact,
            "ok": err <= tol and exact, **extras,
            "ms": time_ms(lambda: KDec.decode_attention(*args)),
            "plain_ms": time_ms(
                lambda: KDec.decode_attention_reference(*args)),
            **bound((2 * B * nv * D + 4 * B * D) * it, 4 * B * (nv + 1) * D,
                    dtype),
            "library_ms": time_ms(lib)}


def _flash_qkv(B, H, Lq, Lk, d, dtype, gen):
    """q (B, Lq, H, d) and k/v (B, Lk, H, d) as head views of packed
    projections, as the text tower hands them over: one (B, L, 3D)
    in_proj output when Lq == Lk, else (B, Lq, D) and (B, Lk, 2D)."""
    D = H * d
    if Lq == Lk:
        q, k, v = torch.randn(B, Lq, 3 * D, generator=gen, device=DEVICE).to(
            dtype).chunk(3, dim=-1)
    else:
        q = torch.randn(B, Lq, D, generator=gen, device=DEVICE).to(dtype)
        k, v = torch.randn(B, Lk, 2 * D, generator=gen, device=DEVICE).to(
            dtype).chunk(2, dim=-1)
    return tuple(t.reshape(B, t.shape[1], H, d) for t in (q, k, v))


def _pairs(Lq, Lk, causal) -> int:
    """(query, key) pairs the mask lets through: the work of one head."""
    return sum(min(i + 1, Lk) for i in range(Lq)) if causal else Lq * Lk


def _device_extras(run, library_call, dtype) -> dict:
    """In bf16, the profiler's device time of ``run`` and of the library
    call on the same input (``scripts/time_spatial_phase.py``), beside
    their event times: these calls (K7, K8, K9, the LayerNorm backward's
    short rows) are short, and their event times carry the wrapper's host
    cost."""
    if dtype != torch.bfloat16:
        return {}
    return {"device_ms": profiled_ms(run),
            "library_device_ms": profiled_ms(library_call)}


def _flash_case(name, B, H, Lq, Lk, d, causal, dtype, gen) -> dict:
    """One K7 (``name`` 'K7') or K8 forward case against the plain
    version in fp32 on the same values, with the branch it took (bf16 at
    head_dim 64 on in_proj views: the tensor cores)."""
    from lavila_tpu_torch.kernels import flash as KF
    q, k, v = _flash_qkv(B, H, Lq, Lk, d, dtype, gen)
    scale = d ** -0.5
    with_lse = name != "K7"
    branch = KF.flash_branch(q, k, v)

    def run():
        return KF._forward(q, k, v, causal, scale, with_lse)
    got = run()
    again = run()
    ref, ref_lse = KF.flash_fwd_reference(q.float(), k.float(), v.float(),
                                          causal)
    torch.cuda.synchronize()
    same = _all_equal(got, again) if with_lse else torch.equal(got, again)
    del again
    out, lse = got if with_lse else (got, None)
    err = max_err(out, ref)
    lse_err = max_err(lse, ref_lse) if with_lse else 0.0
    tol = TOL[dtype]
    it, D = q.element_size(), H * d
    lib = library().flash_fwd_call(q, k, v, causal)
    want = "tc" if dtype == torch.bfloat16 else "simt"
    # reads q, k, v; writes out (and lse); QKᵀ and PV over the pairs
    return {"out_err": err, "lse_err": lse_err, "tol": tol, "branch": branch,
            "bit_identical": same,
            "ok": err <= tol and lse_err <= tol and branch == want and same,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(lambda: (
                KF.flash_fwd_reference if with_lse
                else KF.flash_attention_reference)(q, k, v, causal)),
            **bound((2 * B * Lq * D + 2 * B * Lk * D) * it
                    + (B * Lq * H * 4 if with_lse else 0),
                    4 * B * H * _pairs(Lq, Lk, causal) * d, dtype),
            "library_ms": time_ms(lib)}


def _flash_bwd_case(B, H, Lq, Lk, d, causal, dtype, gen) -> dict:
    """K8's whole backward on the forward kernel's lse against the plain
    backward in fp32 on the same values (errors relative to the
    reference's largest value), bit-identical over two calls, with the
    branch it took: in bf16 the fused kernel up to 128 tokens (one
    launch), the split past it (dq, then dk/dv); in fp32 the SIMT dq and
    dk/dv. Times are the whole backward's, the library call's (SDPA's by
    autograd) and the plain version's too."""
    from lavila_tpu_torch.kernels import flash as KF
    q, k, v = _flash_qkv(B, H, Lq, Lk, d, dtype, gen)
    scale = d ** -0.5
    _, lse = KF._forward(q, k, v, causal, scale, with_lse=True)
    do = torch.randn(B, Lq, H, d, generator=gen, device=DEVICE).to(dtype)
    args = (q, k, v, do, lse, causal, scale)
    branch = KF.flash_branch(q, k, v, do)
    got = KF.flash_bwd(*args)
    again = KF.flash_bwd(*args)
    ref = KF.flash_bwd_reference(*(t.float() for t in args[:4]), lse,
                                 causal, scale)
    torch.cuda.synchronize()
    tol, it, D = TOL[dtype], q.element_size(), H * d
    errs = {n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                                 ref)}
    deterministic = _all_equal(got, again)
    want = ("simt" if dtype != torch.bfloat16 else
            "fused" if max(Lq, Lk) <= 128 else "split")

    def run():
        return KF.flash_bwd(*args)
    lib = library().flash_bwd_call(q, k, v, do, causal)
    # reads q, k, v, do, lse; writes dq, dk, dv; five products (S, dP,
    # dV, dQ, dK) over the pairs the mask lets through (the kernels also
    # recompute S and dP for delta: 7 products fused, 9 split)
    return {"rel_err": errs, "abs_err_dq": max_err(got[0], ref[0]),
            "abs_err_dkv": max(max_err(got[1], ref[1]),
                               max_err(got[2], ref[2])),
            "tol": tol, "deterministic": deterministic, "branch": branch,
            "ok": max(errs.values()) <= tol and deterministic
            and branch == want,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(lambda: KF.flash_bwd_reference(*args)),
            **bound((3 * B * Lq * D + 4 * B * Lk * D) * it + B * Lq * H * 4,
                    10 * B * H * _pairs(Lq, Lk, causal) * d, dtype),
            "library_ms": time_ms(lib)}


def _cls_row_args(B, F, N, H, d, dtype, gen) -> list:
    """cls_q/k/v and kp/vp as the attention block hands them to the CLS
    row: row views of one (B, 1, 3D) and one (B, F, N, 3D) projection
    output, the rows 3D apart."""
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device=DEVICE).to(
        dtype)
    cls = torch.randn(B, 1, 3 * D, generator=gen, device=DEVICE).to(dtype)
    _, kp, vp = (t.reshape(B, F, N, H, d) for t in qkv.chunk(3, -1))
    return [t.reshape(B, 1, H, d) for t in cls.chunk(3, -1)] + [kp, vp]


def _cls_row_case(B, F, N, H, d, dtype, gen) -> dict:
    """The CLS row's forward kernel (``lavila::cls_row``) on strided row
    views against the plain row (``cls_row_attention_reference``) in fp32
    on the same values: the output's error relative to its largest value,
    lse and the fp32 output ``o`` within 1e-4 (summation order alone: a
    key left out moves lse by ~1/(F·N)), bit-identical over two calls."""
    from lavila_tpu_torch.kernels import cls_row as KC
    args = _cls_row_args(B, F, N, H, d, dtype, gen)

    def run():
        return KC.cls_row_op(*args)
    got = run()
    same = _all_equal(got, run())
    f32 = [a.float() for a in args]
    ref = KC.cls_row_attention_reference(*f32)
    _, ref_lse, ref_o = KC.cls_row_fwd_reference(*f32)
    torch.cuda.synchronize()
    out, lse, o = got
    err, abs_err = _rel_err(out, ref), max_err(out, ref)
    lse_err, o_err = max_err(lse, ref_lse), _rel_err(o, ref_o)
    del f32, ref, ref_lse, ref_o
    tol, it, L, D = TOL[dtype], args[3].element_size(), F * N, H * d
    lib = library().cls_row_call(*args)
    # reads k and v once, the CLS rows; writes out, lse and o; q·k and
    # p·v over the 1 + F·N keys in fp32
    return {"out_err": err, "abs_err": abs_err, "lse_err": lse_err,
            "o_err": o_err, "tol": tol, "bit_identical": same,
            "ok": err <= tol and lse_err <= 1e-4 and o_err <= 1e-4 and same,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(
                lambda: KC.cls_row_attention_reference(*args)),
            **bound((2 * L + 4) * B * D * it + B * H * 4 + B * D * 4,
                    4 * B * (L + 1) * D, torch.float32),
            "library_ms": time_ms(lib)}


def _cls_row_bwd_case(B, F, N, H, d, dtype, gen) -> dict:
    """The CLS row's backward kernel on strided row views, lse and o from
    the forward kernel, against the plain backward
    (``cls_row_bwd_reference``, the one held against the JAX package's
    ``_cls_row_vjp_bwd``) in fp32 on the same values: each gradient's
    error relative to its largest value, bit-identical over two calls."""
    from lavila_tpu_torch.kernels import cls_row as KC
    args = _cls_row_args(B, F, N, H, d, dtype, gen)
    _, lse, o = KC.cls_row_op(*args)
    g = torch.randn(B, 1, H, d, generator=gen, device=DEVICE).to(dtype)

    def run():
        return KC.cls_row_bwd(*args, g, lse, o)
    got = run()
    deterministic = _all_equal(got, run())
    ref = KC.cls_row_bwd_reference(*(a.float() for a in args), g.float(),
                                   lse, o)
    torch.cuda.synchronize()
    errs = {n: _rel_err(a, b) for n, a, b in
            zip(("dcls_q", "dcls_k", "dcls_v", "dkp", "dvp"), got, ref)}
    abs_err = max(map(max_err, got, ref))
    del ref
    tol, it, L, D = TOL[dtype], args[3].element_size(), F * N, H * d
    lib = library().cls_row_bwd_call(*args, g)
    # reads k, v, the CLS rows, g, lse and o; writes dk, dv and the CLS
    # rows' gradients; five products (s, dp, dk, dv, dq) in fp32
    return {"rel_err": errs, "abs_err": abs_err, "tol": tol,
            "deterministic": deterministic,
            "ok": max(errs.values()) <= tol and deterministic,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(
                lambda: KC.cls_row_bwd_reference(*args, g, lse, o)),
            **bound((4 * L + 7) * B * D * it + B * H * 4 + B * D * 4,
                    10 * B * (L + 1) * D, torch.float32),
            "library_ms": time_ms(lib)}


def _moe_case(T, k, E, S, D, I, dtype, gen) -> dict:
    """The expert layer's kernels (``kernels/moe.py``: routing, sort, the
    grouped gate/up and down products, the combine) against the plain
    path on the same bf16 values: the routing's choice exact, the
    layer's error relative to its largest value (each expert row and h
    rounded to bf16 on both sides, fp32 sums in another order),
    bit-identical over two calls. Bound: the weights of the experts that
    got rows and the rows in and out of the two products
    (``benchmark/roofline/expert.py``)."""
    from lavila_tpu_torch.kernels import moe

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen, device=DEVICE)
                * scale).to(dtype)
    x = rnd(T, D, scale=1.0)
    router, bias = rnd(E, D, scale=D ** -0.5), rnd(E, scale=0.02)
    w1, w2 = rnd(E, 2 * I, D, scale=D ** -0.5), rnd(E, D, I, scale=I ** -0.5)
    w1s, w2s = rnd(S, 2 * I, D, scale=D ** -0.5), rnd(S, D, I,
                                                       scale=I ** -0.5)
    weights, idx = moe.route(x, router, bias, k, 2.446)
    same_route = bool(torch.equal(
        idx, moe.route_reference(x, router, bias, k, 2.446)[1]))

    def run():
        return (moe.experts(x, weights, idx, w1, w2, w1s, w2s),)
    got = run()
    same = _all_equal(got, run())
    ref = moe.experts_reference(x, weights, idx, w1, w2, w1s, w2s)
    torch.cuda.synchronize()
    err, abs_err = _rel_err(got[0], ref), max_err(got[0], ref)
    del ref
    tol, it = TOL[dtype], x.element_size()
    N = T * k + S * T
    used = len(torch.unique(idx)) + S
    lib = library().moe_grouped_mm_call(x, weights, idx, w1, w2, w1s, w2s)
    res = {"out_err": err, "abs_err": abs_err, "tol": tol,
           "route_exact": same_route, "bit_identical": same,
           "ok": err <= tol and same and same_route, "ms": time_ms(run),
           "route_ms": time_ms(lambda: moe.route(x, router, bias, k, 2.446)),
           "plain_ms": time_ms(lambda: moe.experts_reference(
               x, weights, idx, w1, w2, w1s, w2s), iters=3, warmup=1),
           **bound((used * 3 * I * D + 2 * N * (D + I)) * it,
                   2 * N * 3 * I * D, dtype)}
    if lib is None:
        res.update(library_ms=None, device_ms=profiled_ms(run),
                   library="torch._grouped_mm absent")
    else:
        res.update(_device_extras(run, lib, dtype), library_ms=time_ms(lib))
    return res


# the expert layer's cases (T tokens, k of E routed experts, S shared, D,
# I): Moonlight's decode step at the cell's 160 rows, and at 960
MOE_DECODE = (160, 6, 64, 2, 2048, 1408)
MOE_960 = (960, 6, 64, 2, 2048, 1408)
# the CLS row's cases: TSF-L@336's 16 heads of 64 over 4 x 576 patches,
# at the encode cell's 16 clips and the train cell's 32
CLS_ROW_ENCODE = (16, 4, 576, 16, 64)
CLS_ROW_TRAIN = (32, 4, 576, 16, 64)
# the main-path case of each kernel, whose numbers go into the summary:
# TSF-B at batch 8 for K1/K2/K3, TSF-L@336 at batch 8 for K4/K5/K6
MAIN_CASE = {"K1": (8, 4, 196, 768, 12), "K2": (8, 4, 196, 768, 12),
             "K3": (8 * 4 * 196, 768), "K4": (8 * 4 * 576, 1024),
             "K5": (8 * 4 * 576, 1024), "K6": (8, 4, 576, 1024, 16),
             "K9": (160, 77, 1600, 25, 15),
             # the CLS row at the encode cell's 16 clips of TSF-L@336 (B,
             # F, N, H, d)
             "CLS row": CLS_ROW_ENCODE,
             # the Moonlight narrator's expert layer at 160 decode rows
             "experts": MOE_DECODE,
             # TSF-B's text tower at 16 captions (B, H, Lq, Lk, d); K8 dq
             # and dkv: the fused backward there
             **dict.fromkeys(("K7", "K8 fwd", "K8 dq", "K8 dkv"),
                             (16, 8, 77, 77, 64))}
# the ViT shapes under their sequence length: vit_577, ..., vit_50
VIT_SIDES = tuple((f"vit_{shape[2]}", shape) for _, shape in VIT_FLASH_CASES)
# further cases a kernel's summary keeps under a name: K3 on the
# narrator's decode path (one decode step's 160 GPT-2 XL rows), K1 at
# TSF-L@224 (N = 256) and at TSF-B's serving batch 32, K6 at the
# TSF-L@336 remat step's batch 32, K2 at the fine-tune's 16 frames and
# at TSF-L@336
SIDE_CASES = {"K3": (("narrator", (160, 1, 1600)),
                     ("finetune", (8 * 16 * 196, 768)), ("cls", (8, 1024)),
                     ("text", (8, 77, 512)), ("distilbert", BERT_ROWS),
                     ("gpt2", GPT2_ROWS)),
              "K5": (("distilbert", BERT_ROWS),),
              "K1": (("tsf_l_224", (8, 4, 256, 1024, 16)),
                     ("b32", (32, 4, 196, 768, 12))),
              "K6": (("b32", (32, 4, 576, 1024, 16)),),
              "CLS row": (("b32", CLS_ROW_TRAIN),),
              "experts": (("rows960", MOE_960),),
              "K2": (("f16", (8, 16, 196, 768, 12)),
                     ("tsf_l_336", (8, 4, 576, 1024, 16))),
              # GPT-2 XL's self- and cross-attention (K8 at both in the
              # caption step: the fused backward, and the split past 128
              # keys)
              **dict.fromkeys(("K7", "K8 fwd"),
                              (("b256", (256, 8, 77, 77, 64)),
                               ("gpt2_self", GPT2_SELF),
                               ("gpt2_cross", GPT2_CROSS), *VIT_SIDES)),
              # K8's backward at 256 captions (fused) and past 128 tokens
              # (the split dq and dk/dv)
              **dict.fromkeys(("K8 dq", "K8 dkv"),
                              (("b256", (256, 8, 77, 77, 64)),
                               ("split", (4, 8, 130, 260, 64)),
                               ("gpt2_self", GPT2_SELF),
                               ("gpt2_cross", GPT2_CROSS), *VIT_SIDES)),
              "K9": (("gpt2_large", GPT2_LARGE_K9),)}
_SUMMARY_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# K1's, K2's, K6's, K7's and K8's further measured numbers
# (_phase_extras, _device_extras), where a case has them; the split's
# floor is computed, so it stays on the case's own line
_EXTRA_KEYS = ("device_ms", "branch", "library_device_ms")


def _summarise(summary, name, shape, dtype, res, err_keys) -> None:
    s = summary.setdefault(name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"],
                           *(res.get(k, 0.0) for k in err_keys))
    if dtype != torch.bfloat16:
        return
    main = {k: res[k] for k in _SUMMARY_KEYS + _EXTRA_KEYS if k in res} \
        | {"at": list(shape)}
    base = name.removesuffix(" bwd")
    if shape == MAIN_CASE[base]:
        s.update(main)
    for side, at in SIDE_CASES.get(base, ()):
        if shape == at:
            s[side] = main


# the flash kernels' cases: the text towers' causal attention at 16
# captions (TSF-B: 8 heads, TSF-L: 12), and an uneven non-causal one
FLASH_CASES = (("causal", (16, 8, 77, 77, 64)),
               ("causal", (16, 12, 77, 77, 64)),
               ("full", (4, 8, 130, 260, 64)))
# GPT-2 XL's two attentions in the caption step
GPT2_FLASH_CASES = (("causal", GPT2_SELF), ("full", GPT2_CROSS))


def phase_kernels() -> dict:
    """Every kernel case; returns the main-path (bf16) case per kernel
    and each kernel's largest error over its cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf16 = torch.bfloat16
    cases = []
    for dtype in (torch.float32, bf16):
        cases += [("K1", "space", (8, 4, 196, 768, 12), dtype),
                  ("K2", "time", (8, 4, 196, 768, 12), dtype),
                  ("K2", "time", (8, 16, 196, 768, 12), dtype),
                  ("K6", "space", (2, 4, 576, 1024, 16), dtype),
                  ("K3", "ln", (8, 77, 512), dtype),
                  ("K3", "ln", (8 * 4 * 196, 768), dtype),
                  # the narrator's: a decode step's GPT-2 XL norms (200
                  # bf16 chunks a row, one a thread of 7 warps), the
                  # pooler's bias-free norms on 16 clips' 256 queries
                  ("K3", "ln", (160, 1, 1600), dtype),
                  ("K3", "ln_nobias", (16 * 256, 1600), dtype),
                  # DistilBERT's emb_layer_norm and residual norms
                  ("K3", "ln_bert", BERT_ROWS, dtype),
                  ("K5", "add_ln_nosum_bert", BERT_ROWS, dtype)]
        cases += [(k, kind, shape, dtype)
                  for k, kind in (("K4", "add_ln"), ("K5", "add_ln_nosum"))
                  for shape in ((8 * 4 * 576, 1024), (32 * 4 * 196, 768))]
        # K9: the narrator's 160 rows of GPT-2 XL, TSF-B width, and
        # GPT-2 large's (the ViT-B/16 narrator's)
        cases += [("K9", "decode", (B, 77, D, H, nv), dtype)
                  for B, D, H in ((160, 1600, 25), (16, 768, 12),
                                  (160, 1280, 20))
                  for nv in (0, 1, 15, 77)]
    # the 336px path's main cases, K1 at TSF-L@224 and at TSF-B's
    # serving batch
    cases += [("K6", "space", (8, 4, 576, 1024, 16), bf16),
              ("K6", "space", (32, 4, 576, 1024, 16), bf16),
              ("K2", "time", (8, 4, 576, 1024, 16), bf16),
              ("K1", "space", (8, 4, 256, 1024, 16), bf16),
              ("K1", "space", (32, 4, 196, 768, 12), bf16)]
    for dtype in (torch.float32, bf16):
        cases += [(k, kind, shape, dtype) for k in ("K7", "K8 fwd")
                  for kind, shape in FLASH_CASES + VIT_FLASH_CASES]
    cases += [(k, "causal", (256, 8, 77, 77, 64), bf16)
              for k in ("K7", "K8 fwd")]
    # GPT-2 XL's norms and attentions in the caption step, after the
    # earlier cases and from their own generator, so that those keep
    # their inputs
    gen_gpt2 = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    cases += [(k, kind, shape, dtype, gen_gpt2)
              for dtype in (torch.float32, bf16)
              for k, kind, shape in (("K3", "ln", GPT2_ROWS),
                                     *((k, kind, shape)
                                       for k in ("K7", "K8 fwd")
                                       for kind, shape in GPT2_FLASH_CASES))]
    # the CLS row, from its own generator
    gen_cls = torch.Generator(device=DEVICE).manual_seed(SEED + 26)
    cases += [("CLS row", "cls_row", shape, dtype, gen_cls)
              for dtype in (torch.float32, bf16)
              for shape in (CLS_ROW_ENCODE, CLS_ROW_TRAIN)]
    # the expert layer, bf16 only (its kernels take bf16), from its own
    # generator
    gen_moe = torch.Generator(device=DEVICE).manual_seed(SEED + 28)
    cases += [("experts", "moe", shape, bf16, gen_moe)
              for shape in (MOE_DECODE, MOE_960)]
    summary = {}
    with torch.inference_mode():
        for name, kind, shape, dtype, *own in cases:
            g = own[0] if own else gen
            if kind.startswith("add_ln"):
                res = _add_ln_case(shape, dtype, g, kind == "add_ln",
                                   kind.endswith("_bert"))
            elif kind.startswith("ln"):
                res = _ln_case(shape, dtype, g, kind != "ln_nobias",
                               kind.endswith("_bert"))
            elif kind == "decode":
                res = _decode_case(*shape, dtype, g)
            elif kind in ("causal", "full"):
                res = _flash_case(name, *shape, kind == "causal", dtype, g)
            elif kind == "cls_row":
                res = _cls_row_case(*shape, dtype, g)
            elif kind == "moe":
                res = _moe_case(*shape, dtype, g)
            else:
                res = _phase_case(kind, *shape[:3], shape[3], shape[4],
                                  dtype, g)
            emit("kernel", kernel=name, case=kind, shape=list(shape),
                 dtype=dname(dtype), **res)
            check(res["ok"], f"{name} {kind} {shape} {dtype}: error "
                  f"{res['out_err']} (lse {res.get('lse_err')}) > "
                  f"{res['tol']} (LayerNorm: {res.get('limit_ratio')} of "
                  f"the limit, bit-identical {res.get('bit_identical')}) "
                  f"or branch {res.get('branch')}")
            # the CLS row's out_err is relative to its largest value
            _summarise(summary, name, shape, dtype, res,
                       ("abs_err" if kind == "cls_row" else "out_err",
                        "lse_err"))
            torch.cuda.empty_cache()
    emit("launch_floor", **_launch_floor(summary))
    return summary


def _launch_floor(summary) -> dict:
    """The card's launch floor: the profiler's device time of an empty
    kernel (``torch.cuda._sleep(0)``), and the event time per call of 50
    issued back to back; beside it the short bf16 calls' device times,
    their byte bounds and their share of max(bound, floor). Fails when
    the floor or a row has no measured device time."""
    sleep = measure(lambda: torch.cuda._sleep(0), 50)
    floor = sleep["device_ms"]
    rows = {"K3 decode (160, 1, 1600)": summary["K3"].get("narrator"),
            "K3 DistilBERT (1232, 768)": summary["K3"].get("distilbert"),
            "K3 GPT-2 (608, 1600)": summary["K3"].get("gpt2"),
            "K9 (160, 77, 1600, nv 15)": summary.get("K9")}
    shares, missing = {}, []
    for name, r in rows.items():
        dev = (r or {}).get("device_ms")
        if not (isinstance(dev, float) and isinstance(floor, float)):
            missing.append(name)
            continue
        b = max(r["bound_ms"], floor)
        shares[name] = {"device_ms": dev, "bound_ms": r["bound_ms"],
                        "max_bound_floor_ms": b, "share": b / dev}
    check(not missing, f"launch floor: no device time for {missing} "
          f"(empty kernel: {floor})")
    return {"empty_kernel_device_ms": floor,
            "empty_kernel_event_ms": sleep["event_ms"],
            "empty_kernel": sleep["kernels"], "rows": shares}


def _rel_err(got, ref) -> float:
    """Largest error relative to the reference's largest magnitude."""
    return max_err(got, ref) / max(ref.float().abs().max().item(), 1e-30)


def _all_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _phase_bwd_case(axis, B, F, N, D, H, dtype, gen) -> dict:
    """K1/K2/K6 bwd on strided q/k/v views, out and lse from the forward
    kernel, against the plain backward in fp32 on the same values, with
    :func:`_phase_extras`; K1's and K6's beside the bound with the floor
    of the tensor-core split, which recomputes S and dP in both of its
    kernels, and twice in dq for delta = rowsum(P·dP) (9 products against
    5)."""
    from lavila_tpu_torch.kernels import divided as KD
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device=DEVICE).to(
        dtype)
    cls = torch.randn(B, 3 * D, generator=gen, device=DEVICE).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = cls.chunk(3, dim=-1)
    scale = (D // H) ** -0.5
    out, lse = KD.divided_phase(q, k, v, ck, cv, axis, H, scale)
    do = torch.randn(B, F, N, D, generator=gen, device=DEVICE).to(dtype)
    args = (q, k, v, ck, cv, do, out, lse, axis, H, scale)
    got = KD.divided_phase_bwd(*args)
    again = KD.divided_phase_bwd(*args)
    ref = KD.divided_phase_bwd_reference(
        *(t.float() for t in args[:8]), *args[8:])
    torch.cuda.synchronize()
    errs = {n: _rel_err(a, b) for n, a, b in
            zip(("dq", "dk", "dv", "dck", "dcv"), got, ref)}
    abs_err = max(map(max_err, got, ref))
    deterministic = _all_equal(got, again)
    del ref, again
    tol = TOL[dtype]
    it, rows = q.element_size(), B * F * N
    lib = library().divided_bwd_call(q, k, v, ck, cv, do, axis, H)
    extras = _phase_extras(args[:5] + args[8:],
                           lambda: KD.divided_phase_bwd(*args), lib, do)
    if axis == "space":
        extras["split_floor_ms"] = (18 * rows * _keys(axis, F, N) * D
                                    / PEAK_FLOPS[dtype] * 1e3)
    # reads q, k, v, do, ck, cv, lse (O is not needed); writes dq, dk, dv,
    # dck, dcv; five products (S, dP, dV, dQ, dK) of 2 operations per term
    return {"rel_err": errs, "abs_err": abs_err, "tol": tol,
            "deterministic": deterministic,
            "ok": max(errs.values()) <= tol and deterministic
            and _branch_ok(extras["branch"], dtype, D // H), **extras,
            "ms": time_ms(lambda: KD.divided_phase_bwd(*args)),
            "plain_ms": time_ms(
                lambda: KD.divided_phase_bwd_reference(*args)),
            **bound((7 * rows * D + 4 * B * D) * it + rows * H * 4,
                    10 * rows * _keys(axis, F, N) * D, dtype),
            "library_ms": time_ms(lib)}


def _near_copy_case(axis, B, F, N, D, H, dtype, gen) -> dict:
    """K1/K2/K6 bwd at keys and values (the CLS rows among them) that
    share a common part 20x their spread, against fp64 autograd through
    the plain version on the same values: dq, dck and dcv within 10%
    (bf16) or 1% (fp32) of the fp64 gradient's norm, the limits K8 is
    held to there (``tests/test_torch_cuda_kernels.py``
    ``test_divided_bwd_near_copy_keys``), beside the error of the Pallas
    kernels' form (delta = rowsum(dO·O) from the output as the kernel wrote
    it, the plain version in fp32)."""
    from lavila_tpu_torch.kernels import divided as KD

    def near_copies():
        common = torch.randn(B, 1, 1, D, generator=gen, device=DEVICE)
        return common + 0.05 * torch.randn(B, F, N, D, generator=gen,
                                           device=DEVICE)
    q = torch.randn(B, F, N, D, generator=gen, device=DEVICE).to(dtype)
    kv = [near_copies() for _ in range(2)]
    ck, cv = ((t[:, 0, 0] + 0.05 * torch.randn(B, D, generator=gen,
                                                device=DEVICE)).to(dtype)
              for t in kv)
    k, v = (t.to(dtype) for t in kv)
    do = torch.randn(B, F, N, D, generator=gen, device=DEVICE).to(dtype)
    scale = (D // H) ** -0.5
    ins = [t.double().requires_grad_() for t in (q, k, v, ck, cv)]
    with torch.enable_grad():
        ref, _ = KD.divided_phase_reference(*ins, axis, H, scale)
        want = torch.autograd.grad(ref, ins, do.double())
    del ref, ins
    out, lse = KD.divided_phase(q, k, v, ck, cv, axis, H, scale)
    got = KD.divided_phase_bwd(q, k, v, ck, cv, do, out, lse, axis, H,
                               scale)
    # the plain version on the same values in fp32: delta = rowsum(dO·O)
    # from the output as the kernel wrote it (in bf16 rounded), the Pallas
    # kernels' form
    pallas_form = KD.divided_phase_bwd_reference(
        *(t.float() for t in (q, k, v, ck, cv, do, out)), lse, axis, H,
        scale)
    names = {"dq": 0, "dck": 3, "dcv": 4}

    def rel(gs):
        return {n: ((gs[i].double() - want[i]).norm()
                    / want[i].norm()).item() for n, i in names.items()}
    errs = rel(got)
    tol = 0.1 if dtype == torch.bfloat16 else 0.01
    branch = KD.phase_branch(q, k, v, ck, cv, axis, H, do)
    return {"rel_err_fp64": errs,
            "pallas_form_rel_err_fp64": rel(pallas_form), "tol": tol,
            "branch": branch,
            "ok": max(errs.values()) <= tol
            and _branch_ok(branch, dtype, D // H)}


def _ln_bwd_branch(call) -> tuple:
    """``call()``'s result and the branches of the LayerNorm backward
    kernel that it took, by the counters it bumped (one)."""
    from lavila_tpu_torch.kernels import layernorm as KL
    before = dict(KL.launches)
    out = call()
    return out, [k for k in ("ln_bwd_grid", "ln_bwd_block")
                 if KL.launches[k] != before[k]]


def _ln_bwd_case(shape, dtype, gen, wdtype=None, bert: bool = False
                 ) -> dict:
    """K3 bwd; ``wdtype``: γ's dtype where it is not the rows' (the bf16
    step's fp32 γ); ``bert`` and the device times as :func:`_ln_case`."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    eps = _flat_rows(x) if bert else 1e-6
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(
        wdtype or dtype)
    dy = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    got, branch = _ln_bwd_branch(lambda: KL.layer_norm_bwd(x, w, dy, eps))
    again = KL.layer_norm_bwd(x, w, dy, eps)
    ref = KL.layer_norm_bwd_reference(x.float(), w.float(), dy.float(), eps)
    torch.cuda.synchronize()
    errs = {n: _rel_err(a, b) for n, a, b in
            zip(("dx", "dweight", "dbias"), got, ref)}
    tol = TOL[dtype]
    wl = w.to(dtype)  # F.layer_norm takes γ in the rows' dtype
    b = torch.zeros_like(wl)
    lib = library().layer_norm_bwd_call(x, wl, b, dy, eps)
    extras = _device_extras(lambda: KL.layer_norm_bwd(x, w, dy, eps), lib,
                            dtype) if bert or shape in LN_DEVICE_ROWS else {}
    # reads x, dy, w; writes dx, dw, db; ~12 fp32 operations per element
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "branch": branch, "gamma": dname(w.dtype), **extras,
            "ok": max(errs.values()) <= tol and _all_equal(got, again)
            and len(branch) == 1,
            "ms": time_ms(lambda: KL.layer_norm_bwd(x, w, dy, eps)),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_bwd_reference(x, w, dy, eps)),
            **bound((3 * x.numel() + 3 * D) * x.element_size(),
                    12 * x.numel(), torch.float32),
            "library_ms": time_ms(lib)}


def _add_ln_bwd_case(shape, dtype, gen, return_sum: bool,
                     wdtype=None, bert: bool = False) -> dict:
    """K4 bwd (``return_sum``: from the saved sum, d(sum) folded into dx)
    or K5 bwd (the pair re-added); ``wdtype`` and ``bert`` as
    :func:`_ln_bwd_case`."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    a, b, dy, ds = (torch.randn(*shape, generator=gen, device=DEVICE)
                    .to(dtype) for _ in range(4))
    eps = _flat_rows(a, b) if bert else 1e-6
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(
        wdtype or dtype)
    args = ((a, None, w, dy, ds, eps) if return_sum
            else (a, b, w, dy, None, eps))
    got, branch = _ln_bwd_branch(lambda: KL.add_layer_norm_bwd(*args))
    again = KL.add_layer_norm_bwd(*args)
    ref = KL.add_layer_norm_bwd_reference(
        *(None if t is None else t.float() for t in args[:5]), eps)
    torch.cuda.synchronize()
    errs = {n: _rel_err(x, y) for n, x, y in
            zip(("dx", "dweight", "dbias"), got, ref)}
    tol = TOL[dtype]
    lib = library().add_layer_norm_bwd_call(
        a, b, w.to(dtype), torch.zeros_like(w, dtype=dtype), dy,
        ds if return_sum else None, eps)
    extras = _device_extras(lambda: KL.add_layer_norm_bwd(*args), lib,
                            dtype) if bert else {}
    # reads the sum, dy, d(sum) (K4) or a, b, dy (K5), and w; writes dx,
    # dw, db; ~13 fp32 operations per element
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "branch": branch, "gamma": dname(w.dtype), **extras,
            "ok": max(errs.values()) <= tol and _all_equal(got, again)
            and len(branch) == 1,
            "ms": time_ms(lambda: KL.add_layer_norm_bwd(*args)),
            "plain_ms": time_ms(
                lambda: KL.add_layer_norm_bwd_reference(*args)),
            **bound((4 * a.numel() + 3 * D) * a.element_size(),
                    13 * a.numel(), torch.float32),
            "library_ms": time_ms(lib)}


def phase_kernels_bwd() -> dict:
    """Every backward kernel case, as :func:`phase_kernels`. Errors are
    relative to the reference's largest magnitude (dck/dcv and dγ/dβ are
    sums over many rows); two calls must give the same bits."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("K1 bwd", "space", (8, 4, 196, 768, 12), dtype),
                  ("K2 bwd", "time", (8, 4, 196, 768, 12), dtype),
                  ("K2 bwd", "time", (8, 16, 196, 768, 12), dtype),
                  ("K6 bwd", "space", (2, 4, 576, 1024, 16), dtype)]
        # the LayerNorm backward: the text tower's rows, TSF-B's patches
        # and one row more, one row, TSF-L's CLS rows (one block), the
        # fine-tune's 16 frames, GPT-2 XL's width
        cases += [("K3 bwd", "ln", shape, dtype)
                  for shape in ((8, 77, 512), (8 * 4 * 196, 768),
                                (8 * 4 * 196 + 1, 768), (1, 768), (8, 1024),
                                (8 * 16 * 196, 768), (64, 1600))]
        cases += [(k, kind, shape, dtype)
                  for k, kind in (("K4 bwd", "add_ln"),
                                  ("K5 bwd", "add_ln_nosum"))
                  for shape in ((8 * 4 * 576, 1024), (32 * 4 * 196, 768),
                                (8 * 4 * 196 + 1, 768), (8, 1024))]
        # DistilBERT's norms (eps 1e-12, flat rows)
        cases += [("K3 bwd", "ln_bert", BERT_ROWS, dtype),
                  ("K5 bwd", "add_ln_nosum_bert", BERT_ROWS, dtype)]
    # bf16 rows with fp32 γ, as the bf16 train step hands them over
    cases += [("K3 bwd", "ln+f32w", shape, torch.bfloat16)
              for shape in ((8 * 4 * 196, 768), (8, 1024))]
    cases += [(k, f"{kind}+f32w", (8 * 4 * 576, 1024), torch.bfloat16)
              for k, kind in (("K4 bwd", "add_ln"),
                              ("K5 bwd", "add_ln_nosum"))]
    cases += [("K6 bwd", "space", (8, 4, 576, 1024, 16), torch.bfloat16),
              ("K6 bwd", "space", (32, 4, 576, 1024, 16), torch.bfloat16),
              ("K2 bwd", "time", (8, 4, 576, 1024, 16), torch.bfloat16),
              ("K1 bwd", "space", (8, 4, 256, 1024, 16), torch.bfloat16),
              ("K1 bwd", "space", (32, 4, 196, 768, 12), torch.bfloat16),
              ("K1 bwd", "space", (1, 2, 256, 1024, 16), torch.float32)]
    # GPT-2 XL's attentions and norms in the caption step, after the
    # earlier cases and from their own generator, so that those keep
    # their inputs
    gen_gpt2 = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    cases += [("K3 bwd", "ln", GPT2_ROWS, dtype, gen_gpt2)
              for dtype in (torch.float32, torch.bfloat16)]
    cases.append(("K3 bwd", "ln+f32w", GPT2_ROWS, torch.bfloat16, gen_gpt2))
    # the CLS row, from its own generator
    gen_cls = torch.Generator(device=DEVICE).manual_seed(SEED + 27)
    cases += [("CLS row bwd", "cls_row", shape, dtype, gen_cls)
              for dtype in (torch.float32, torch.bfloat16)
              for shape in (CLS_ROW_ENCODE, CLS_ROW_TRAIN)]
    summary = {}
    flash = [(kind, shape, dtype) for dtype in (torch.float32, torch.bfloat16)
             for kind, shape in FLASH_CASES + VIT_FLASH_CASES]
    flash.append(("causal", (256, 8, 77, 77, 64), torch.bfloat16))
    flash += [(kind, shape, dtype, gen_gpt2)
              for dtype in (torch.float32, torch.bfloat16)
              for kind, shape in GPT2_FLASH_CASES]
    for kind, shape, dtype, *own in flash:
        with torch.no_grad():
            res = _flash_bwd_case(*shape, kind == "causal", dtype,
                                  own[0] if own else gen)
        emit("kernel_bwd", kernel="K8 bwd", case=kind, shape=list(shape),
             dtype=dname(dtype), **res)
        check(res["ok"], f"K8 bwd {kind} {shape} {dtype}: relative errors "
              f"{res['rel_err']} > {res['tol']}, not deterministic "
              f"({res['deterministic']}) or branch {res['branch']}")
        # the TPU's dq and dk/dv kernels' rows: both hold the whole
        # backward's numbers, each its own errors
        _summarise(summary, "K8 dq", shape, dtype, res, ("abs_err_dq",))
        _summarise(summary, "K8 dkv", shape, dtype, res, ("abs_err_dkv",))
        torch.cuda.empty_cache()
    for name, kind, shape, dtype, *own in cases:
        # "+f32w": fp32 γ beside the rows' dtype
        wdtype = torch.float32 if kind.endswith("+f32w") else None
        g = own[0] if own else gen
        with torch.no_grad():
            bert = kind.endswith("_bert")
            if kind.startswith("add_ln"):
                res = _add_ln_bwd_case(shape, dtype, g,
                                       kind.startswith("add_ln+")
                                       or kind == "add_ln", wdtype, bert)
            elif kind.startswith("ln"):
                res = _ln_bwd_case(shape, dtype, g, wdtype, bert)
            elif kind == "cls_row":
                res = _cls_row_bwd_case(*shape, dtype, g)
            else:
                res = _phase_bwd_case(kind, *shape[:3], shape[3], shape[4],
                                      dtype, g)
        emit("kernel_bwd", kernel=name, case=kind, shape=list(shape),
             dtype=dname(dtype), **res)
        check(res["ok"], f"{name} {shape} {dtype}: relative errors "
              f"{res['rel_err']} > {res['tol']}, not deterministic "
              f"({res['deterministic']}) or branch {res.get('branch')}")
        if wdtype is None:
            _summarise(summary, name, shape, dtype, res, ("abs_err",))
        else:  # its errors only
            s = summary.setdefault(name, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], res["abs_err"])
        torch.cuda.empty_cache()
    # K1, K2 and K6 at near-copy keys, from their own generator
    gen_copies = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    for dtype in (torch.float32, torch.bfloat16):
        for name, axis, shape in (("K1 bwd", "space", (8, 4, 196, 768, 12)),
                                  ("K2 bwd", "time", (8, 4, 196, 768, 12)),
                                  ("K6 bwd", "space",
                                   (2, 4, 576, 1024, 16))):
            res = _near_copy_case(axis, *shape, dtype, gen_copies)
            emit("kernel_bwd", kernel=name, case="near_copy_keys",
                 shape=list(shape), dtype=dname(dtype), **res)
            check(res["ok"], f"{name} near-copy keys {shape} {dtype}: "
                  f"errors against fp64 {res['rel_err_fp64']} > "
                  f"{res['tol']} or branch {res['branch']}")
            torch.cuda.empty_cache()
    return summary


def _clip_model(m, **kw):
    """Dual encoder ``m`` (with ``m["kw"]``, its zoo options)
    initialised on the card from a seeded generator, its time attention
    (a TimeSformer's) given seeded noise (:func:`_seed_time_attention`),
    its video tower cut to ``m["depth"]`` blocks where that is fewer than
    the zoo's (:func:`_cut`)."""
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = build_model(m["name"], device=DEVICE, generator=gen,
                        **m.get("kw", {}), **kw)
    _seed_time_attention(model.visual, gen)
    v = model.visual
    blocks = v.blocks if hasattr(v, "blocks") else v.transformer.resblocks
    del blocks[m["depth"]:]
    return model


def _cut(m, **depths) -> dict:
    """Configuration ``m`` with fewer blocks (``depth``) or GPT-2 layers
    (``layers``, ``cross``), its widths as published: the phases that
    build their models here run cut so that the script keeps inside its
    time limit (PERF.md §4 lists each cut)."""
    return dict(m, **depths, cut={k: f"{m[k]} -> {v}"
                                  for k, v in depths.items()})


# the cut configurations (widths as published): TSF-B's steps at 4 of 12
# blocks, TSF-L's at 8 of 24, ViT-B/16's at 4 of 12, the GPT-2 XL
# narrators at 16 of 48 layers (their cross-attention on every second,
# the flagship's every third, layer of those)
MODEL_CUT = _cut(MODEL, depth=4)
DISTIL_BASE_CUT = _cut(DISTIL_BASE, depth=4)
LARGE224_CUT = _cut(LARGE224, depth=8)
LARGE_CUT = _cut(LARGE, depth=8)
VIT_B16_CUT = _cut(VIT_B16, depth=4)
NARRATOR_CUT = _cut(NARRATOR, layers=16, cross=8)
FLAGSHIP_CUT = _cut(FLAGSHIP, layers=16, cross=6)
VIT_NARRATOR_CUT = _cut(VIT_NARRATOR, layers=16, cross=8)


@torch.no_grad()
def _seed_time_attention(visual, gen) -> None:
    """A TimeSformer's time attention given seeded noise, and each
    block's tanh gate (where it has one) 0.5 + noise: at their zero init
    the time attention's output is constant across channels, which the
    norm after it removes, and the gate is tanh(0) = 0, so K2's and the
    gate's checks would be vacuous."""
    for blk in getattr(visual, "blocks", ()):
        for lin in (blk.timeattn.qkv, blk.timeattn.proj):
            lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=gen)
            lin.bias.normal_(0.0, 0.02, generator=gen)
        if blk.alpha_timeattn is not None:
            blk.alpha_timeattn.uniform_(0.4, 0.6, generator=gen)


def _inputs(B, gen, size: int = 224, frames: int = 4):
    frames = torch.randn(B, frames, size, size, 3, generator=gen,
                         device=DEVICE)
    text = torch.randint(1, 49407, (B, 77), generator=gen, device=DEVICE)
    eot = torch.randint(5, 77, (B,), generator=gen, device=DEVICE)
    text[torch.arange(B, device=DEVICE), eot] = 49407
    return frames, text


def _bert_text(B, gen):
    """``B`` DistilBERT captions of 77 positions and their {0, 1} masks:
    lengths spread evenly from 2 tokens to all 77, each [CLS], WordPiece
    ids drawn from the vocabulary's words, [SEP], then [PAD]."""
    lengths = torch.linspace(2, 77, B).round().long().to(DEVICE)[:, None]
    pos = torch.arange(77, device=DEVICE)[None]
    ids = torch.randint(1000, BERT_VOCAB, (B, 77), generator=gen,
                        device=DEVICE)
    ids[:, 0] = BERT_CLS
    ids = torch.where(pos == lengths - 1, BERT_SEP, ids)
    mask = (pos < lengths).float()
    return torch.where(mask > 0, ids, BERT_PAD), mask


@contextmanager
def bert_vocab():
    """A WordPiece vocabulary in distilbert-base-uncased's layout ([PAD]
    0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, then the words of the
    synthetic captions and digits) in a temporary directory named by
    ``LAVILA_TOKENIZER_DIR`` while the block runs."""
    import tempfile
    words = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "synthetic",
                "clip", "#", "c"] + [str(i) for i in range(10)]
             + [f"##{i}" for i in range(10)])
    with tempfile.TemporaryDirectory() as root:
        sub = os.path.join(root, "distilbert-base-uncased")
        os.makedirs(sub)
        with open(os.path.join(sub, "vocab.txt"), "w") as f:
            f.write("\n".join(words) + "\n")
        with mock.patch.dict(os.environ, {"LAVILA_TOKENIZER_DIR": root}):
            yield


def phase_model(m, model=None) -> None:
    """Dual encoder ``m`` (``model`` when given, else
    :func:`_clip_model`'s): embeddings on the kernel path against the
    plain path on the same weights (fp32, then bf16) at ``m["batch"]``
    clips (4 by default), launches per call, then encode_image clips/s."""
    from lavila_tpu_torch.models.dual_encoder import l2_normalize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    batch = m.get("batch", 4)
    frames, text = _inputs(batch, gen, m["img"])
    model = _clip_model(m) if model is None else model
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            img = model.encode_image(frames)
            torch.cuda.synchronize()
            per_image = launch_counts()
            if dtype == torch.bfloat16 and _vit(m):
                check_flash_tc(f"{m['name']} bf16 encode_image")
            elif dtype == torch.bfloat16:
                check_tensor_cores(f"{m['name']} bf16 encode_image",
                                   m["space"], "K2")
            reset_launch_counts()
            txt = model.encode_text(text)
            torch.cuda.synchronize()
            per_text = launch_counts()
            if dtype == torch.bfloat16:
                check_flash_tc(f"{m['name']} bf16 encode_text")
            with plain_path():
                img_ref = model.encode_image(frames)
                txt_ref = model.encode_text(text)
        res = {}
        for name, a, b in (("image", img, img_ref), ("text", txt, txt_ref)):
            a, b = l2_normalize(a.float()), l2_normalize(b.float())
            res[f"{name}_max_err"] = max_err(a, b)
            res[f"{name}_cos_min"] = (a * b).sum(-1).min().item()
            res[f"{name}_finite"] = bool(torch.isfinite(a).all())
        emit("model", model=m["name"], dtype=dname(dtype), batch=batch,
             **({"kw": m["kw"]} if "kw" in m else {}),
             launches_per_encode_image=per_image,
             launches_per_encode_text=per_text, **res)
        check(res["image_finite"] and res["text_finite"],
              f"{m['name']} {dtype}: non-finite embeddings")
        check(per_image == _encode_launches(m)
              and per_text == _text_launches(m),
              f"{m['name']} {dtype}: launches image {per_image} text "
              f"{per_text}")
        if dtype == torch.float32:
            check(res["image_max_err"] <= 1e-3 and
                  res["text_max_err"] <= 1e-3,
                  f"{m['name']} fp32 kernel vs plain: {res}")
        else:
            check(res["image_cos_min"] >= 0.999 and
                  res["text_cos_min"] >= 0.999,
                  f"{m['name']} bf16 kernel vs plain: {res}")
            _throughput(model, gen, m)


def _throughput(model, gen, m, iters: int = 5) -> None:
    """bf16 encode_image clips/s at ``m``'s serving batch of 4 frames,
    kernels/plain/plain/kernels; for a ViT also the kernel path's busy
    time, idle share and peak memory per call."""
    batch = m["serve_batch"]
    frames = torch.randn(batch, 4, m["img"], m["img"], 3, generator=gen,
                         device=DEVICE)
    rates = {}
    with torch.inference_mode():
        for path in ("kernels", "plain", "plain", "kernels"):
            with plain_path() if path == "plain" else nullcontext():
                for _ in range(2):
                    model.encode_image(frames)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    model.encode_image(frames)
                torch.cuda.synchronize()
                rate = batch * iters / (time.perf_counter() - t0)
            rates.setdefault(path, []).append(rate)
    emit("throughput", what="encode_image clips/s", model=m["name"],
         dtype="bfloat16", batch=batch,
         frames=4, iters=iters, order="kernels, plain, plain, kernels",
         clips_per_s=rates)
    if _vit(m):
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            model.encode_image(frames)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            emit("serve_profile", model=m["name"], dtype="bfloat16",
                 batch=batch, frames=4, peak_memory_gib=peak,
                 **_profile(lambda: model.encode_image(frames)))


def _profile(fn, iters: int = 5) -> dict:
    """The device's busy time per call of ``fn`` (the profiler's kernel
    sum, ``scripts/profile_torch_encode.py``), the call's time by CUDA
    events, the idle share of the untraced call (1 − busy / that time)
    beside the traced one's, launches per call and the top kernels."""
    p = encoder_profiler().profile(fn, iters)
    busy, ms = p["device_busy_ms_per_call"], p["ms_per_call"]
    return {"ms_per_call": ms, "device_busy_ms_per_call": busy,
            "idle_share": max(0.0, 1 - busy / ms),
            "idle_share_traced": p["idle_share"],
            "launches_per_call": p["launches_per_call"],
            "top_kernels": p["top_kernels"][:6]}


def phase_distilbert_model(m) -> None:
    """DistilBERT dual encoder ``m`` at its serving batch: embeddings on
    the kernel path against the plain path on the same weights (fp32,
    then bf16) over captions of 2 to 77 tokens under their masks,
    launches per call (no flash kernel: the attention is plain), ids
    past each mask redrawn without moving a text embedding; then, in
    bf16, clips/s and captions/s (kernels/plain/plain/kernels), the
    device's busy time and idle share per call, and the kernel path's
    peak memory."""
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.models.dual_encoder import l2_normalize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    B = m["serve_batch"]
    frames, _ = _inputs(B, gen, m["img"])
    text, mask = _bert_text(B, gen)
    redrawn = torch.where(mask > 0, text, torch.randint(
        1000, BERT_VOCAB, text.shape, generator=gen, device=DEVICE))
    model = _clip_model(m)
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            img = model.encode_image(frames)
            torch.cuda.synchronize()
            per_image = launch_counts()
            if dtype == torch.bfloat16:
                check_tensor_cores(f"{m['name']} bf16 encode_image",
                                   m["space"], "K2")
            reset_launch_counts()
            txt = model.encode_text(text, mask)
            torch.cuda.synchronize()
            per_text = launch_counts()
            flash = sum(KF.launches.values())
            txt_redrawn = model.encode_text(redrawn, mask)
            with plain_path():
                img_ref = model.encode_image(frames)
                txt_ref = model.encode_text(text, mask)
        res = {"padded_ids_err": max_err(txt_redrawn, txt)}
        for name, a, b in (("image", img, img_ref), ("text", txt, txt_ref)):
            a, b = l2_normalize(a.float()), l2_normalize(b.float())
            res[f"{name}_max_err"] = max_err(a, b)
            res[f"{name}_cos_min"] = (a * b).sum(-1).min().item()
            res[f"{name}_finite"] = bool(torch.isfinite(a).all())
        emit("distilbert_model", model=m["name"], dtype=dname(dtype),
             batch=B, caption_tokens=mask.sum(1).long().tolist(),
             launches_per_encode_image=per_image,
             launches_per_encode_text=per_text, **res)
        name = f"{m['name']} {dname(dtype)}"
        check(res["image_finite"] and res["text_finite"],
              f"{name}: non-finite embeddings")
        check(per_image == _encode_launches(m)
              and per_text == _text_launches(m) and flash == 0,
              f"{name}: launches image {per_image} text {per_text}, "
              f"flash {flash}")
        check(res["padded_ids_err"] == 0.0,
              f"{name}: ids past the mask moved the text embedding by "
              f"{res['padded_ids_err']}")
        if dtype == torch.float32:
            check(res["image_max_err"] <= 1e-3
                  and res["text_max_err"] <= 1e-3,
                  f"{name} kernel vs plain: {res}")
        else:
            check(res["image_cos_min"] >= 0.999
                  and res["text_cos_min"] >= 0.999,
                  f"{name} kernel vs plain: {res}")
    _serve_rates(model, frames, text, mask, m)


def _serve_rates(model, frames, text, mask, m, iters: int = 5) -> None:
    """bf16 clips/s and captions/s of a DistilBERT dual encoder at the
    serving batch (kernels/plain/plain/kernels), then the kernel path's
    busy time and idle share per call and its peak memory."""
    B = frames.shape[0]
    calls = {"clips_per_s": lambda: model.encode_image(frames),
             "captions_per_s": lambda: model.encode_text(text, mask)}
    rates = {k: {} for k in calls}
    with torch.inference_mode():
        for path in ("kernels", "plain", "plain", "kernels"):
            with plain_path() if path == "plain" else nullcontext():
                for what, fn in calls.items():
                    for _ in range(2):
                        fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                    rates[what].setdefault(path, []).append(
                        B * iters / (time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats()
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        profiles = {"encode_image": _profile(calls["clips_per_s"]),
                    "encode_text": _profile(calls["captions_per_s"])}
    emit("throughput", what="encode_image clips/s, encode_text captions/s",
         model=m["name"], dtype="bfloat16", batch=B, frames=4, iters=iters,
         order="kernels, plain, plain, kernels", **rates,
         peak_memory_gib=peak, profile=profiles)


def _openai_checkpoint(m, path: str) -> dict:
    """Dual encoder ``m``'s seeded weights (:func:`_clip_model`) written
    to ``path`` as OpenAI releases its CLIP ViTs: fp16, under OpenAI's
    names, beside the three metadata entries. Returns the weights."""
    model = _clip_model(m)
    sd = {k: v.half().cpu() for k, v in model.state_dict().items()}
    del model
    meta = {"input_resolution": m["img"], "context_length": 77,
            "vocab_size": 49408}
    torch.save({**sd, **{k: torch.tensor(v) for k, v in meta.items()}},
               path)
    return sd


def phase_cli(m) -> dict:
    """The port CLI's functions on the synthetic dataset; a CLIP ViT reads
    a ``.pt`` in OpenAI's layout (:func:`_openai_checkpoint`), which must
    arrive as written. Returns the launch counts of this run, the
    serving path's."""
    import numpy as np

    from lavila_tpu_torch.data import transforms as T
    from lavila_tpu_torch.data.datasets import (DatasetConfig,
                                                VideoCaptionDataset)
    from lavila_tpu_torch.data.loader import DataLoader
    from lavila_tpu_torch.eval import metrics as M
    from lavila_tpu_torch.cli import eval_zeroshot as cli

    argv = ["--model", m["name"], "--bf16", "--device", DEVICE,
            "--clip-length", "4", "--batch-size", "8", "--workers", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        if _vit(m):
            path = os.path.join(tmp, f"{m['name']}.pt")
            written = _openai_checkpoint(m, path)
            argv += ["--checkpoint", path]
        args = cli.get_args_parser().parse_args(argv)
        t0 = time.perf_counter()
        with bert_vocab() if _bert(m) else nullcontext():
            model, tokenizer, name = cli.load_model_from_checkpoint(args)
        load_seconds = time.perf_counter() - t0
    if _vit(m):
        sd = model.state_dict()
        same = set(sd) == set(written) and all(
            torch.equal(v, written[k].to(v)) for k, v in sd.items())
        check(same, f"CLI {name}: the OpenAI-layout weights did not arrive "
              "as written")
        del written
    mean, std = T.normalization_for_model(name)
    transform = T.EvalTransform(cli.crop_shape(name)[0], mean, std)
    ds = VideoCaptionDataset(
        DatasetConfig(dataset="synthetic", root="", metadata="",
                      clip_length=args.clip_length, subsample_stride=8),
        transform, tokenizer, is_training=False)
    loader = DataLoader(ds, args.batch_size, shuffle=False,
                        drop_last=False, num_workers=args.workers)
    reset_launch_counts()
    t0 = time.perf_counter()
    v, t, _ = cli.embed_dataset(model, loader, has_mask=_bert(m))
    seconds = time.perf_counter() - t0
    counts = path_counts()
    sim = v @ t.T
    rel = np.eye(len(v), dtype=np.float32)
    v_map, t_map, avg_map = M.retrieval_map(sim, rel)
    v_ndcg, t_ndcg, avg_ndcg = M.retrieval_ndcg(sim, rel)
    metrics = {"mAP_v2t": v_map, "mAP_t2v": t_map, "mAP_avg": avg_map,
               "nDCG_v2t": v_ndcg, "nDCG_t2v": t_ndcg,
               "nDCG_avg": avg_ndcg}
    emit("cli", model=name, dtype="bfloat16", clips=len(v),
         embed_shape=[list(v.shape), list(t.shape)], seconds=seconds,
         load_seconds=load_seconds, launches=counts, metrics=metrics)
    dim = m["embed"]
    check(v.shape == (len(ds), dim) and t.shape == (len(ds), dim)
          and bool(np.isfinite(v).all() and np.isfinite(t).all()),
          f"CLI {name} embeddings {v.shape} {t.shape} not finite or "
          "misshapen")
    check(all(0.0 <= x <= 1.0 for x in metrics.values()),
          f"CLI metrics out of range: {metrics}")
    batches = -(-len(ds) // args.batch_size)
    per_batch = {k: n + _text_launches(m)[k]
                 for k, n in _encode_launches(m).items()}
    check(counts == {k: n * batches for k, n in per_batch.items()},
          f"CLI {name} launches {counts} for {batches} batches")
    return counts


def _make_state(model, dtype, seed: int = SEED + 8, frozen=None,
                criterion=None):
    """A TrainState with the CLI's default AdamW recipe (warm-up from
    1e-6 over 100-step epochs); drop-path masks from a seeded generator;
    the parameters that ``frozen`` names left out of the optimizer; the
    loss's own parameters ``criterion`` (name → initial value)."""
    from lavila_tpu_torch.train.freeze import freeze_by_predicate
    from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from lavila_tpu_torch.train.step import TrainState
    schedule = cosine_schedule(3e-5, 1e-5, 5, 100, warmup_epochs=1,
                               start_warmup_lr=1e-6)
    return TrainState.create(
        model, lambda params: make_optimizer(
            freeze_by_predicate(params, frozen or (lambda n: False)),
            schedule), dtype=dtype,
        generator=torch.Generator(device=DEVICE).manual_seed(seed),
        criterion=criterion)


# LaViLa's EK-100 CLS recipe (--use-vn-classifier --num-classes 97 300
# 3806): the verb, noun and action heads over the video tower at 16
# frames, SGD with momentum 0.9, the backbone at a tenth of the head's
# rate, label smoothing 0.1, dropout 0.5 and drop-path 0.1
EK100_HEADS = [97, 300, 3806]
# the SSL loss's pseudo temperature at its CLI default, 0.07
PSEUDO_INIT = math.log(1 / 0.07)


def _classify_state(model, dtype, seed: int = SEED + 8):
    """A TrainState of the classification CLI's recipe: the head and the
    backbone (at 0.1 times the head's rate) as two SGD groups, each
    clipped by its own norm, under the CLI's default schedule over
    100-step epochs."""
    from lavila_tpu_torch.train.optim import (cosine_schedule,
                                              lr_multiplier_labels,
                                              make_multi_optimizer)
    from lavila_tpu_torch.train.step import TrainState
    names = [n for n, _ in model.named_parameters()]
    lrs = {label: cosine_schedule(lr, 1e-5, 100, 100, 2, 1e-6)
           for label, lr in (("head", 3e-3), ("backbone", 3e-4))}
    return TrainState.create(
        model, lambda params: make_multi_optimizer(
            params, lr_multiplier_labels(names), lrs, weight_decay=1e-4,
            clip_grad_value=1.0, use_sgd=True), dtype=dtype,
        generator=torch.Generator(device=DEVICE).manual_seed(seed))


def _state_and_step(kind: str, model, dtype, norm_embed: bool = True):
    """The TrainState and the step of a run of ``kind``: ``clip``
    (pretraining), ``ssl`` (pretraining on human and pseudo narrations),
    ``retrieval`` (the fine-tune's adaptive max-margin, logit_scale
    frozen) or ``classify`` (the EK-100 heads' step)."""
    from lavila_tpu_torch.train.freeze import logit_scale_only
    from lavila_tpu_torch.train.step import (make_classifier_train_step,
                                             make_clip_train_step,
                                             make_retrieval_train_step)
    if kind == "classify":
        return (_classify_state(model, dtype),
                make_classifier_train_step(multihead=True,
                                           label_smoothing=0.1))
    if kind == "retrieval":
        return (_make_state(model, dtype, frozen=logit_scale_only),
                make_retrieval_train_step(norm_embed=norm_embed))
    crit = {"logit_scale_pseudo": PSEUDO_INIT} if kind == "ssl" else None
    return (_make_state(model, dtype, criterion=crit),
            make_clip_train_step(norm_embed=norm_embed,
                                 use_ssl=kind == "ssl"))


def _train_batch(B, gen, size: int = 224, frames: int = 4,
                 bert: bool = False):
    """A batch of ``B`` clips; ``bert``: DistilBERT captions and their
    masks (:func:`_bert_text`). The SSL step reads ``gt_indicators``,
    human and pseudo narrations in turn."""
    frames, text = _inputs(B, gen, size, frames)
    # the EK-100 relevancy of each clip, for the adaptive margin
    rel = torch.rand(B, generator=gen, device=DEVICE)
    ind = (torch.arange(B, device=DEVICE) % 2 == 0).float()
    batch = {"frames": frames, "text": text, "relevancy": rel,
             "gt_indicators": ind}
    if bert:
        batch["text"], batch["mask"] = _bert_text(B, gen)
    return batch


def _classify_batch(B, gen, size: int, frames: int = 16):
    """``B`` clips of ``frames`` frames at ``size``² and their verb, noun
    and action labels in :data:`EK100_HEADS`."""
    return {"frames": torch.randn(B, frames, size, size, 3, generator=gen,
                                  device=DEVICE),
            "labels": tuple(torch.randint(0, n, (B,), generator=gen,
                                          device=DEVICE)
                            for n in EK100_HEADS)}


def _branch_counts() -> dict:
    """The flash kernels' and the LayerNorm backward's launches since the
    counters were zeroed, by branch (the ones that launched)."""
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    return {k: n for k, n in {**KF.launches, **{
        b: KL.launches[b] for b in LN_BWD_BRANCHES}}.items() if n}


def _run_steps(m, base, dtype, batch, plain: bool, steps: int = 2,
               kind: str = "clip", branches: list | None = None):
    """``steps`` train steps of ``kind`` (:func:`_state_and_step`) from a
    copy of ``base`` (dual encoder ``m``, or a classifier over its video
    tower): the losses, each step's fp32 gradients (the SSL loss's pseudo
    scale's too) and the launch counts of each step; on the kernels every
    step's LayerNorm backward is checked by branch, and the first step's
    launches of its kernel on the device (traced) one a call; each
    kernel step's launches by branch (:func:`_branch_counts`) are
    appended to ``branches`` when given."""
    # normalised embeddings (--norm-embed) keep the logits within
    # ±logit_scale; raw random-init embeddings give logits in the
    # hundreds, where bf16 rounding alone moves the loss by percents
    state, step_fn = _state_and_step(kind, copy.deepcopy(base).train(),
                                     dtype)
    losses, grads, counts = [], [], []
    with plain_path() if plain else nullcontext():
        for _ in range(steps):
            reset_launch_counts()
            traced = []
            with trace_ln_bwd_kernels(traced) if not plain and not counts \
                    else nullcontext():
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
            counts.append(launch_counts())
            if not plain:
                check_ln_bwd(f"{m['name']} {dname(dtype)} train step "
                             f"{len(counts)}", m,
                             batch["frames"].shape[0], dtype=dtype,
                             device_launches=traced[0] if traced else None)
            if (dtype == torch.bfloat16 and not plain and not _bert(m)
                    and kind != "classify"):
                check_flash_tc(f"bf16 train step {len(counts)}")
                if not _vit(m):
                    check_tensor_cores(f"bf16 train step {len(counts)}",
                                       "K2", "K2 bwd")
            if branches is not None and not plain:
                branches.append(_branch_counts())
            losses.append(metrics["loss"].item())
            grads.append({k: p.grad.clone() for k, p in
                          {**state.params, **state.criterion}.items()
                          if p.grad is not None})
    del state
    return losses, grads, counts


# DistilBERT's key biases, whose exact gradient is zero (a softmax is
# invariant to a shift of all of a query's scores): both paths give fp32
# rounding noise there, reported beside the limits and not held to them
ZERO_GRAD = ("attention.k_lin.bias",)


def _compare_steps(a, b) -> dict:
    """Two runs of :func:`_run_steps`: the largest relative loss gap, the
    largest gradient error relative to its tensor's largest value, and
    the smallest cosine of a weight matrix's (2-D, and the 4-D patch-embed
    kernel's) gradient; the 3-D embeddings (cls_token, pos_embed,
    temporal_embed) are reported beside them, and the largest gradient of
    the :data:`ZERO_GRAD` tensors."""
    (a_loss, a_grads, _), (b_loss, b_grads, _) = a, b
    rel_loss = max(abs(x - y) / abs(y) for x, y in zip(a_loss, b_loss))
    worst_err = zero_grad = 0.0
    worst_at = None
    worst = {"matrices": (1.0, None), "embeddings": (1.0, None)}
    for step, (ag, bg) in enumerate(zip(a_grads, b_grads)):
        for name, g in bg.items():
            x = ag[name]
            if name.endswith(ZERO_GRAD):
                zero_grad = max(zero_grad, g.abs().max().item(),
                                x.abs().max().item())
                continue
            scale = g.abs().max().item()
            if scale > 0 and max_err(x, g) / scale > worst_err:
                worst_err, worst_at = max_err(x, g) / scale, \
                    f"step {step}: {name}"
            if g.dim() >= 2 and scale > 0:
                cos = torch.nn.functional.cosine_similarity(
                    x.flatten(), g.flatten(), dim=0).item()
                kind = "embeddings" if g.dim() == 3 else "matrices"
                if cos < worst[kind][0]:
                    worst[kind] = (cos, f"step {step}: {name}")
    return {"loss_rel_err": rel_loss, "grad_rel_err_max": worst_err,
            "grad_rel_err_max_at": worst_at,
            "grad_cos_min": worst["matrices"][0],
            "grad_cos_min_at": worst["matrices"][1],
            "embed_grad_cos_min": worst["embeddings"][0],
            "embed_grad_cos_min_at": worst["embeddings"][1],
            "zero_grad_max": zero_grad}


def phase_train_step(m, batches: dict, throughput: tuple,
                     phase: str = "train_step", seed: int = SEED + 3,
                     kind: str = "clip") -> None:
    """The train step of dual encoder ``m`` at full depth (``kind``
    ``clip`` or ``ssl``, :func:`_state_and_step`), kernel path against
    the plain path from the same weights and batch (``batches``: the
    batch size of each dtype, one batch drawn per size); then train
    clips/s at the ``throughput`` batch sizes."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    base = _clip_model(m)
    data = {}
    for dtype, size in batches.items():
        if size not in data:
            data[size] = _train_batch(size, gen, m["img"], bert=_bert(m))
        batch = data[size]
        branches = []
        k_run = _run_steps(m, base, dtype, batch, False, kind=kind,
                           branches=branches)
        p_run = _run_steps(m, base, dtype, batch, True, kind=kind)
        res = _compare_steps(k_run, p_run)
        if _vit(m):
            res["launches_by_branch"] = branches
        name = f"{m['name']} {dname(dtype)} {kind}"
        if kind == "ssl":  # the pseudo scale's gradient, compared in res
            res["pseudo_grad"] = {
                path: [g["logit_scale_pseudo"].item() for g in run[1]]
                for path, run in (("kernels", k_run), ("plain", p_run))}
        emit(phase, model=m["name"], dtype=dname(dtype), batch=size,
             steps=2, loss_kernels=k_run[0], loss_plain=p_run[0],
             launches_per_step=k_run[2], **res)
        check(all(math.isfinite(x) for x in k_run[0] + p_run[0]),
              f"train step {name}: non-finite loss {k_run[0]} {p_run[0]}")
        want = _step_launches(m, dtype=dtype)
        check(all(c == want for c in k_run[2]),
              f"train step {name}: launches {k_run[2]}, want {want}")
        if dtype == torch.float32:
            check(res["loss_rel_err"] <= 1e-5
                  and res["grad_rel_err_max"] <= 1e-4,
                  f"train step {name} kernels vs plain: {res}")
        else:
            check(res["loss_rel_err"] <= 1e-2 and res["grad_cos_min"] >= 0.99,
                  f"train step {name} kernels vs plain: {res}")
        del k_run, p_run
    del data
    if throughput:
        _train_throughput(base, gen, m, throughput, iters=5, kind=kind)


def _time_steps(state, step_fn, data, iters: int) -> tuple:
    """Train clips/s over ``iters`` steps after 2 warm-up steps, and the
    peak device memory in GiB."""
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step_fn(state, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, data)
    torch.cuda.synchronize()
    return (data["frames"].shape[0] * iters / (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / 2**30)


def _in_turns(state, step_fn, data, iters: int, on_kernels=None) -> tuple:
    """:func:`_time_steps` on the kernel and the plain path in turns
    (kernels, plain, plain, kernels): the clips/s and peak memory of each
    path's two runs; ``on_kernels()`` checks each kernel run's launch
    counters, zeroed before it."""
    rates, peaks = {}, {}
    for path in ("kernels", "plain", "plain", "kernels"):
        reset_launch_counts()
        with plain_path() if path == "plain" else nullcontext():
            rate, peak = _time_steps(state, step_fn, data, iters)
        if path == "kernels" and on_kernels is not None:
            on_kernels()
        rates.setdefault(path, []).append(rate)
        peaks.setdefault(path, []).append(peak)
    return rates, peaks


def _train_throughput(base, gen, m, batches, iters: int = 5,
                      kind: str = "clip") -> None:
    """Train clips/s and peak memory, bf16, kernel and plain path in
    alternating order, at each of ``batches``: for TSF-B 16 (bench.py's
    TSF-B batch), where the host's issue time bounds the step, and 48,
    where the device does; for TSF-L@224 8; for TSF-B + DistilBERT 16,
    with the kernel path's step profiled (device busy time, idle
    share), as for TSF-B's SSL step at 16."""
    state, step_fn = _state_and_step(kind, base.train(), torch.bfloat16,
                                     norm_embed=False)
    for batch in batches:
        data = _train_batch(batch, gen, m["img"], bert=_bert(m))
        rates, peaks = _in_turns(state, step_fn, data, iters)
        emit("train_throughput", what=f"{kind} train step clips/s",
             model=m["name"], dtype="bfloat16", batch=batch, frames=4,
             iters=iters, remat=False, order="kernels, plain, plain, "
             "kernels", clips_per_s=rates, peak_memory_gib=peaks)
        if _bert(m) or _vit(m):
            emit("train_profile", model=m["name"], dtype="bfloat16",
                 batch=batch, **_profile(lambda: step_fn(state, data)))
        if kind == "ssl":  # the CLIP step beside it: same weights, batch
            clip_state, clip_fn = _state_and_step(
                "clip", copy.deepcopy(base), torch.bfloat16,
                norm_embed=False)
            for k, st, fn in (("ssl", state, step_fn),
                              ("clip", clip_state, clip_fn)):
                emit("train_profile", model=m["name"], dtype="bfloat16",
                     batch=batch, kind=k,
                     **_profile(lambda: fn(st, data), iters=3))
            del clip_state
        del data


def phase_large_train_step(m=LARGE) -> None:
    """TSF-L@336's train step: kernels against plain (fp32, batch 2),
    remat against no remat with drop-path 0.1 (fp32, batch 2, both on the
    kernels), then bf16 clips/s and peak memory with and without remat."""
    from lavila_tpu_torch.train.step import make_clip_train_step
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    batch = _train_batch(2, gen, m["img"])
    fp32 = torch.float32
    base = _clip_model(m)
    k_run = _run_steps(m, base, fp32, batch, False)
    p_run = _run_steps(m, base, fp32, batch, True)
    res = _compare_steps(k_run, p_run)
    emit("large_train_step", model=m["name"], dtype="float32", batch=2,
         steps=2, what="kernels vs plain", loss_kernels=k_run[0],
         loss_plain=p_run[0], launches_per_step=k_run[2], **res)
    check(all(math.isfinite(x) for x in k_run[0] + p_run[0])
          and res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"TSF-L@336 train step fp32 kernels vs plain: {res}")
    want = _step_launches(m, dtype=fp32)
    check(all(c == want for c in k_run[2]),
          f"TSF-L@336 train step launches {k_run[2]}, want {want}")
    del k_run, p_run

    # remat: the same weights, drop-path 0.1, masks from one seeded
    # generator (the TrainState's), remat off against on
    runs = {}
    for remat in (False, True):
        model = _clip_model(m, drop_path_rate=0.1, remat=remat)
        model.load_state_dict(base.state_dict())
        runs[remat] = _run_steps(m, model, fp32, batch, False)
        del model
    res = _compare_steps(runs[True], runs[False])
    emit("large_train_step", model=m["name"], dtype="float32", batch=2,
         steps=2, what="remat vs no remat, drop_path_rate 0.1",
         loss_remat=runs[True][0], loss_no_remat=runs[False][0],
         launches_per_step_remat=runs[True][2], **res)
    check(res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"TSF-L@336 train step remat vs no remat: {res}")
    want = _step_launches(m, remat=True, dtype=fp32)
    check(all(c == want for c in runs[True][2]),
          f"TSF-L@336 remat step launches {runs[True][2]}, want {want}")
    del runs

    # bf16 clips/s and peak memory at batch 8, in turns: remat off (first
    # and last) against on, and with remat the kernels against the plain
    # path (without remat the plain path's fp32 scores, 0.68 GB per
    # phase and tensor, do not fit in 80 GB); then the largest of 32 and
    # 16 that fits with remat
    step_fn = make_clip_train_step()
    state = _make_state(base.train(), torch.bfloat16)
    del base
    data = _train_batch(8, gen, m["img"])
    rates, peaks = {}, {}
    for remat, path in ((False, "kernels"), (True, "kernels"),
                        (True, "plain"), (True, "plain"), (True, "kernels"),
                        (False, "kernels")):
        state.model.visual.remat = remat
        reset_launch_counts()
        with plain_path() if path == "plain" else nullcontext():
            rate, peak = _time_steps(state, step_fn, data, 5)
        torch.cuda.synchronize()
        key = f"{path}, remat" if remat else path
        if path == "kernels":  # every K2, K6, K7, K8 launch on the tensor
            # cores
            check_tensor_cores(f"TSF-L@336 bf16 step ({key})", "K6",
                               "K6 bwd", "K2", "K2 bwd")
            check_flash_tc(f"TSF-L@336 bf16 step ({key})")
            check_ln_bwd(f"TSF-L@336 bf16 step ({key})", m, 8, 7)
        rates.setdefault(key, []).append(rate)
        peaks.setdefault(key, []).append(peak)
    emit("train_throughput", what="train step clips/s", model=m["name"],
         dtype="bfloat16", batch=8, frames=4, iters=5,
         order="kernels, kernels+remat, plain+remat, plain+remat, "
         "kernels+remat, kernels", clips_per_s=rates, peak_memory_gib=peaks)
    del data
    state.model.visual.remat = True
    for batch_size in (32, 16):
        data = _train_batch(batch_size, gen, m["img"])
        try:
            rate, peak = _time_steps(state, step_fn, data, 5)
        except torch.cuda.OutOfMemoryError:
            emit("train_throughput", model=m["name"], remat=True,
                 batch=batch_size, out_of_memory=True)
            del data
            torch.cuda.empty_cache()
            continue
        emit("train_throughput", what="train step clips/s",
             model=m["name"], dtype="bfloat16", batch=batch_size,
             frames=4, iters=5, remat=True, clips_per_s=rate,
             peak_memory_gib=peak)
        break  # the largest of 32 and 16 that fits


def phase_pretrain_cli(m, steps: int, batch: int, flags=()) -> dict:
    """The port's pretraining CLI for ``steps`` steps on the synthetic
    dataset (bf16), then the port's zero-shot loader reads the checkpoint
    and embeds a batch: train → save → serve. Returns the launch counts
    of the training run, the training path's."""
    import tempfile

    from lavila_tpu_torch.config import parse_config
    from lavila_tpu_torch.cli import eval_zeroshot as ez
    from lavila_tpu_torch.cli import main_pretrain as cli
    ssl = "--metadata-aux" in flags
    with tempfile.TemporaryDirectory() as out:
        cfg = parse_config(cli.TorchPretrainConfig, [
            "--dataset", "synthetic", "--model", m["name"], "--steps",
            str(steps), "--batch-size", str(batch), "--workers", "4",
            "--print-freq", "1", "--device", DEVICE, "--output-dir", out,
            *flags])
        reset_launch_counts()
        t0 = time.perf_counter()
        with bert_vocab() if _bert(m) else nullcontext():
            state = cli.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = path_counts()
        with open(os.path.join(out, "log.txt")) as f:
            log = json.loads(f.readlines()[-1])
        files = sorted(os.listdir(out))
        ckpt = os.path.join(out, "checkpoint_latest.pt")
        if ssl:  # the classification CLI's --pretrain-model
            for suffix in ("", ".json"):
                shutil.copy(ckpt + suffix, SSL_CHECKPOINT + suffix)
            saved = torch.load(ckpt, map_location="cpu",
                               weights_only=True)["criterion"]
        args = ez.get_args_parser().parse_args(
            ["--checkpoint", ckpt, "--device", DEVICE, "--bf16"])
        with bert_vocab() if _bert(m) else nullcontext():
            model, _, name = ez.load_model_from_checkpoint(args)
    same = all(torch.equal(p, state.params[k].to(p.dtype))
               for k, p in model.named_parameters())
    if ssl:  # learnt, unclamped, and in the checkpoint
        pseudo = state.criterion["logit_scale_pseudo"].detach().cpu()
        emit("pretrain_cli", model=m["name"], logit_scale_pseudo=[
            PSEUDO_INIT, pseudo.item()])
        check(pseudo.item() != PSEUDO_INIT
              and torch.equal(saved["logit_scale_pseudo"], pseudo),
              f"SSL pretrain CLI: logit_scale_pseudo {pseudo.item()} "
              f"(from {PSEUDO_INIT}), checkpoint {saved}")
    del state
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    frames, text = _inputs(2, gen, m["img"])
    text = _bert_text(2, gen) if _bert(m) else (text,)
    with torch.inference_mode():
        img, txt = model.encode_image(frames), model.encode_text(*text)
    emit("pretrain_cli", model=name, dtype="bfloat16", batch=batch,
         steps=steps, flags=list(flags), seconds=seconds,
         train_loss=log["train_loss"], files=files, launches=counts,
         reloaded_equal=same,
         embed_shape=[list(img.shape), list(txt.shape)])
    check(math.isfinite(log["train_loss"]),
          f"pretrain CLI {name}: loss {log['train_loss']}")
    check({"checkpoint_latest.pt", "checkpoint_latest.pt.json",
           "checkpoint_0000.pt", "checkpoint_0000.pt.json"} <= set(files),
          f"pretrain CLI wrote {files}")
    check(same, "the served model differs from the trained masters")
    dim = m["embed"]
    check(img.shape == (2, dim) and txt.shape == (2, dim)
          and bool(torch.isfinite(img).all() and torch.isfinite(txt).all()),
          f"served embeddings {img.shape} {txt.shape} not finite")
    per_step = _step_launches(m, remat="--use-checkpoint" in flags)
    check(counts == {k: steps * n for k, n in per_step.items()},
          f"pretrain CLI {name} launches {counts} for {steps} steps")
    return counts


def phase_finetune_step(m=MODEL) -> None:
    """The retrieval fine-tune's step on BASE at 16 frames (adaptive
    max-margin with relevancy weights, logit_scale frozen): 2 fp32 steps,
    kernel path against plain path from the same weights and batch, held
    to the pretraining step's limits; then bf16 clips/s and peak memory
    at batch 8, kernels/plain/plain/kernels."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    base = _clip_model(m, num_frames=16)
    batch = _train_batch(4, gen, m["img"], 16)
    k_run = _run_steps(m, base, torch.float32, batch, False,
                       kind="retrieval")
    p_run = _run_steps(m, base, torch.float32, batch, True,
                       kind="retrieval")
    res = _compare_steps(k_run, p_run)
    emit("finetune_step", model=m["name"], dtype="float32", batch=4,
         frames=16, steps=2, loss="adaptive_max_margin",
         loss_kernels=k_run[0], loss_plain=p_run[0],
         launches_per_step=k_run[2], **res)
    check(all(math.isfinite(x) for x in k_run[0] + p_run[0])
          and res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"fine-tune step fp32 kernels vs plain: {res}")
    want = _step_launches(m, dtype=torch.float32)
    check(all(c == want for c in k_run[2]),
          f"fine-tune step launches {k_run[2]}, want {want}")
    del k_run, p_run
    state, step_fn = _state_and_step("retrieval", base.train(),
                                     torch.bfloat16)
    data = _train_batch(8, gen, m["img"], 16)

    def on_kernels():  # K2 over 16 frames on the tensor cores
        check_tensor_cores("fine-tune bf16 step", "K2", "K2 bwd")
        check_ln_bwd("fine-tune bf16 step", m, 8, 7)
    rates, peaks = _in_turns(state, step_fn, data, 5, on_kernels)
    emit("train_throughput", what="retrieval fine-tune step clips/s",
         model=m["name"], dtype="bfloat16", batch=8, frames=16, iters=5,
         loss="adaptive_max_margin", order="kernels, plain, plain, kernels",
         clips_per_s=rates, peak_memory_gib=peaks)


def phase_finetune_cli(m) -> dict:
    """The port's retrieval fine-tune CLI for 3 steps (``m`` at 16
    frames, bf16, batch 8, adaptive max-margin, synthetic data): a finite
    loss, logit_scale bit-equal to its initial log(1/0.07). Returns the
    launch counts of the run, the fine-tune path's."""
    import tempfile

    from lavila_tpu_torch.cli import main_finetune_retrieval as cli
    steps = 3
    with tempfile.TemporaryDirectory() as out:
        args = cli.get_args_parser().parse_args(
            ["--dataset", "synthetic", "--model", m["name"],
             "--clip-length", "16", "--batch-size", "8", "--steps",
             str(steps), "--bf16", "--workers", "4", "--print-freq", "1",
             "--device", DEVICE, "--output-dir", out])
        reset_launch_counts()
        t0 = time.perf_counter()
        state = cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = path_counts()
        with open(os.path.join(out, "log.txt")) as f:
            log = json.loads(f.readlines()[-1])
        files = sorted(os.listdir(out))
    scale = state.params["logit_scale"].detach().cpu()
    frozen = torch.equal(scale, torch.tensor(math.log(1 / 0.07)))
    emit("finetune_cli", model=m["name"], dtype="bfloat16", batch=8,
         frames=16, steps=steps, loss="adaptive_max_margin",
         seconds=seconds, train_loss=log["train_loss"],
         logit_scale=scale.item(), logit_scale_unchanged=frozen,
         files=files, launches=counts)
    check(math.isfinite(log["train_loss"]) and state.step == steps,
          f"fine-tune CLI: loss {log['train_loss']}, {state.step} steps")
    check(frozen, f"fine-tune CLI moved logit_scale to {scale.item()}")
    check("checkpoint_latest.pt" in files, f"fine-tune CLI wrote {files}")
    check(counts == {k: steps * n for k, n in _step_launches(m).items()},
          f"fine-tune CLI launches {counts} for {steps} steps")
    del state
    return counts


def _classifier(m, frames: int = 16):
    """A ``VideoClassifierMultiHead`` with :data:`EK100_HEADS` over dual
    encoder ``m``'s video tower (seeded as :func:`_clip_model`, at
    ``frames`` frames, drop-path 0.1), dropout 0.5, its heads seeded on
    the card; and the dual encoder it came from."""
    from lavila_tpu_torch.models.dual_encoder import VideoClassifierMultiHead
    base = _clip_model(m, num_frames=frames, drop_path_rate=0.1)
    clf = VideoClassifierMultiHead(base.visual, EK100_HEADS, 0.5).to(DEVICE)
    clf.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED + 15),
                     backbone=False)
    return clf, base


def phase_classify_step(m=MODEL) -> None:
    """The classification fine-tune's step: EK-100's verb, noun and
    action heads over TSF-B at 16 frames (SGD, backbone at 0.1 times the
    head's rate, each group clipped by its own norm, label smoothing 0.1,
    dropout and drop-path from one seeded generator): 2 steps kernel path
    against plain path in fp32 at batch 4 and bf16 at batch 16 (the JAX
    CLI's default batch), held to the pretraining step's limits; bf16
    clips/s and peak memory at batch 16 in turns; the profiler's busy
    time of the classify step and of the retrieval fine-tune's step on
    the same tower and batch size."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    clf, dual = _classifier(m)
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 16)):
        batch = _classify_batch(size, gen, m["img"])
        k_run = _run_steps(m, clf, dtype, batch, False, kind="classify")
        p_run = _run_steps(m, clf, dtype, batch, True, kind="classify")
        res = _compare_steps(k_run, p_run)
        name = f"classify step {dname(dtype)}"
        emit("classify_step", model=m["name"], heads=EK100_HEADS,
             dtype=dname(dtype), batch=size, frames=16, steps=2,
             loss_kernels=k_run[0], loss_plain=p_run[0],
             launches_per_step=k_run[2], **res)
        check(all(math.isfinite(x) for x in k_run[0] + p_run[0]),
              f"{name}: non-finite loss {k_run[0]} {p_run[0]}")
        want = _step_launches(m, dtype=dtype, text=False)
        check(all(c == want for c in k_run[2]),
              f"{name}: launches {k_run[2]}, want {want}")
        if dtype == torch.float32:
            check(res["loss_rel_err"] <= 1e-5
                  and res["grad_rel_err_max"] <= 1e-4,
                  f"{name} kernels vs plain: {res}")
        else:
            check(res["loss_rel_err"] <= 1e-2 and res["grad_cos_min"] >= 0.99,
                  f"{name} kernels vs plain: {res}")
        del k_run, p_run, batch
    state, step_fn = _state_and_step("classify", clf, torch.bfloat16)
    data = _classify_batch(16, gen, m["img"])

    def on_kernels():  # K2 over 16 frames on the tensor cores
        check_tensor_cores("classify bf16 step", "K1", "K1 bwd", "K2",
                           "K2 bwd")
        check_ln_bwd("classify bf16 step", m, 16, 7)
    rates, peaks = _in_turns(state, step_fn, data, 5, on_kernels)
    emit("train_throughput", what="classify step clips/s",
         model=m["name"], heads=EK100_HEADS, dtype="bfloat16", batch=16,
         frames=16, iters=5, order="kernels, plain, plain, kernels",
         clips_per_s=rates, peak_memory_gib=peaks)
    emit("train_profile", model=m["name"], dtype="bfloat16", batch=16,
         frames=16, kind="classify",
         **_profile(lambda: step_fn(state, data), iters=3))
    del state, clf
    r_state, r_fn = _state_and_step("retrieval", dual.train(),
                                    torch.bfloat16)
    r_data = _train_batch(16, gen, m["img"], 16)
    emit("train_profile", model=m["name"], dtype="bfloat16", batch=16,
         frames=16, kind="retrieval",
         **_profile(lambda: r_fn(r_state, r_data), iters=3))


def phase_classify_cli(m) -> dict:
    """The port's ``main_finetune_classification`` for 3 steps (``m`` at
    16 frames, one head of 3806 classes, SGD, backbone x 0.1, label
    smoothing 0.1, bf16, batch 16, synthetic data) from the SSL
    pretraining CLI's checkpoint: the video tower arrives bit-equal to
    the checkpoint's (its temporal embedding fitted to 16 frames), the
    loss is finite. Returns the launch counts of the run, the
    classification path's."""
    import tempfile

    from lavila_tpu_torch.cli import main_finetune_classification as cli
    from lavila_tpu_torch.models.convert import load_reference_checkpoint
    steps, arrived = 3, []
    build = cli.build_classifier

    def spy(*args, **kw):  # the tower as the run built it
        clf, config = build(*args, **kw)
        arrived.append({k: v.detach().cpu().clone()
                        for k, v in clf.vision_model.state_dict().items()})
        return clf, config
    with tempfile.TemporaryDirectory() as out, \
            mock.patch.object(cli, "build_classifier", spy):
        args = cli.get_args_parser().parse_args(
            ["--dataset", "synthetic", "--model", m["name"],
             "--num-classes", "3806", "--clip-length", "16", "--use-sgd",
             "--lr-multiplier-on-backbone", "0.1", "--label-smoothing",
             "0.1", "--bf16", "--batch-size", "16", "--steps", str(steps),
             "--pretrain-model", SSL_CHECKPOINT, "--workers", "4",
             "--print-freq", "1", "--device", DEVICE, "--output-dir", out])
        reset_launch_counts()
        t0 = time.perf_counter()
        state = cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = path_counts()
        with open(os.path.join(out, "log.txt")) as f:
            log = json.loads(f.readlines()[-1])
    want = {k.removeprefix("visual."): v for k, v in load_reference_checkpoint(
        SSL_CHECKPOINT, num_frames=16).items() if k.startswith("visual.")}
    same = (len(arrived) == 1 and set(arrived[0]) == set(want)
            and all(torch.equal(arrived[0][k], v) for k, v in want.items()))
    emit("classify_cli", model=m["name"], dtype="bfloat16", batch=16,
         frames=16, steps=steps, seconds=seconds,
         train_loss=log["train_loss"], tower_arrived_equal=same,
         launches=counts)
    check(math.isfinite(log["train_loss"]) and state.step == steps,
          f"classify CLI: loss {log['train_loss']}, {state.step} steps")
    check(same, "classify CLI: the video tower differs from the "
          "pretraining checkpoint's")
    want_counts = _step_launches(m, text=False)
    check(counts == {k: steps * n for k, n in want_counts.items()},
          f"classify CLI launches {counts} for {steps} steps")
    del state
    return counts


def _narrator_model(n):
    """Narrator ``n`` (fp32) initialised on the card from a seeded
    generator, its cross-attention gates and its time attention (a
    TimeSformer's) given seeded non-zero values (zero gates would make the
    cross-attention check vacuous, as zero time attention would K2's).
    Returns it and the init's seconds."""
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    model = build_model(n["name"], device=DEVICE, generator=gen,
                        gated_xattn=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dec = model.text_decoder
    del dec.transformer.h[n["layers"]:]  # a cut narrator (:func:`_cut`)
    dec.cfg = dataclasses.replace(dec.cfg, n_layer=n["layers"])
    check(sum(b.has_cross for b in dec.transformer.h) == n["cross"],
          f"{n['name']}: {n['cross']} cross-attention layers expected in "
          f"{n['layers']}")
    with torch.no_grad():
        for blk in model.text_decoder.transformer.h:
            if blk.has_cross:
                for a in (blk.alpha_cattn, blk.alpha_dense):
                    a.uniform_(0.3, 0.9, generator=gen)
        for blk in getattr(model.visual, "blocks", ()):
            for lin in (blk.timeattn.qkv, blk.timeattn.proj):
                lin.weight.normal_(0.0, lin.in_features ** -0.5,
                                   generator=gen)
                lin.bias.normal_(0.0, 0.02, generator=gen)
    return model, seconds


def _steps_run(ids, eos: int, L: int) -> int:
    """The decode steps ``generate`` ran for ``ids``: step i writes
    column i + 1, and the loop stops once every row holds EOS, so it ran
    as many steps as the column of the last row's first EOS (L - 1 when
    a row never samples one)."""
    hit = ids[:, 1:] == eos
    first = torch.where(hit.any(1), hit.long().argmax(1) + 1, L - 1)
    return int(first.max())


def _cached_logits(model, tokens, text, steps: int):
    """Logits of ``text[:, :steps]`` fed one token at a time through the
    cache, and the launch counts of the last step."""
    from lavila_tpu_torch.models.gpt2 import init_cache
    kv = model.prepare_decode(tokens)
    cache = init_cache(model.text_decoder.cfg, text.shape[0], steps,
                       dtype=tokens.dtype, device=DEVICE,
                       width=model.text_decoder.cache_width())
    out = []
    for i in range(steps):
        reset_launch_counts()
        out.append(model.decode_step(text[:, i:i + 1], kv, cache, i))
    torch.cuda.synchronize()
    return torch.stack(out, 1), launch_counts()


def _greedy(model, tokens, n, L: int):
    return model.generate(tokens, generator=None, bos_id=n["bos"],
                          eos_id=n["eos"], max_text_length=L,
                          top_k=1, num_return_sequences=2)


def _partings(model, tokens_ref, ids, ids_ref, nrs: int = 2) -> list:
    """Where a row of the kernel path's greedy ids first parts from the
    plain path's: the row, the step, and the plain path's logit gap
    between the two tokens there (its teacher-forced forward over the
    shared prefix, from the plain path's image tokens of the row's clip;
    ``nrs`` rows a clip)."""
    out = []
    for r in range(ids.shape[0]):
        apart = (ids[r] != ids_ref[r]).nonzero()
        if not len(apart):
            continue
        s = int(apart[0])
        with plain_path():
            logits = model.text_decoder(
                ids_ref[r:r + 1, :s], encoder_states=tokens_ref[
                    r // nrs:r // nrs + 1])[0, -1].float()
        out.append({"row": r, "step": s, "tokens": [int(ids_ref[r, s]),
                                                    int(ids[r, s])],
                    "gap": (logits[ids_ref[r, s]]
                            - logits[ids[r, s]]).abs().item()})
    return out


def _cos_min(a, b) -> float:
    """The smallest cosine between matching rows (last axis)."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def phase_narrator(n, measure: bool = True) -> None:
    """Narrator ``n``, kernel path against plain path on the same weights
    (fp32, then bf16); with ``measure``, a profile of decode steps and
    narrations/s. In bf16 every narrator is held to one rule: the kernel
    path's cached-decode logits part from the full forward by at most
    1.25x what the plain path's do (the margin narrator_train_step gives
    K8), and each row's greedy ids agree with the plain path's for 4
    steps, or part earlier only at a tie: where the plain path's logits
    of the two tokens lie within the plain path's own cached-decode
    error, a reading the kernels cannot move."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    model, init_s = _narrator_model(n)
    frames, _ = _inputs(2, gen, n["img"])
    text = torch.randint(0, 50257, (2, 8), generator=gen, device=DEVICE)
    text[:, 0] = n["bos"]
    L = 16
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            tokens = model.encode_image(frames)
            torch.cuda.synchronize()
            per_image = launch_counts()
            if dtype == torch.bfloat16 and _vit(n):
                check_flash_tc(f"narrator {n['name']} bf16 encode_image")
            elif dtype == torch.bfloat16:
                check_tensor_cores(f"narrator {n['name']} bf16 "
                                   "encode_image", n["space"], "K2")
            cached, per_step = _cached_logits(model, tokens, text, 8)
            # the full forward under inference: K7 at every attention
            reset_launch_counts()
            full_k = model.text_decoder(text, encoder_states=tokens)
            torch.cuda.synchronize()
            per_full = launch_counts()
            ids, ppl = _greedy(model, tokens, n, L)
            with plain_path():
                tokens_ref = model.encode_image(frames)
                full = model.text_decoder(text, encoder_states=tokens_ref)
                cached_ref, _ = _cached_logits(model, tokens_ref, text, 8)
                ids_ref, ppl_ref = _greedy(model, tokens_ref, n, L)
            partings = _partings(model, tokens_ref, ids, ids_ref)
        name = dname(dtype)
        res = {"logits_err": max_err(cached, full),
               "plain_cached_err": max_err(cached_ref, full),
               "full_k7_err": max_err(full_k, full),
               "full_k7_cos_min": _cos_min(full_k, full),
               "logits_cos_min": _cos_min(cached, full),
               "image_tokens_err": max_err(tokens, tokens_ref),
               "ids_equal": bool(torch.equal(ids, ids_ref)),
               "ids_agree_steps": int((ids == ids_ref).all(0).long()
                                      .cumprod(0).sum()) - 1,
               "ppl_rel_err": ((ppl - ppl_ref).abs() / ppl_ref).max().item(),
               "partings": partings,
               "finite": bool(torch.isfinite(cached).all()
                              and torch.isfinite(ppl).all())}
        emit("narrator", model=n["name"], dtype=name, clips=2,
             return_sequences=2, init_seconds=init_s,
             launches_per_encode_image=per_image,
             launches_per_decode_step=per_step,
             launches_per_full_forward=per_full, ids=ids.tolist(),
             ids_plain=ids_ref.tolist(), **res)
        check(res["finite"]
              and tokens.shape == (2, 256, n.get("text_width", 1600)),
              f"narrator {n['name']} {name}: non-finite or misshapen "
              "outputs")
        want_step = dict.fromkeys(COUNTERS, 0)
        want_step.update({"K9": n["layers"],
                          "K3": 2 * (n["layers"] + n["cross"]) + 1})
        check(per_step == want_step,
              f"narrator {n['name']} {name}: launches per decode step "
              f"{per_step}")
        want_full = dict.fromkeys(COUNTERS, 0)
        want_full.update({"K7": n["layers"] + n["cross"],
                          "K3": 2 * (n["layers"] + n["cross"]) + 1})
        check(per_full == want_full,
              f"narrator {n['name']} {name}: launches per full forward "
              f"{per_full}")
        # the pooler reads the joint sequence: the final norm and the
        # pooler's three bias-free norms are K3 too
        want_image = _encode_launches(n)
        want_image["K3"] += 3
        check(per_image == want_image,
              f"narrator {n['name']} {name}: launches per encode_image "
              f"{per_image}")
        if dtype == torch.float32:
            # 48 layers; the cached steps' (B, 1, D) products and the full
            # forward's (B, 8, D) ones sum in other orders
            check(res["logits_err"] <= 1e-3 and res["ids_equal"]
                  and res["ppl_rel_err"] <= 1e-4
                  and res["full_k7_err"] <= 1e-3,
                  f"narrator {n['name']} fp32 kernels vs plain: {res}")
        else:
            # a row parting at column s <= 4 agreed for fewer than 4 steps
            noise = res["plain_cached_err"]
            check(res["logits_cos_min"] >= 0.99
                  and res["full_k7_cos_min"] >= 0.99
                  and res["logits_err"] <= 1.25 * noise
                  and all(p["gap"] <= noise for p in partings
                          if p["step"] <= 4),
                  f"narrator {n['name']} bf16 kernels vs plain: {res}")
    if measure:
        _decode_profile(model, gen, n)
        _narration_throughput(model, gen, n)


def _timed_steps(model, cur, kv, cache, first: int, steps: int):
    """``steps`` decode steps at cache positions ``first``...: the host's
    issue time and the wall time to the last kernel's end, in ms/step."""
    t0 = time.perf_counter()
    for i in range(first, first + steps):
        model.decode_step(cur, kv, cache, i)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host / steps * 1e3, wall / steps * 1e3


def _decode_profile(model, gen, n, steps: int = 5) -> None:
    """Host time against device time over ``steps`` decode steps of the
    throughput shape (160 rows, bf16, cache positions 8..12): the steps
    timed as they run, then the same steps traced with torch.profiler for
    the device time by kernel and K9's share. The idle share is the
    device time over the untraced step."""
    from lavila_tpu_torch.models.gpt2 import init_cache
    frames, _ = _inputs(16, gen, n["img"])
    with torch.inference_mode():
        tokens = model.encode_image(frames).repeat_interleave(10, 0)
        kv = model.prepare_decode(tokens)
        cache = init_cache(model.text_decoder.cfg, tokens.shape[0], 77,
                           dtype=tokens.dtype, device=DEVICE)
        cur = torch.full((tokens.shape[0], 1), n["bos"], device=DEVICE)
        _timed_steps(model, cur, kv, cache, 0, 8)  # warm-up, fills 0..7
        # the traced run rewrites the same cache rows: the same work
        host, wall = _timed_steps(model, cur, kv, cache, 8, steps)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced_host, traced_wall = _timed_steps(model, cur, kv, cache, 8,
                                                    steps)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev / 1e3 / steps, ev.count // steps))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    k9_ms = sum(r[1] for r in rows if "decode_kernel" in r[0])
    emit("decode_profile", model=n["name"], dtype="bfloat16",
         rows=tokens.shape[0], steps=steps, host_issue_ms_per_step=host,
         wall_ms_per_step=wall, traced_host_issue_ms_per_step=traced_host,
         traced_wall_ms_per_step=traced_wall,
         device_ms_per_step=device_ms or "not measured",
         k9_ms_per_step=k9_ms, device_idle_share=(
             1 - device_ms / wall) if device_ms else None,
         top=[{"kernel": k[:90], "ms_per_step": t, "launches_per_step": c}
              for k, t, c in rows[:12]])


def _narration_throughput(model, gen, n, clips: int = 16, nrs: int = 10,
                          L: int = 77) -> None:
    """Narrations/s (clips × return sequences per second, encode and
    decode), bf16, kernel and plain path in alternating order, with the
    decode steps run (read from the ids, and held against K9's launches
    on the kernel path), ms per step and peak memory."""
    frames, _ = _inputs(clips, gen, n["img"])
    kw = dict(bos_id=n["bos"], eos_id=n["eos"], temperature=0.7,
              top_p=0.95, num_return_sequences=nrs)
    out = {}
    for path in ("kernels", "plain", "plain", "kernels"):
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        with plain_path() if path == "plain" else nullcontext(), \
                torch.inference_mode():
            model.generate(model.encode_image(frames[:2]), generator=g,
                           max_text_length=4, **kw)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            tokens = model.encode_image(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, ppl = model.generate(tokens, generator=g, max_text_length=L,
                                      **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        steps = _steps_run(ids, n["eos"], L)
        for k, v in (("narrations_per_s", clips * nrs / (t2 - t0)),
                     ("encode_ms", (t1 - t0) * 1e3),
                     ("decode_steps", steps),
                     ("ms_per_step", (t2 - t1) * 1e3 / steps),
                     ("peak_memory_gib",
                      torch.cuda.max_memory_allocated() / 2**30)):
            out.setdefault(k, {}).setdefault(path, []).append(v)
        check(bool(torch.isfinite(ppl).all()) and ids.shape[0] == clips * nrs,
              f"narration throughput {n['name']} {path}: bad outputs")
        k9 = launch_counts()["K9"]
        check(k9 == (steps * n["layers"] if path == "kernels" else 0),
              f"narration throughput {n['name']} {path}: {k9} K9 launches "
              f"for {steps} decode steps")
    emit("narrator_throughput", what="narrations/s", model=n["name"],
         dtype="bfloat16", clips=clips, return_sequences=nrs,
         max_text_length=L, temperature=0.7, top_p=0.95,
         order="kernels, plain, plain, kernels", **out)


def phase_infer_narrator_cli(n) -> dict:
    """The port's narrator inference CLI on one batch of the synthetic
    dataset (narrator ``n``, bf16, 16 clips x 10 captions). Returns the
    launch counts of this run, the decode path's."""
    import pickle
    import tempfile

    from lavila_tpu_torch.cli import main_infer_narrator as cli
    with tempfile.TemporaryDirectory() as out:
        args = cli.get_args_parser().parse_args(
            ["--dataset", "synthetic", "--model", n["name"], "--bf16",
             "--device", DEVICE, "--batch-size", "16", "--max-samples", "16",
             "--num-return-sequences", "10", "--workers", "4",
             "--output-dir", out])
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = path_counts()
        with open(os.path.join(out, "total.pkl"), "rb") as f:
            total = pickle.load(f)
        files = sorted(os.listdir(out))
    ok = (len(total) == 16 and all(
        r[0] == "synthetic" and len(r[3]) == len(r[4]) == 10
        and all(isinstance(c, str) for c in r[3])
        and all(math.isfinite(x) for x in r[4]) for r in total))
    first = ([*total[0][:3], total[0][3][:2], total[0][4][:2]] if total
             else None)
    emit("infer_narrator_cli", model=n["name"], dtype="bfloat16",
         clips=16, return_sequences=10, seconds=seconds, files=files,
         records=len(total), first_record=first, launches=counts)
    check(ok and {"cache.0.pkl", "total.pkl"} <= set(files),
          f"infer CLI {n['name']} wrote {files}, {len(total)} records")
    layers = n["layers"]
    steps = counts["K9"] // layers
    encode = _encode_launches(n)
    check(counts["K9"] > 0 and counts["K9"] % layers == 0 and steps <= 76
          and all(counts[k] == encode[k]
                  for k in ("K1", "K2", "K4", "K5", "K6", "K7"))
          and counts["K3"] >= steps * (2 * (layers + n["cross"]) + 1),
          f"infer CLI {n['name']} launches {counts}")
    return counts


@contextmanager
def gpt2_vocab():
    """A byte-level GPT-2 vocabulary (the 256 byte symbols, a few merges,
    ``<|endoftext|>``) under ``gpt2`` and ``gpt2-xl`` in a temporary
    directory named by ``LAVILA_TOKENIZER_DIR`` while the block runs; no
    GPT-2 BPE files are in the repo."""
    import tempfile

    from lavila_tpu_torch.data.tokenizers import byte_unicode_table
    vocab = {u: i for i, u in enumerate(byte_unicode_table().values())}
    merges = ["Ġ t", "Ġt h", "Ġth e", "h e", "l l", "he ll", "hell o"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with tempfile.TemporaryDirectory() as root:
        for sub in ("gpt2", "gpt2-xl"):
            os.makedirs(os.path.join(root, sub))
            with open(os.path.join(root, sub, "vocab.json"), "w") as f:
                json.dump(vocab, f)
            with open(os.path.join(root, sub, "merges.txt"), "w") as f:
                f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with mock.patch.dict(os.environ, {"LAVILA_TOKENIZER_DIR": root}):
            yield


# The caption step's comparison scales the pooler's to_q weight by 16:
# at the init's spread its scores are ~N(0, 1) over 1 + 4·196 context
# tokens, the 256 pooled image tokens come out near-copies of each other
# (mean cosine 0.9986), so every cross-attention's query gradient cancels
# (‖dS·K‖ ~4e-3 of ‖|dS|·|K|‖) and keeps the rounding of its inputs: in
# fp32, K8 and its plain version, which recompute P from the saved lse,
# land 1.4e-3 from fp64 and autograd through the plain forward 7e-5, past
# the 1e-4 limit apart (H100; PERF.md §6). At 16 the tokens' mean cosine
# is 0.69, the pooler's own gradients staying as well conditioned. The
# unscaled start is recorded beside it (:func:`_unscaled_reading`), each
# side's cross-attention gradients against an fp64 witness.
POOL_SPREAD = 16.0
# LaViLa's narrator recipe (docs/TRAINING.md:31-42): --gated-xattn
# --freeze-lm-vclm --freeze-visual-vclm (--disable-amp: fp32)
RECIPE = ("--gated-xattn", "--freeze-lm-vclm", "--freeze-visual-vclm",
          "--disable-amp")


def _caption_batch(B, gen, n):
    """``B`` clips and GPT-2 captions of 77 ids: BOS, 10 to 40 tokens,
    EOS, then padding (0)."""
    frames, _ = _inputs(B, gen, n["img"])
    lens = torch.randint(10, 40, (B,), generator=gen, device=DEVICE)
    body = torch.randint(1, 50256, (B, 77), generator=gen, device=DEVICE)
    text = torch.where(torch.arange(77, device=DEVICE)[None] < lens[:, None],
                       body, 0)
    text[:, 0] = n["bos"]
    text[torch.arange(B, device=DEVICE), lens] = n["eos"]
    return {"frames": frames, "text": text}


def _caption_state(base, dtype, remat: bool = False, shard: bool = False):
    """A TrainState of LaViLa's recipe over a copy of narrator ``base``
    (the CLI's AdamW, the LM and the video tower but its temporal branch
    frozen; remat on both towers with ``remat``; with ``shard`` its wide
    layers sharded over the model group) and the caption step."""
    import dataclasses

    from lavila_tpu_torch.parallel import sharding
    from lavila_tpu_torch.train.freeze import build_freeze_predicate
    from lavila_tpu_torch.train.step import make_caption_train_step
    model = copy.deepcopy(base).train()
    if shard:
        sharding.shard_model(model)
    model.visual.remat = remat
    model.text_decoder.cfg = dataclasses.replace(model.text_decoder.cfg,
                                                 remat=remat)
    frozen = build_freeze_predicate(freeze_lm_vclm=True,
                                    freeze_visual_vclm=True)
    return (_make_state(model, dtype, frozen=frozen),
            make_caption_train_step(pad_id=0))


def _caption_launches(n, dtype) -> dict:
    """Kernel launches of one caption step of narrator ``n`` under the
    recipe's freezing: the encode's (the pooler's three bias-free norms
    are K3 too); GPT-2's norms (ln_1, ln_2 a layer, ln_cross_attn and
    ln_2_crossattention a cross layer, ln_f) and its two attentions on K8
    (every attention's q, k or v takes a trainable projection); one
    backward each, except the CLS half of ``ln_pre``, whose rows and
    weights are all frozen. In bf16 the self-attention's backward is the
    fused kernel and the cross-attention's (256 keys) the split dq and
    dk/dv; in fp32 both are SIMT dq and dk/dv."""
    depth, layers, cross = n["depth"], n["layers"], n["cross"]
    gpt2_ln = 2 * (layers + cross) + 1
    want = _encode_launches(n)
    want["K3"] += 3 + gpt2_ln
    want.update({f"{n['space']} bwd": depth, "K2 bwd": depth,
                 "K4 bwd": depth, "K5 bwd": depth,
                 "K3 bwd": want["K3"] - 1, "K8 fwd": layers + cross,
                 "CLS row bwd": 2 * depth})
    if dtype == torch.bfloat16:
        want.update({"K8 bwd": layers, "K8 dq": cross, "K8 dkv": cross})
    else:
        want.update({"K8 dq": layers + cross, "K8 dkv": layers + cross})
    return want


def _caption_steps(n, base, dtype, batch, plain: bool, steps: int = 2,
                   remat: bool = False):
    """``steps`` caption steps of the recipe from a copy of ``base``: the
    losses, each step's fp32 gradients (the trainable parameters') and
    launch counts; on the kernels each step's branches are checked (bf16:
    the tensor cores only; the LayerNorm backward's one-block branch for
    the video tower's CLS rows exactly), and after the steps every frozen
    parameter is bit-equal to ``base``'s, without a gradient."""
    from lavila_tpu_torch.kernels import layernorm as KL
    state, step_fn = _caption_state(base, dtype, remat)
    B = batch["frames"].shape[0]
    plan = KL.bwd_shape(n["width"], torch.empty((), dtype=dtype)
                        .element_size(), 2)
    cls_block = 3 * n["depth"] if B <= plan.warps * plan.slots else 0
    losses, grads, counts = [], [], []
    what = f"caption step {n['name']} {dname(dtype)} remat {remat}"
    with plain_path() if plain else nullcontext():
        for _ in range(steps):
            reset_launch_counts()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            counts.append(launch_counts())
            if not plain:
                check_ln_bwd(what)
                check(KL.launches["ln_bwd_block"] == cls_block,
                      f"{what}: {KL.launches['ln_bwd_block']} one-block "
                      f"LayerNorm backward launches, want {cls_block}")
                if dtype == torch.bfloat16:
                    check_flash_tc(what)
                    check_tensor_cores(what, n["space"], "K2",
                                       f"{n['space']} bwd", "K2 bwd")
            losses.append(metrics["loss"].item())
            grads.append({k: p.grad.clone() for k, p in state.params.items()
                          if p.grad is not None})
    ref = dict(base.named_parameters())
    work = dict(state.model.named_parameters())
    still = all(torch.equal(state.params[k], ref[k])
                and state.params[k].grad is None and work[k].grad is None
                for k in state.frozen)
    check(still and len(state.frozen) > 0
          and set(grads[-1]) == set(state.params) - state.frozen,
          f"{what}: frozen parameters moved or have a gradient, or a "
          "trainable one has none")
    frozen = sum(state.params[k].numel() for k in state.frozen)
    del state
    return losses, grads, counts, frozen


@contextmanager
def _record_cross(calls: list):
    """While the block runs, every differentiated cross-attention call of
    GPT-2 (non-causal ``flash_attention``) appends ``[q, k, v, dO]`` to
    ``calls``, copies of its inputs and, once backward reaches it, of its
    output's gradient."""
    from lavila_tpu_torch.models import gpt2
    real = gpt2.flash_attention

    def record(q, k, v, causal=False, scale=None):
        out = real(q, k, v, causal=causal, scale=scale)
        if not causal and out.requires_grad:
            entry = [t.detach().clone() for t in (q, k, v)]
            calls.append(entry)
            out.register_hook(lambda g: entry.append(g.detach().clone()))
        return out

    with mock.patch.object(gpt2, "flash_attention", record):
        yield


def _attention_grads(fn, q, k, v, do):
    """(dq, dk, dv) of ``fn(q, k, v)`` (non-causal) by autograd."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*ins), ins, do)


def _attention_fp64(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _pallas_delta_grads(q, k, v, do):
    """dq and dk of a non-causal attention with the Pallas kernels'
    delta, rowsum(dO·O) from the output rounded to the compute dtype,
    which K8 does not take (``csrc/flash_attention.cu``'s header says
    why); otherwise ``flash_bwd_reference``'s numerics."""
    from lavila_tpu_torch.kernels import flash as KF
    out, lse = KF.flash_fwd_reference(q, k, v)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq * scale, torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale


def _cross_witness(calls) -> dict:
    """Each recorded cross-attention's dq and dk from K8 (its kernels'
    backward through ``flash_attention``), from K8's plain version
    (``flash_bwd_reference``), from autograd through the plain forward in
    the compute dtype (``flash_attention_reference``, what the plain path
    differentiates) and with the Pallas kernels' delta
    (:func:`_pallas_delta_grads`), each as its L2 error relative to an
    fp64 witness on the same inputs; the largest and the median over the
    calls, and the median cancellation of dq in fp64, ‖dS·K‖ /
    ‖|dS|·|K|‖."""
    from lavila_tpu_torch.kernels import flash as KF
    errs = {"k8": [], "plain_version": [], "autograd": [],
            "pallas_delta": []}
    cancel = []
    for q, k, v, do in calls:
        truth = _attention_grads(_attention_fp64, q.double(), k.double(),
                                 v.double(), do.double())
        sides = {"k8": _attention_grads(KF.flash_attention, q, k, v, do),
                 "plain_version": KF.flash_bwd_reference(
                     q, k, v, do, KF.flash_fwd_reference(q, k, v)[1]),
                 "autograd": _attention_grads(KF.flash_attention_reference,
                                              q, k, v, do),
                 "pallas_delta": _pallas_delta_grads(q, k, v, do)}
        for side, got in sides.items():
            errs[side].append([((a.double() - t).norm() / t.norm()).item()
                               for a, t in zip(got[:2], truth[:2])])
        k64 = k.double()
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.double(), k64)
                          * q.shape[-1] ** -0.5, -1)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        terms = torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k64.abs())
        cancel.append((torch.einsum("bhqk,bkhd->bqhd", ds, k64).norm()
                       / terms.norm()).item())
    out = {"calls": len(calls), "dq_cancellation_median": sorted(cancel)[
        len(cancel) // 2] if cancel else None}
    for side, rows in errs.items():
        for i, g in enumerate(("dq", "dk")):
            col = sorted(r[i] for r in rows)
            out[f"{side}_{g}_rel_err_max"] = col[-1]
            out[f"{side}_{g}_rel_err_median"] = col[len(col) // 2]
    return out


def _unscaled_reading(n, base, dtype, batch) -> dict:
    """The caption step at the recipe's own starting weights (no
    :data:`POOL_SPREAD`), recorded: one step, kernels against plain, and
    :func:`_cross_witness` over the cross-attentions that the kernels'
    step ran. Held only to K8's errors against fp64 staying within 1.25×
    of its plain version's on the same inputs, plus the dtype's epsilon
    (the kernels round dS to bf16 before dSᵀ·Q, the plain version does
    not)."""
    calls = []
    with _record_cross(calls):
        k_run = _caption_steps(n, base, dtype, batch, False, steps=1)
    p_run = _caption_steps(n, base, dtype, batch, True, steps=1)
    res = _compare_steps(k_run[:3], p_run[:3])
    del k_run, p_run
    torch.cuda.empty_cache()
    check(all(len(c) == 4 for c in calls) and len(calls) == n["cross"],
          f"unscaled caption step {dname(dtype)}: {len(calls)} recorded "
          f"cross-attentions, want {n['cross']} with their gradients")
    witness = _cross_witness(calls)
    check(all(math.isfinite(x) for x in witness.values()
              if isinstance(x, float))
          and all(witness[k] <= 1.25 * witness[k.replace(
              "k8", "plain_version", 1)] + torch.finfo(dtype).eps
              for k in witness if k.startswith("k8_")),
          f"unscaled caption step {dname(dtype)}: K8 against fp64 beyond "
          f"its plain version's: {witness}")
    return {"step": res, "cross_attention_vs_fp64": witness}


def phase_narrator_train_step(n) -> None:
    """LaViLa's narrator recipe on ``n`` at full width and depth (gates
    and time attention seeded non-zero): 2 AdamW caption steps kernels
    against plain from the same weights and batch, fp32 at batch 2 and
    bf16 at batch 4, every trainable gradient compared, frozen ones
    unmoved; remat on against off (fp32, kernels); launches per step
    against :func:`_caption_launches`; bf16 clips/s and peak memory at
    batch 16 in turns, and the step's busy time and idle share. The
    comparison runs at :data:`POOL_SPREAD`; the recipe's own start is
    recorded first (:func:`_unscaled_reading`)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    base, _ = _narrator_model(n)
    base.train()
    batches = {dtype: _caption_batch(size, gen, n)
               for dtype, size in ((torch.float32, 2), (torch.bfloat16, 4))}
    for dtype, batch in batches.items():
        emit("narrator_train_step_unscaled", model=n["name"],
             dtype=dname(dtype), batch=batch["frames"].shape[0], steps=1,
             **_unscaled_reading(n, base, dtype, batch))
    with torch.no_grad():
        base.img_attn_pool.to_q.weight.mul_(POOL_SPREAD)
    for dtype, batch in batches.items():
        size = batch["frames"].shape[0]
        k_run = _caption_steps(n, base, dtype, batch, False)
        p_run = _caption_steps(n, base, dtype, batch, True)
        res = _compare_steps(k_run[:3], p_run[:3])
        name = f"caption step {n['name']} {dname(dtype)}"
        want = _caption_launches(n, dtype)
        extra = {}
        if dtype == torch.float32:
            r_run = _caption_steps(n, base, dtype, batch, False, remat=True)
            extra = {"remat_vs_no_remat": _compare_steps(r_run[:3],
                                                         k_run[:3]),
                     "loss_remat": r_run[0]}
            check(extra["remat_vs_no_remat"]["loss_rel_err"] <= 1e-5
                  and extra["remat_vs_no_remat"]["grad_rel_err_max"]
                  <= 1e-4, f"{name}: remat against none {extra}")
            del r_run
        emit("narrator_train_step", model=n["name"], dtype=dname(dtype),
             batch=size, steps=2, recipe=list(RECIPE[:3]),
             frozen_parameters=k_run[3], loss_kernels=k_run[0],
             loss_plain=p_run[0], launches_per_step=k_run[2],
             launches_want=want, **res, **extra)
        check(all(math.isfinite(x) for x in k_run[0] + p_run[0]),
              f"{name}: non-finite loss {k_run[0]} {p_run[0]}")
        check(all(c == want for c in k_run[2]),
              f"{name}: launches {k_run[2]}, want {want}")
        if dtype == torch.float32:
            check(res["loss_rel_err"] <= 1e-5
                  and res["grad_rel_err_max"] <= 1e-4,
                  f"{name} kernels vs plain: {res}")
        else:
            check(res["loss_rel_err"] <= 1e-2 and res["grad_cos_min"] >= 0.99,
                  f"{name} kernels vs plain: {res}")
        del k_run, p_run
        torch.cuda.empty_cache()
    state, step_fn = _caption_state(base, torch.bfloat16)
    del base
    torch.cuda.empty_cache()
    data = _caption_batch(16, gen, n)
    rates, peaks = _in_turns(state, step_fn, data, 5)
    emit("train_throughput", what="caption train step clips/s",
         model=n["name"], dtype="bfloat16", batch=16, frames=4, iters=5,
         remat=False, recipe=list(RECIPE[:3]),
         order="kernels, plain, plain, kernels", clips_per_s=rates,
         peak_memory_gib=peaks)
    emit("train_profile", model=n["name"], dtype="bfloat16", batch=16,
         kind="caption", **_profile(lambda: step_fn(state, data), iters=3))
    del state, data


def phase_vclm_pretrain_cli(n, steps: int = 2, batch: int = 8) -> dict:
    """The port's pretraining CLI with narrator ``n`` and LaViLa's recipe
    (fp32) plus ``--use-checkpoint`` for ``steps`` steps on the synthetic
    dataset, the fixture GPT-2 vocabulary: a finite loss, the gates
    moved, every frozen tensor bit-equal in the checkpoint to the init;
    then the port's ``main_infer_narrator`` loads that checkpoint (bf16)
    and narrates one batch. Returns the launch counts of both runs; their
    K1-K8 launches by branch go to RECIPE_BRANCHES."""
    import pickle
    import tempfile

    from lavila_tpu_torch.cli import main_infer_narrator as infer
    from lavila_tpu_torch.cli import main_pretrain as cli
    from lavila_tpu_torch.config import parse_config
    init = {}
    create = cli.TrainState.create

    def spy(model, *args, **kw):  # the weights the CLI starts from, on
        # the host, so that the device's peak is the run's own
        init.update({k: p.detach().cpu()
                     for k, p in model.named_parameters()})
        return create(model, *args, **kw)

    with tempfile.TemporaryDirectory() as out, gpt2_vocab(), \
            mock.patch.object(cli.TrainState, "create", spy):
        cfg = parse_config(cli.TorchPretrainConfig, [
            "--dataset", "synthetic", "--model", n["name"], *RECIPE,
            "--use-checkpoint", "--steps", str(steps), "--batch-size",
            str(batch), "--workers", "4", "--print-freq", "1", "--device",
            DEVICE, "--output-dir", out])
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = cli.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = path_counts(RECIPE_BRANCHES)
        frozen = set(state.frozen)
        del state
        torch.cuda.empty_cache()
        with open(os.path.join(out, "log.txt")) as f:
            log = json.loads(f.readlines()[-1])
        ckpt_path = os.path.join(out, "checkpoint_latest.pt")
        ckpt_gib = os.path.getsize(ckpt_path) / 2**30
        saved = torch.load(ckpt_path, map_location="cpu", weights_only=True,
                           mmap=True)["state_dict"]
        unmoved = all(torch.equal(saved[k], init[k]) for k in frozen)
        gates = [k for k in saved if k.endswith(("alpha_cattn",
                                                 "alpha_dense"))]
        moved = all(not torch.equal(saved[k], init[k]) for k in gates)
        del saved, init
        args = infer.get_args_parser().parse_args(
            ["--dataset", "synthetic", "--model", n["name"], "--bf16",
             "--device", DEVICE, "--checkpoint", ckpt_path,
             "--batch-size", "4", "--max-samples", "4",
             "--num-return-sequences", "2", "--max-text-length", "20",
             "--workers", "4", "--output-dir", os.path.join(out, "narr")])
        reset_launch_counts()
        t1 = time.perf_counter()
        records = infer.main(args)
        torch.cuda.synchronize()
        narrate_seconds = time.perf_counter() - t1
        narrate = path_counts(RECIPE_BRANCHES)
    ok = len(records) == 4 and all(
        len(r[3]) == len(r[4]) == 2 and all(math.isfinite(x) for x in r[4])
        for r in records)
    layers = n["layers"] + n["cross"]
    emit("vclm_pretrain_cli", model=n["name"], dtype="float32",
         batch=batch, steps=steps, flags=[*RECIPE, "--use-checkpoint"],
         seconds=seconds, peak_memory_gib=peak, checkpoint_gib=ckpt_gib,
         train_loss=log["train_loss"], train_ppl=log.get("train_ppl"),
         frozen_tensors=len(frozen), frozen_unmoved=unmoved,
         gates=len(gates), gates_moved=moved, launches=counts,
         narrate_seconds=narrate_seconds, narrate_launches=narrate,
         first_record=[*records[0][:3], records[0][3], records[0][4]]
         if records else None)
    check(math.isfinite(log["train_loss"]) and unmoved and moved
          and len(frozen) > 0 and len(gates) == 2 * n["cross"],
          f"VCLM pretrain CLI {n['name']}: loss {log['train_loss']}, "
          f"frozen unmoved {unmoved}, {len(gates)} gates moved {moved}")
    # remat: every attention's forward twice a step
    check(counts["K8 fwd"] == steps * 2 * layers
          and counts["K8 dq"] == counts["K8 dkv"] == steps * layers
          and counts["K8 bwd"] == 0
          and all(counts[k] > 0 for k in (n["space"], f"{n['space']} bwd",
                                           "K2", "K2 bwd", "K3", "K3 bwd",
                                           "K4 bwd", "K5 bwd")),
          f"VCLM pretrain CLI {n['name']}: launches {counts}")
    check(ok and narrate["K9"] > 0 and narrate["K9"] % n["layers"] == 0,
          f"narration from the VCLM checkpoint: {len(records)} records, "
          f"launches {narrate}")
    return {k: counts[k] + narrate[k] for k in counts}


def phase_eval_narrator_cli(n) -> dict:
    """The port's ``eval_narrator`` on narrator ``n`` (bf16, seeded
    random weights, the fixture GPT-2 vocabulary) over 8 synthetic clips
    with each ``--decoding``: finite teacher-forced perplexities, the NLG
    scores present, the launches of every decode step (K9 a layer, K3 on
    GPT-2's norms) counted against ``decode_step``'s calls; then, fp32,
    ``beam_search`` with one beam against the greedy decode token for
    token. Returns the launch counts of the four runs."""
    from lavila_tpu_torch.cli import eval_narrator as ev
    from lavila_tpu_torch.models.beam import BeamDecoder
    from lavila_tpu_torch.models.narrator import VCLM
    total = dict.fromkeys(COUNTERS, 0)
    step_k3 = 2 * (n["layers"] + n["cross"]) + 1
    runs = (("sample", ()), ("beam", ("--num-beams", "3")),
            ("beam_sample", ("--num-beams", "3")),
            ("group_beam", ("--num-beams", "6", "--num-beam-groups", "3")))
    calls = [0]
    decode_step = VCLM.decode_step

    def counted(self, *args, **kw):
        calls[0] += 1
        return decode_step(self, *args, **kw)

    with gpt2_vocab(), mock.patch.object(VCLM, "decode_step", counted):
        for decoding, flags in runs:
            args = ev.get_args_parser().parse_args(
                ["--dataset", "synthetic", "--model", n["name"], "--bf16",
                 "--device", DEVICE, "--batch-size", "8", "--max-samples",
                 "8", "--eval-freq", "1", "--workers", "4", "--decoding",
                 decoding, *flags])
            reset_launch_counts()
            calls[0] = 0
            t0 = time.perf_counter()
            out = ev.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = path_counts()
            for k, v in counts.items():
                total[k] += v
            want = _encode_launches(n)
            want["K3"] += 3 + calls[0] * step_k3
            want["K9"] = calls[0] * n["layers"]
            emit("eval_narrator_cli", model=n["name"], dtype="bfloat16",
                 clips=8, decoding=decoding, flags=list(flags),
                 seconds=seconds, decode_steps=calls[0],
                 k9_per_step=counts["K9"] / max(calls[0], 1),
                 launches=counts, **out)
            check(math.isfinite(out["teacher_ppl"])
                  and {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= out.keys(),
                  f"eval_narrator {decoding}: {out}")
            # the teacher-forced pass runs all 76 steps, the decode <= 76
            check(counts == want and 76 < calls[0] <= 152,
                  f"eval_narrator {decoding}: launches {counts} for "
                  f"{calls[0]} decode steps, want {want}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    model, _ = _narrator_model(n)
    frames, _ = _inputs(2, gen, n["img"])
    L = 16
    with torch.inference_mode():
        tokens = model.encode_image(frames)
        beam, _ = BeamDecoder(model, n["bos"], n["eos"],
                              max_text_length=L).beam_search(tokens,
                                                             num_beams=1)
        greedy, _ = model.generate(tokens, generator=None, bos_id=n["bos"],
                                   eos_id=n["eos"], max_text_length=L,
                                   top_k=1)
    greedy = greedy.cpu().numpy()
    same = all((row[:e] == g[:e]).all() for row, g in zip(beam, greedy)
               for hit in [(g[1:] == n["eos"]).nonzero()[0]]
               for e in [hit[0] + 2 if hit.size else L])
    emit("eval_narrator_cli", model=n["name"], dtype="float32",
         what="beam_search, one beam, against greedy", clips=2,
         max_text_length=L, equal=same, beam=beam.tolist(),
         greedy=greedy.tolist())
    check(same, "beam_search with one beam differs from the greedy decode")
    del model
    return total


# ---- the single-device leftovers: the time gate, the remat policies,
# the OpenAI-CLIP init, ModifiedResNet

# TSF-B with the tanh gate on its time attention, served and trained at
# batch 8
GATED = dict(MODEL, kw={"timesformer_gated_xattn": True}, batch=8,
             serve_batch=8)
GATED_CUT = _cut(GATED, depth=4)
# the remat policies, and the forward launches of the divided phases a
# policy's step makes per block: twice where the recompute runs them
# again (full, dots), once where it keeps their outputs
POLICY_PHASE_RUNS = {"full": 2, "dots": 2, "save_attn": 1, "dots_attn": 1}
# RN50 (JAX lavila_tpu/models/resnet_clip.py defaults): 224², encoded at
# batch 8
RESNET = {"name": "ModifiedResNet RN50", "img": 224, "batch": 8,
          "output": 1024}


def phase_gated_timesformer(m=GATED) -> dict:
    """TSF-B with ``timesformer_gated_xattn``, its gates and time
    attention seeded: embeddings kernels vs plain at batch 8 (fp32 ≤
    1e-3, bf16 cosine ≥ 0.999) and clips/s; two bf16 train steps kernels
    vs plain at batch 8; the gate's gradient nonzero, its parameter fp32
    in the bf16 working copy; then ``main_pretrain
    --timesformer-gated-xattn`` for 2 steps, whose launches it returns."""
    phase_model(m)
    phase_train_step(m, {torch.bfloat16: 8}, (), "gated_train_step",
                     SEED + 21)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    state, step_fn = _state_and_step("clip", _clip_model(m).train(),
                                     torch.bfloat16)
    state, metrics = step_fn(state, _train_batch(8, gen))
    names = [f"visual.blocks.{i}.alpha_timeattn"
             for i in range(m["depth"])]
    work = dict(state.model.named_parameters())
    grads = [state.params[n].grad for n in names]
    emit("gated_timesformer", model=m["name"], dtype="bfloat16",
         batch=8, loss=metrics["loss"].item(),
         gate_dtype_working_copy=str(work[names[0]].dtype),
         gate_grads=[g.item() for g in grads])
    check(all(work[n].dtype == torch.float32 for n in names)
          and all(g is not None and g.dtype == torch.float32
                  and torch.isfinite(g) and g.item() != 0.0 for g in grads),
          f"gated TSF-B: the gates' working-copy dtypes or gradients "
          f"{[None if g is None else g.item() for g in grads]}")
    del state
    return phase_pretrain_cli(MODEL, 2, 8, ("--timesformer-gated-xattn",))


def phase_remat_policies(m=LARGE) -> dict:
    """TSF-L@336's bf16 train step at batch 32 under each remat policy:
    from the same weights and batch, one step's gradients against
    ``full``'s (their largest difference, within the bf16 train-step
    limits), its launches (K6 and K2 forward once a block where the
    policy keeps the phases' outputs, twice where the recompute runs
    them), then step ms by CUDA events over 1 step (after 3 warm-up
    steps), the profiler's busy time and idle share over 1 traced step,
    and the first step's peak memory. A policy that does not fit at
    batch 32 runs at 16, and its line says so. Returns
    the launches of the four gradient steps."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    base = _clip_model(m).cpu()  # each policy's copy goes to the card
    data = {b: _train_batch(b, gen, m["img"]) for b in (32, 16)}
    counts = dict.fromkeys(COUNTERS, 0)
    ref = None
    for policy in POLICY_PHASE_RUNS:
        for batch in (32, 16):
            model = copy.deepcopy(base).to(DEVICE)
            model.visual.remat, model.visual.remat_policy = True, policy
            state, step_fn = _state_and_step("clip", model.train(),
                                             torch.bfloat16)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            try:
                state, metrics = step_fn(state, data[batch])
                torch.cuda.synchronize()
                fits = True
            except torch.cuda.OutOfMemoryError:
                fits = False
            if fits:
                peak = torch.cuda.max_memory_allocated() / 2**30
                break
            emit("remat_policies", policy=policy, batch=batch,
                 out_of_memory=True)
            del state, model
        else:
            check(False, f"remat policy {policy}: out of memory at 16")
            continue
        step = path_counts()
        for k, n in step.items():
            counts[k] += n
        want = _step_launches(m, remat=True)
        want["K6"] = want["K2"] = POLICY_PHASE_RUNS[policy] * m["depth"]
        check_tensor_cores(f"TSF-L@336 bf16 step, remat {policy}", "K6",
                           "K6 bwd", "K2", "K2 bwd")
        check(step == want, f"remat {policy}: launches {step}, want {want}")
        grads = {k: p.grad.float() for k, p in state.params.items()
                 if p.grad is not None}
        loss = metrics["loss"].item()
        if policy == "full":
            ref = (batch, loss, grads)
            diff = {"loss_rel_err": 0.0, "grad_max_abs_diff": 0.0,
                    "grad_cos_min": 1.0}
        elif ref is not None and ref[0] == batch:
            diff = {"loss_rel_err": abs(loss - ref[1]) / abs(ref[1]),
                    "grad_max_abs_diff": max(
                        max_err(g, ref[2][k]) for k, g in grads.items()),
                    "grad_cos_min": min(
                        torch.nn.functional.cosine_similarity(
                            g.flatten(), ref[2][k].flatten(), dim=0).item()
                        for k, g in grads.items() if g.dim() >= 2)}
            check(diff["loss_rel_err"] <= 1e-2
                  and diff["grad_cos_min"] >= 0.99,
                  f"remat {policy} against full: {diff}")
        else:
            diff = {"against_full": "not compared: another batch"}
        del grads
        # 3 warm-up steps, 1 timed by CUDA events (step ms), 1 traced:
        # the trace of a step's ~9,000 launches is most of the phase's time
        prof = _profile(lambda: step_fn(state, data[batch]), iters=1)
        emit("remat_policies", model=m["name"], dtype="bfloat16",
             policy=policy, batch=batch, step_ms=prof["ms_per_call"],
             clips_per_s=batch * 1e3 / prof["ms_per_call"],
             peak_memory_gib=peak, launches_per_step={
                 k: step[k] for k in ("K6", "K2", "K6 bwd", "K2 bwd")},
             **diff, **{k: prof[k] for k in (
                 "device_busy_ms_per_call", "idle_share",
                 "launches_per_call")})
        del state, model
        torch.cuda.empty_cache()
    return counts


def _openai_vit_b16(gen) -> dict:
    """A state dict in OpenAI's ViT-B/16 layout at its published widths,
    seeded: the port's ``CLIP_OPENAI_VITB16`` (which keeps OpenAI's
    names) drawn from ``gen``, with the three metadata entries of
    OpenAI's archives beside it."""
    from lavila_tpu_torch.models import build_model
    sd = build_model("CLIP_OPENAI_VITB16", device=DEVICE,
                     generator=gen).state_dict()
    sd = {k: v.cpu() for k, v in sd.items()}
    sd.update(input_resolution=torch.tensor(224),
              context_length=torch.tensor(77), vocab_size=torch.tensor(49408))
    return sd


def phase_openai_init() -> dict:
    """A synthetic OpenAI ViT-B/16 checkpoint saved into a temporary
    ``LAVILA_CLIP_CACHE`` through the download path (``MODELS`` pointed
    at a ``file://`` URL whose sha component is its digest), then
    ``load_into_timesformer_dual_encoder`` into TSF-B: the visual weights
    remapped, the text tower copied, the time attention left at its zero
    init. With the time attention then seeded, TSF-B serves at batch 8
    kernels vs plain (fp32 ≤ 1e-3, bf16 cosine ≥ 0.999) with clips/s.
    Returns the launches of one bf16 encode_image at batch 8."""
    import hashlib
    import tempfile

    from lavila_tpu_torch.models import build_model
    from lavila_tpu_torch.models import openai_weights as OW
    from lavila_tpu_torch.models.convert import count_layers
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    sd = _openai_vit_b16(gen)
    with tempfile.TemporaryDirectory() as root:
        src = os.path.join(root, "src.pt")
        torch.save(sd, src)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        os.makedirs(os.path.join(root, digest))
        os.replace(src, os.path.join(root, digest, "ViT-B-16.pt"))
        url = f"file://{root}/{digest}/ViT-B-16.pt"
        with mock.patch.dict(OW.MODELS, {"ViT-B/16": url}), \
                mock.patch.object(OW, "CACHE_DIR",
                                  os.path.join(root, "cache")):
            model = build_model(MODEL["name"], device=DEVICE, generator=gen)
            OW.load_into_timesformer_dual_encoder("ViT-B/16", model,
                                                  layers=12, text_layers=12)
            cached = os.path.exists(os.path.join(root, "cache",
                                                 "ViT-B-16.pt"))
    got = model.state_dict()
    # the last video block and the last text block, 11 each
    i = len(model.visual.blocks) - 1
    j = count_layers(got, "transformer.resblocks.") - 1
    blk = model.visual.blocks[i]
    copied = {
        "qkv": torch.equal(got[f"visual.blocks.{i}.attn.qkv.weight"].cpu(),
                           sd[f"visual.transformer.resblocks.{i}.attn."
                              "in_proj_weight"]),
        "norm2": torch.equal(got[f"visual.blocks.{i}.norm2.bias"].cpu(),
                             sd[f"visual.transformer.resblocks.{i}.ln_2."
                                "bias"]),
        "pos_embed": torch.equal(got["visual.pos_embed"][0].cpu(),
                                 sd["visual.positional_embedding"]),
        "text": torch.equal(got[f"transformer.resblocks.{j}.mlp.c_fc."
                                "weight"].cpu(),
                            sd[f"transformer.resblocks.{j}.mlp.c_fc."
                               "weight"]),
        "time_attention_zero": bool(
            (blk.timeattn.qkv.weight == 0).all()
            and (blk.timeattn.proj.weight == 1).all())}
    emit("openai_init", model=MODEL["name"],
         checkpoint="ViT-B/16 (synthetic, OpenAI's layout)",
         downloaded_into_cache=cached, **copied)
    check(cached and all(copied.values()),
          f"OpenAI init of TSF-B: cached {cached}, copied {copied}")
    _seed_time_attention(model.visual, gen)
    phase_model(dict(MODEL, batch=8, serve_batch=8), model)
    frames, _ = _inputs(8, gen)
    with torch.inference_mode():
        reset_launch_counts()
        model.encode_image(frames)
        torch.cuda.synchronize()
    return path_counts()


def _resnet(gen):
    """RN50 on the card from ``gen``: the JAX initialisers, then its
    norms' scales, shifts and running statistics seeded away from 1, 0,
    0, 1."""
    from lavila_tpu_torch.models.resnet_clip import BatchNorm, ModifiedResNet
    with torch.device(DEVICE):
        model = ModifiedResNet()
    model.init_weights(gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                bn.weight.uniform_(0.8, 1.2, generator=gen)
                bn.bias.normal_(0.0, 0.1, generator=gen)
                bn.running_mean.normal_(0.0, 0.1, generator=gen)
                bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


def phase_resnet() -> dict:
    """RN50 (``models/resnet_clip.py``) at 224² with seeded weights and
    running statistics: images encoded at batch 8 on the kernel path
    against the plain path (fp32 ≤ 1e-3, bf16 cosine ≥ 0.999 on the
    normalised features), the attention pool's K7 launch counted, then
    images/s kernels/plain/plain/kernels in bf16. Returns the launches
    of one bf16 encode."""
    from lavila_tpu_torch.models.dual_encoder import l2_normalize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    model = _resnet(gen)
    B = RESNET["batch"]
    size = RESNET["img"]
    images = torch.randn(B, size, size, 3, generator=gen, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            got = model(images)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                counts = path_counts()
                check_flash_tc("RN50 bf16 attention pool")
            else:
                counts = launch_counts()
            with plain_path():
                ref = model(images)
        a, b = l2_normalize(got.float()), l2_normalize(ref.float())
        res = {"max_err": max_err(a, b),
               "cos_min": (a * b).sum(-1).min().item(),
               "finite": bool(torch.isfinite(got).all()),
               "shape": list(got.shape)}
        emit("resnet", model=RESNET["name"], dtype=dname(dtype), batch=B,
             launches_per_encode=counts, **res)
        check(res["finite"] and res["shape"] == [B, RESNET["output"]]
              and counts == {**dict.fromkeys(COUNTERS, 0), "K7": 1},
              f"RN50 {dtype}: {res}, launches {counts}")
        check(res["max_err"] <= 1e-3 if dtype == torch.float32
              else res["cos_min"] >= 0.999,
              f"RN50 {dtype} kernels vs plain: {res}")
    rates = {}
    with torch.inference_mode():
        for run in ("kernels", "plain", "plain", "kernels"):
            with plain_path() if run == "plain" else nullcontext():
                for _ in range(2):
                    model(images)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    model(images)
                torch.cuda.synchronize()
            rates.setdefault(run, []).append(
                B * 10 / (time.perf_counter() - t0))
    emit("throughput", what="images/s", model=RESNET["name"],
         dtype="bfloat16", batch=B, iters=10,
         order="kernels, plain, plain, kernels", images_per_s=rates)
    return counts


# ------------------------------------------------- data parallelism

# the card's machine shows one H100: two ranks share it through gloo
# (which stages CUDA tensors through host memory; NCCL refuses two ranks
# on one device), and NCCL runs at a world of one
DDP_TIMEOUT = 300  # seconds for a phase's processes, start-up included
# the two-rank variants: the global CLIP loss, --contrastive-use-vissl
# (the local CLIP loss) and the local SSL loss
DDP_VARIANTS = {"clip": {}, "vissl": {"local_loss": True},
                "ssl_local": {"local_loss": True, "use_ssl": True}}
# the SSL variant's pseudo temperature, 0.05: at the CLI's 0.07, that of
# logit_scale, the two-temperature loss is the CLIP loss, and AdamW's
# first update moves both scales by the same lr
DDP_PSEUDO_INIT = math.log(1 / 0.05)
# the largest |r - 1| of r, the averaged gradients' global norm over one
# process's: in bf16 the ranks' gradients read a cosine of at least
# 0.9991 and a leaf's largest error within 7.2% of its largest value
# against one process's (H100); a factor of the world either way is 0.5
DDP_NORM_RATIO = 0.1
# the ranks' steps run TSF-B cut to 4 of its 12 blocks (PERF.md §4)
DDP_MODEL = MODEL_CUT


def _smi() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def _child_setup() -> None:
    """A child process of a data-parallel phase: the port importable,
    TF32 off as in this process (:func:`phase_device`), the kernel
    library this process built loaded."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lavila_tpu_torch.kernels import build
    build.library()


def _child_result(path: str, result: dict) -> None:
    """A child's result and its failed checks, as JSON at ``path``."""
    with open(path, "w") as f:
        json.dump({**result, "failures": FAILURES}, f)


def _spawn(calls: list, tmp: str, meanwhile=None) -> list:
    """Each ``(function name, args)`` of this module in a process of its
    own, all at once, ``meanwhile()`` (when given) run here while they
    run; their results (:func:`_child_result`) once every one ended. A
    process that fails or outlives :data:`DDP_TIMEOUT` fails the phase,
    every process killed."""
    procs, logs = [], []
    for i, (fn, args) in enumerate(calls):
        logs.append(open(os.path.join(tmp, f"child_{i}.log"), "w+"))
        code = (f"import sys; sys.path.insert(0, {REPO!r}); "
                f"import chip_smoke; chip_smoke.{fn}(*{args!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      stdout=logs[-1],
                                      stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + DDP_TIMEOUT
    try:
        if meanwhile is not None:
            meanwhile()
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for i, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr, flush=True)
            raise RuntimeError(f"{calls[i][0]} {calls[i][1]} exited "
                               f"{p.returncode}")
        with open(calls[i][1][-1]) as f:
            results.append(json.load(f))
    for res in results:
        for failure in res["failures"]:
            check(False, failure)
    return results


def _merge_path_counts(res: dict) -> dict:
    """A child's path run (:func:`path_counts` there) into this
    process's launches by branch; returns its launch counts."""
    for name, by in res["by_branch"].items():
        for b, n in by.items():
            PATH_BRANCHES[name][b] += n
    for b, n in res["ln_bwd"].items():
        PATH_LN_BWD[b] += n
    return res["launches"]


def _digest(params: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


# TSF-B pretraining on synthetic clips, global batch 16, 3 steps
DDP_PRETRAIN = ["--dataset", "synthetic", "--model", MODEL["name"],
                "--steps", "3", "--batch-size", "16", "--workers", "4",
                "--print-freq", "1", "--device", DEVICE]


def _time_cli_steps(cli) -> dict:
    """Wrap ``cli.make_clip_train_step`` so that each step's loss and ms
    (host clock to the loss read) go into the returned record's
    ``losses`` and ``ms``."""
    real, record = cli.make_clip_train_step, {"losses": [], "ms": []}

    def timed(**kw):
        step_fn = real(**kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            record["losses"].append(metrics["loss"].item())
            record["ms"].append((time.perf_counter() - t0) * 1e3)
            return state, metrics
        return run

    cli.make_clip_train_step = timed
    return record


def ddp_world1_child(work: str, out: str) -> None:
    """``main_pretrain`` on TSF-B (bf16, batch 16, 3 steps, synthetic
    data) without the launcher, through ``cli.launch --num-processes 1``
    (an NCCL group of one: the loss's all-gather, the gradients'
    all-reduce, the broadcast), again through it, then without: each
    run's losses, step ms (host clock to the loss read, the first step
    a warm-up), launches and the digest of its masters."""
    _child_setup()
    from lavila_tpu_torch.cli import launch
    from lavila_tpu_torch.cli import main_pretrain as cli
    from lavila_tpu_torch.config import parse_config
    record = _time_cli_steps(cli)
    runs, path = [], {}
    for i, how in enumerate(("direct", "launcher", "launcher", "direct")):
        argv = [*DDP_PRETRAIN, "--output-dir", os.path.join(work, f"run{i}")]
        record.update(losses=[], ms=[])
        reset_launch_counts()
        if how == "launcher":
            state = launch.main(["--num-processes", "1", "pretrain", *argv])
        else:
            state = cli.main(parse_config(cli.TorchPretrainConfig, argv))
        torch.cuda.synchronize()
        if i == 1:  # the path run of the summary
            counts = path_counts()
            path = {"by_branch": PATH_BRANCHES, "ln_bwd": PATH_LN_BWD}
        else:
            counts = launch_counts()
        runs.append({"how": how, "losses": record["losses"],
                     "step_ms": record["ms"], "launches": counts,
                     "digest": _digest(state.params)})
        del state
        shutil.rmtree(os.path.join(work, f"run{i}"))
        torch.cuda.empty_cache()
    _child_result(out, {"runs": runs, "launches": runs[1]["launches"],
                        **path})


def phase_ddp_nccl_world1() -> dict:
    """The launcher at a world of one (NCCL) against the same pretraining
    command without it (:func:`ddp_world1_child`, in turns): every
    step's loss and the final masters bit-identical, the same launches
    (3 steps' worth), the step time in turns. Returns the launches of
    the first launcher run."""
    with tempfile.TemporaryDirectory() as tmp:
        (res,) = _spawn([("ddp_world1_child",
                          (tmp, os.path.join(tmp, "out.json")))], tmp)
    runs = res["runs"]
    want = {k: 3 * n for k, n in _step_launches(MODEL).items()}
    ms = {how: [statistics.median(r["step_ms"][1:]) for r in runs
                if r["how"] == how] for how in ("direct", "launcher")}
    emit("ddp_nccl_world1", card=_smi(), model=MODEL["name"],
         dtype="bfloat16", batch=16, steps=3,
         order=[r["how"] for r in runs],
         losses=[r["losses"] for r in runs],
         digests_equal=len({r["digest"] for r in runs}) == 1,
         launches=runs[1]["launches"])
    emit("ddp_nccl_world1_step_ms", card=_smi(),
         what="median ms of steps 2-3 (host clock to the loss read), "
              "direct, launcher, launcher, direct; one card, a world of "
              "one: the collectives' cost, not a scaling number",
         step_ms=[statistics.median(r["step_ms"][1:]) for r in runs],
         direct=ms["direct"], launcher=ms["launcher"])
    check(all(len(r["losses"]) == 3 and all(map(math.isfinite, r["losses"]))
              for r in runs)
          and all(r["losses"] == runs[0]["losses"] for r in runs),
          f"ddp_nccl_world1: losses {[r['losses'] for r in runs]}")
    check(len({r["digest"] for r in runs}) == 1,
          "ddp_nccl_world1: the masters differ between the runs")
    check(all(r["launches"] == want for r in runs),
          f"ddp_nccl_world1: launches {[r['launches'] for r in runs]}, "
          f"want {want}")
    return _merge_path_counts(res)


def _ddp_steps(base, variant: str, batch: dict, steps: int = 2) -> dict:
    """``steps`` bf16 AdamW steps (the CLI's recipe, :func:`_make_state`)
    of a copy of ``base`` on ``batch`` under ``variant``
    (:data:`DDP_VARIANTS`), rank 0's weights broadcast first in a group:
    the losses, each step's fp32 master gradients (averaged over the
    ranks), launches and ms, the final masters."""
    from lavila_tpu_torch.parallel import mesh
    from lavila_tpu_torch.train.step import make_clip_train_step
    kw = DDP_VARIANTS[variant]
    crit = ({"logit_scale_pseudo": DDP_PSEUDO_INIT} if kw.get("use_ssl")
            else None)
    state = _make_state(copy.deepcopy(base).train(), torch.bfloat16,
                        criterion=crit)
    mesh.broadcast_params(state)
    step_fn = make_clip_train_step(norm_embed=True, **kw)
    out = {"losses": [], "grads": [], "launches": [], "ms": []}
    for _ in range(steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        out["losses"].append(metrics["loss"].item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(launch_counts())
        check_flash_tc(f"ddp {variant} bf16 step")
        check_tensor_cores(f"ddp {variant} bf16 step", "K1", "K2",
                           "K1 bwd", "K2 bwd")
        out["grads"].append({k: p.grad.clone() for k, p in
                             {**state.params, **state.criterion}.items()
                             if p.grad is not None})
    out["params"] = {k: p.detach().clone() for k, p in
                     {**state.params, **state.criterion}.items()}
    del state
    return out


def _grad_norm_ratios(got: list, want: list) -> list:
    """Each step's global norm of ``got``'s gradients (averaged over the
    ranks) over that of ``want``'s (one process), every leaf of both."""
    def norm(grads):
        return math.sqrt(sum(g.double().square().sum().item()
                             for g in grads.values()))
    return [norm(g) / norm(w) for g, w in zip(got, want)]


def ddp_rank_child(rank: int, port: int, world: int, backend: str,
                   out: str) -> None:
    """One of ``world`` ranks: two gloo ranks on the one card, or one
    NCCL rank a card (``cuda:{rank}``). TSF-B from the seed (the other
    ranks' weights perturbed, which the broadcast replaces), its
    ``16 / world`` rows of a batch of 16, two steps of each
    :data:`DDP_VARIANTS`. Rank 0 first runs each variant in one process
    on the 16 rows (no group) and holds the ranks' losses, gradients
    (their cosines and the ratio of their global norms) and masters
    against it."""
    _child_setup()
    from lavila_tpu_torch.parallel import mesh
    local_rank = rank if backend == "nccl" else 0
    torch.cuda.set_device(local_rank)
    base = _clip_model(DDP_MODEL)
    batch = _train_batch(16, torch.Generator(device=DEVICE).manual_seed(
        SEED + 31), MODEL["img"])
    b = 16 // world
    local = {k: batch[k][b * rank:b * (rank + 1)]
             for k in ("frames", "text", "gt_indicators")}
    if rank:
        with torch.no_grad():
            for p in base.parameters():
                p.add_(0.01)
    ref = {v: _ddp_steps(base, v, batch) for v in DDP_VARIANTS} \
        if rank == 0 else {}
    mesh.init_process_group(backend, f"tcp://localhost:{port}", world, rank,
                            local_rank=local_rank, timeout=DDP_TIMEOUT)
    result = {}
    try:
        for variant in DDP_VARIANTS:
            got = _ddp_steps(base, variant, local)
            line = {"losses": got["losses"], "step_ms": got["ms"],
                    "launches": got["launches"],
                    "digest": _digest(got["params"])}
            if rank == 0:
                want = ref.pop(variant)
                cmp = _compare_steps(
                    (got["losses"], got["grads"], None),
                    (want["losses"], want["grads"], None))
                # AdamW moves an element by about lr a step at most,
                # whatever rounding decides for a near-zero gradient (the
                # MINI parity tests' 2·Σ lr; 2.5 for the weight decay and
                # the masters' fp32 rounding)
                lr = 1.25 * sum(_make_state_lr(t) for t in range(2))
                diff = max(max_err(p, want["params"][k])
                           for k, p in got["params"].items())
                # AdamW hides the gradient's scale, so it is held apart:
                # a gather's backward or an average off by the world gives
                # a ratio of world or 1/world
                ratios = _grad_norm_ratios(got["grads"], want["grads"])
                line.update(single_process={
                    "losses": want["losses"], "launches": want["launches"],
                    "step_ms": want["ms"], **cmp,
                    "grad_norm_ratio": ratios,
                    "grad_norm_ratio_bound": DDP_NORM_RATIO,
                    "params_max_abs_diff": diff, "params_bound": 2 * lr})
                check(cmp["loss_rel_err"] <= 1e-2
                      and cmp["grad_cos_min"] >= 0.99 and diff <= 2 * lr,
                      f"ddp {variant}: {world} ranks against one process "
                      f"{cmp}, masters {diff} (bound {2 * lr})")
                check(all(abs(r - 1) <= DDP_NORM_RATIO for r in ratios),
                      f"ddp {variant}: gradient norm over one process's "
                      f"{ratios}, bound 1 ± {DDP_NORM_RATIO}")
                check(got["launches"] == want["launches"],
                      f"ddp {variant}: rank launches {got['launches']}, "
                      f"one process {want['launches']}")
            result[variant] = line
            del got
            torch.cuda.empty_cache()
    finally:
        mesh.destroy_process_group()
    _child_result(out, {"variants": result, "batch_digest": _digest(batch),
                        "device": f"cuda:{torch.cuda.current_device()}"})


def _make_state_lr(step: int) -> float:
    """The rate of :func:`_make_state`'s schedule at ``step``."""
    from lavila_tpu_torch.train.optim import cosine_schedule
    return cosine_schedule(3e-5, 1e-5, 5, 100, warmup_epochs=1,
                           start_warmup_lr=1e-6)(step)


def _ddp_ranks(world: int, backend: str, phase: str) -> None:
    """``world`` ranks of :func:`ddp_rank_child` under ``backend``: the
    ranks' masters bit-identical and their losses equal, each against
    one process on the whole batch (rank 0's checks), each rank's
    launches a step those of the one-process step."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        res = _spawn([("ddp_rank_child",
                       (r, port, world, backend,
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(world)], tmp)
    want = _step_launches(DDP_MODEL)
    where = ("gloo (both ranks on cuda:0)" if backend == "gloo" else
             f"nccl ({', '.join(r['device'] for r in res)})")
    check(len({r["batch_digest"] for r in res}) == 1,
          f"{phase}: the ranks drew different batches")
    for variant in DDP_VARIANTS:
        lines = [r["variants"][variant] for r in res]
        emit(phase, card=_smi(), model=MODEL["name"], variant=variant,
             depth=DDP_MODEL["depth"],
             dtype="bfloat16", batch=f"16 = {world} ranks x {16 // world}",
             steps=2, backend=where,
             losses=[r["losses"] for r in lines],
             digests_equal=len({r["digest"] for r in lines}) == 1,
             step_ms=[r["step_ms"] for r in lines],
             step_ms_note=("two processes on one card, their gradients "
                           "staged through host memory: not a scaling "
                           "number" if backend == "gloo" else
                           "one card a rank, 16 / world rows each"),
             launches=lines[0]["launches"][0],
             single_process=lines[0]["single_process"])
        check(len({r["digest"] for r in lines}) == 1,
              f"ddp {variant}: the ranks' masters differ")
        check(all(r["losses"] == lines[0]["losses"] for r in lines),
              f"ddp {variant}: rank losses {[r['losses'] for r in lines]}")
        check(all(c == want for r in lines for c in r["launches"]),
              f"ddp {variant}: launches {[r['launches'] for r in lines]},"
              f" want {want}")


def phase_ddp_two_ranks() -> None:
    """Two gloo ranks sharing the card (:func:`_ddp_ranks`)."""
    _ddp_ranks(2, "gloo", "ddp_two_ranks")


def ddp_cards_cli_child(rank: int, world: int, port: int, work: str,
                        out: str) -> None:
    """One of ``world`` NCCL ranks of ``cli.launch --coordinator
    --num-processes --process-id pretrain`` (:data:`DDP_PRETRAIN`, the
    global batch 16 split over the ranks): its losses, step ms, launches,
    the card its masters live on and their digest."""
    _child_setup()
    from lavila_tpu_torch.cli import launch
    from lavila_tpu_torch.cli import main_pretrain as cli
    record = _time_cli_steps(cli)
    reset_launch_counts()
    state = launch.main(["--coordinator", f"localhost:{port}",
                         "--num-processes", str(world), "--process-id",
                         str(rank), "pretrain", *DDP_PRETRAIN,
                         "--output-dir", work])
    torch.cuda.synchronize()
    _child_result(out, {"losses": record["losses"], "step_ms": record["ms"],
                        "launches": launch_counts(),
                        "devices": sorted({str(p.device) for p in
                                           state.params.values()}),
                        "digest": _digest(state.params)})


def phase_ddp_nccl_cards(world: int) -> None:
    """NCCL across ``world`` cards, one rank a card: the library step
    (:func:`_ddp_ranks`) against one process, then ``main_pretrain``
    through the launcher (:func:`ddp_cards_cli_child`): every rank's
    masters on ``cuda:{rank}``, bit-identical over the ranks, equal
    losses, 3 steps' launches on each rank, the checkpoint written."""
    _ddp_ranks(world, "nccl", "ddp_nccl_cards")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "run")
        res = _spawn([("ddp_cards_cli_child",
                       (r, world, port, work,
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(world)], tmp)
        files = sorted(os.listdir(work))
    want = {k: 3 * n for k, n in _step_launches(MODEL).items()}
    emit("ddp_nccl_cards_cli", card=_smi(), model=MODEL["name"],
         dtype="bfloat16", batch=f"16 = {world} ranks x {16 // world}",
         steps=3, devices=[r["devices"] for r in res],
         losses=[r["losses"] for r in res],
         digests_equal=len({r["digest"] for r in res}) == 1,
         step_ms=[r["step_ms"] for r in res], files=files,
         launches=res[0]["launches"])
    check(all(r["devices"] == [f"cuda:{i}"] for i, r in enumerate(res)),
          f"ddp_nccl_cards_cli: masters on {[r['devices'] for r in res]}")
    check(len({r["digest"] for r in res}) == 1,
          "ddp_nccl_cards_cli: the ranks' masters differ")
    check(all(len(r["losses"]) == 3 and r["losses"] == res[0]["losses"]
              and all(map(math.isfinite, r["losses"])) for r in res),
          f"ddp_nccl_cards_cli: losses {[r['losses'] for r in res]}")
    check(all(r["launches"] == want for r in res),
          f"ddp_nccl_cards_cli: launches {[r['launches'] for r in res]}, "
          f"want {want}")
    check("checkpoint_latest.pt" in files,
          f"ddp_nccl_cards_cli wrote {files}")


def _free_port() -> int:
    from lavila_tpu_torch.cli.launch import free_port
    return free_port()


DDP_NARRATE = ["--dataset", "synthetic", "--model", NARRATOR["name"],
               "--bf16", "--device", DEVICE, "--batch-size", "3",
               "--max-samples", "6", "--num-return-sequences", "2",
               "--max-text-length", "20", "--top-k", "1", "--workers", "2"]


def ddp_narrator_child(rank: int, port: int, work: str, out: str) -> None:
    """One of two gloo ranks on the one card running the port's
    ``main_infer_narrator.main`` (:data:`DDP_NARRATE`, greedy) into the
    shared ``work`` directory; its launches."""
    _child_setup()
    from lavila_tpu_torch.cli import main_infer_narrator as cli
    from lavila_tpu_torch.parallel import mesh
    mesh.init_process_group("gloo", f"tcp://localhost:{port}", 2, rank,
                            local_rank=0, timeout=DDP_TIMEOUT)
    try:
        reset_launch_counts()
        cli.main(cli.get_args_parser().parse_args(
            [*DDP_NARRATE, "--output-dir", work]))
        torch.cuda.synchronize()
        counts = path_counts()
    finally:
        mesh.destroy_process_group()
    _child_result(out, {"launches": counts, "by_branch": PATH_BRANCHES,
                        "ln_bwd": PATH_LN_BWD})


def phase_ddp_infer_narrator() -> dict:
    """``main_infer_narrator`` over two gloo ranks on the card
    (:func:`ddp_narrator_child`): ``cache.0.pkl``, ``cache.1.pkl`` and
    ``total.pkl`` written, rank 0 holding clips 0, 2, 4 and rank 1 clips
    1, 3, 5, ``total.pkl`` their round-robin merge, in dataset order:
    each record the captions of a one-process run of the same command
    (this process, while the ranks run), clip by clip, with (video_uid,
    t_start, t_end); K9 launched on each rank. Returns rank 0's
    launches."""
    import pickle

    from lavila_tpu_torch.cli import main_infer_narrator as cli
    port, want = _free_port(), []
    with tempfile.TemporaryDirectory() as tmp:
        work, one = os.path.join(tmp, "two"), os.path.join(tmp, "one")
        res = _spawn([("ddp_narrator_child",
                       (r, port, work, os.path.join(tmp, f"rank{r}.json")))
                      for r in range(2)], tmp,
                     lambda: want.extend(cli.main(
                         cli.get_args_parser().parse_args(
                             [*DDP_NARRATE, "--output-dir", one]))))
        files = sorted(os.listdir(work))
        shards = []
        for r in range(2):
            with open(os.path.join(work, f"cache.{r}.pkl"), "rb") as f:
                shards.append(pickle.load(f))
        with open(os.path.join(work, "total.pkl"), "rb") as f:
            total = pickle.load(f)
    order = [[2 * i + r for i in range(3)] for r in range(2)]
    same = lambda got, w: got[:4] == w[:4]  # noqa: E731
    shards_ok = all(same(rec, want[i]) for r in range(2)
                    for rec, i in zip(shards[r], order[r]))
    total_ok = (len(total) == len(want) == 6
                and all(same(g, w) for g, w in zip(total, want)))
    k9 = [r["launches"]["K9"] for r in res]
    emit("ddp_infer_narrator", card=_smi(), model=NARRATOR["name"],
         dtype="bfloat16", clips=6, ranks=2,
         backend="gloo (both ranks on cuda:0)", files=files,
         shard_records=[len(s) for s in shards], total_records=len(total),
         shards_in_sampler_order=shards_ok, total_in_dataset_order=total_ok,
         first_record=[*total[0][:3], total[0][3]] if total else None,
         launches=[r["launches"] for r in res])
    check({"cache.0.pkl", "cache.1.pkl", "total.pkl"} <= set(files),
          f"ddp_infer_narrator wrote {files}")
    check(shards_ok and total_ok,
          "ddp_infer_narrator: the shards or total.pkl are not the "
          "one-process records in sampler and dataset order")
    check(all(n > 0 and n % NARRATOR["layers"] == 0 for n in k9),
          f"ddp_infer_narrator: K9 launches by rank {k9}")
    return _merge_path_counts(res[0])


# ------------------------------------------------ tensor parallelism, ring
# The model axis (parallel/sharding.py, parallel/tensor.py) and the ring
# attention (ops/ring_attention.py). One card: two gloo ranks share it, as
# ddp_two_ranks; --nccl-ranks 4: a NCCL rank a card. No line is a scaling
# number: the ranks' collectives go through host memory (gloo) or NVLink,
# and the work a rank does is half or a quarter of one process's.
# the narrator's cached decode at model=2: 8 teacher-fed steps, then
# greedy generation of 16 tokens (2 clips x 2 return sequences)
TP_DECODE_STEPS = 8
# the narrator at model=2: GPT-2 XL at full width (25 heads, 13/12), cut to
# 16 of its 48 layers for the time limit
TP_NARRATOR = NARRATOR_CUT
# the time phase at TSF-B width: batch 2, 16 frames of 196 patches, 12
# heads of 64
RING_SHAPE = (2, 16, 196, 12, 64)


def _tp_steps(base, batch: dict, what: str, steps: int = 2,
              path: bool = False) -> dict:
    """``steps`` bf16 AdamW steps (the CLI's recipe, :func:`_make_state`)
    of a copy of ``base`` sharded over the model group (whole outside
    one) on ``batch``: the losses, each step's fp32 master gradients and
    the final masters (their digest), both gathered to the whole
    layout; launches and
    ms a step (with ``path``, the last step's read by
    :func:`path_counts`); the digest of the replicated masters."""
    from lavila_tpu_torch.parallel import mesh, sharding
    from lavila_tpu_torch.train.step import make_clip_train_step
    model = sharding.shard_model(copy.deepcopy(base).train())
    state = _make_state(model, torch.bfloat16)
    mesh.broadcast_params(state)
    splits = sharding.layout(state.params)
    step_fn = make_clip_train_step(norm_embed=True)
    out = {"losses": [], "grads": [], "launches": [], "ms": []}
    for _ in range(steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        out["losses"].append(metrics["loss"].item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        last = path and len(out["ms"]) == steps
        out["launches"].append(path_counts() if last else launch_counts())
        check_flash_tc(f"{what} bf16 step")
        check_tensor_cores(f"{what} bf16 step", "K1", "K2", "K1 bwd",
                           "K2 bwd")
        out["grads"].append(sharding.gather_state_dict(
            {k: p.grad for k, p in state.params.items()
             if p.grad is not None}, splits))
    out["params"] = sharding.gather_state_dict(
        {k: p.detach() for k, p in state.params.items()}, splits)
    out["replicated"] = _digest({k: p for k, p in state.params.items()
                                 if k not in splits})
    out["sharded"] = {k: list(state.params[k].shape) for k in splits}
    del state
    return out


def tp_rank_child(rank: int, port: int, world: int, model_size: int,
                  backend: str, out: str) -> None:
    """One of ``world`` ranks at a model axis of ``model_size``: two gloo
    ranks on the one card, or a NCCL rank a card. TSF-B from the seed,
    its data rank's rows of a batch of 16, two bf16 AdamW steps with its
    wide layers sharded. Rank 0 first runs the steps in one process on
    the 16 rows and holds the ranks' losses, gathered gradients (their
    cosines) and masters against it."""
    _child_setup()
    from lavila_tpu_torch.parallel import mesh
    local_rank = rank if backend == "nccl" else 0
    torch.cuda.set_device(local_rank)
    base = _clip_model(MODEL)
    batch = _train_batch(16, torch.Generator(device=DEVICE).manual_seed(
        SEED + 37), MODEL["img"])
    what = f"tp model={model_size} x data={world // model_size}"
    want = _tp_steps(base, batch, f"{what} one process") if rank == 0 \
        else None
    mesh.init_process_group(backend, f"tcp://localhost:{port}", world, rank,
                            local_rank=local_rank, timeout=DDP_TIMEOUT)
    try:
        mesh.init_model_parallel(model_size)
        b = 16 // mesh.data_world()
        r = mesh.data_rank()
        local = {k: batch[k][b * r:b * (r + 1)] for k in ("frames", "text")}
        got = _tp_steps(base, local, what, path=True)
        line = {"losses": got["losses"], "step_ms": got["ms"],
                "launches": got["launches"], "replicated": got["replicated"],
                "by_branch": PATH_BRANCHES, "ln_bwd": PATH_LN_BWD,
                "digest": _digest(got["params"]),
                "sharded_qkv": got["sharded"].get(
                    "visual.blocks.0.attn.qkv.weight"),
                "model_rank": mesh.model_rank(),
                "data_rank": mesh.data_rank()}
        if rank == 0:
            # the gradients carry the comparison: AdamW moves every
            # master about its rate a step whatever its gradient, so the
            # masters' distance says nothing a gradient fault would move
            cmp = _compare_steps((got["losses"], got["grads"], None),
                                 (want["losses"], want["grads"], None))
            ratios = _grad_norm_ratios(got["grads"], want["grads"])
            line["single_process"] = {
                "losses": want["losses"], "launches": want["launches"],
                "step_ms": want["ms"], **cmp, "grad_norm_ratio": ratios}
            check(cmp["loss_rel_err"] <= 1e-2
                  and cmp["grad_cos_min"] >= 0.99,
                  f"{what}: against one process {cmp}")
            check(all(abs(x - 1) <= DDP_NORM_RATIO for x in ratios),
                  f"{what}: gradient norm over one process's {ratios}")
            check(got["launches"] == want["launches"],
                  f"{what}: rank launches {got['launches']}, one process "
                  f"{want['launches']}")
        del got
    finally:
        mesh.destroy_process_group()
    _child_result(out, line)


def _tp_ranks(world: int, model_size: int, backend: str,
              phase: str) -> dict:
    """``world`` ranks of :func:`tp_rank_child` under ``backend``: the
    ranks' replicated masters bit-identical (and the gathered masters
    over the whole world), equal losses, each rank's launches a step the
    one-process step's (rank 0's checks against one process). Returns
    rank 0's launches of its last step, its branches merged into the
    path's (:func:`_merge_path_counts`)."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        res = _spawn([("tp_rank_child",
                       (r, port, world, model_size, backend,
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(world)], tmp)
    where = ("gloo (both ranks on cuda:0)" if backend == "gloo"
             else f"nccl, {world} cards")
    emit(phase, card=_smi(), model=MODEL["name"], dtype="bfloat16",
         mesh=f"data={world // model_size} x model={model_size}",
         batch=f"16 = {world // model_size} replicas x "
               f"{16 // (world // model_size)}", steps=2, backend=where,
         heads_a_rank=[MODEL["width"] // 64 // model_size],
         sharded_qkv=[r["sharded_qkv"] for r in res],
         losses=[r["losses"] for r in res],
         replicated_equal=len({r["replicated"] for r in res}) == 1,
         digests_equal=len({r["digest"] for r in res}) == 1,
         step_ms=[r["step_ms"] for r in res],
         step_ms_note=("two processes on one card, every activation "
                       "all-reduce staged through host memory: not a "
                       "scaling number" if backend == "gloo" else
                       "a card a rank: not a scaling number"),
         launches=res[0]["launches"][0],
         single_process=res[0]["single_process"])
    check(len({r["replicated"] for r in res}) == 1,
          f"{phase}: the ranks' replicated masters differ")
    check(len({r["digest"] for r in res}) == 1,
          f"{phase}: the ranks' gathered masters differ")
    check(all(r["losses"] == res[0]["losses"] for r in res),
          f"{phase}: rank losses {[r['losses'] for r in res]}")
    check(all(c == res[0]["launches"][0] for r in res
              for c in r["launches"]),
          f"{phase}: launches {[r['launches'] for r in res]}")
    return _merge_path_counts({**res[0], "launches": res[0]["launches"][-1]})


def phase_tp_two_ranks() -> dict:
    """Two gloo ranks sharing the card at model=2 (:func:`_tp_ranks`):
    TSF-B's 12 heads 6 a rank."""
    return _tp_ranks(2, 2, "gloo", "tp_two_ranks")


def _tp_partings(model, tokens, ids, ids_ref, nrs: int = 2) -> list:
    """Where a row of the tensor-parallel greedy ids first parts from one
    process's: the row, the step, and one process's logit gap between
    the two tokens there (``model``: one process's, ``tokens`` its image
    tokens)."""
    out = []
    for r in range(ids.shape[0]):
        apart = (ids[r] != ids_ref[r]).nonzero()
        if not len(apart):
            continue
        s = int(apart[0])
        logits = model.text_decoder(
            ids_ref[r:r + 1, :s],
            encoder_states=tokens[r // nrs:r // nrs + 1])[0, -1].float()
        out.append({"row": r, "step": s, "tokens": [int(ids_ref[r, s]),
                                                    int(ids[r, s])],
                    "gap": (logits[ids_ref[r, s]]
                            - logits[ids[r, s]]).abs().item()})
    return out


def _tp_caption_step(n, base, batch, what: str) -> dict:
    """One bf16 caption step of LaViLa's recipe (:func:`_caption_state`)
    on a copy of narrator ``base`` sharded over the model group (whole
    outside one): the loss, the trainable masters' fp32 gradients
    gathered to the whole layout, and the launches, on the tensor cores
    only."""
    from lavila_tpu_torch.parallel import sharding
    state, step_fn = _caption_state(base, torch.bfloat16, shard=True)
    reset_launch_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    out = {"losses": [metrics["loss"].item()], "launches": launch_counts()}
    check_flash_tc(what)
    check_tensor_cores(what, n["space"], "K2", f"{n['space']} bwd",
                       "K2 bwd")
    out["grads"] = [sharding.gather_state_dict(
        {k: p.grad for k, p in state.params.items() if p.grad is not None},
        sharding.layout(state.params))]
    del state
    return out


def tp_narrator_child(rank: int, port: int, world: int, backend: str,
                      out: str) -> None:
    """One of ``world`` ranks at a model axis of the world: the TSF-B +
    GPT-2 XL narrator (bf16, seeded) with its wide layers sharded (25
    heads: 13/12 at two ranks), encode_image, :data:`TP_DECODE_STEPS`
    teacher-fed cached steps and greedy generation; then one bf16 caption
    step of LaViLa's recipe at batch 4 (:func:`_tp_caption_step`, the
    backward through the sharded GPT-2, the pooler's gathered K/V head
    and the video tower's time attention). Rank 0 first runs them in one
    process, keeps that model for the partings, and holds the ranks'
    outputs against it by the bf16 narrator rule and the step's
    gradients by their cosines and norm."""
    _child_setup()
    from lavila_tpu_torch.parallel import mesh, sharding
    n = TP_NARRATOR
    local_rank = rank if backend == "nccl" else 0
    torch.cuda.set_device(local_rank)
    base, _ = _narrator_model(n)
    model = copy.deepcopy(base).to(torch.bfloat16).eval()
    with torch.no_grad():  # as narrator_train_step compares the pooler
        base.img_attn_pool.to_q.weight.mul_(POOL_SPREAD)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    frames, _ = _inputs(2, gen, n["img"])
    text = torch.randint(0, 50257, (2, TP_DECODE_STEPS), generator=gen,
                         device=DEVICE)
    text[:, 0] = n["bos"]
    caption = _caption_batch(4, gen, n)
    L = 16
    ref = {}
    if rank == 0:
        ref["step"] = _tp_caption_step(n, base, caption,
                                       "tp_narrator one process caption step")
    with torch.inference_mode():
        if rank == 0:
            ref["tokens"] = model.encode_image(frames)
            ref["full"] = model.text_decoder(text,
                                             encoder_states=ref["tokens"])
            ref["cached"], _ = _cached_logits(model, ref["tokens"], text,
                                              TP_DECODE_STEPS)
            ref["ids"], _ = _greedy(model, ref["tokens"], n, L)
            one = model
            model = copy.deepcopy(one)
    mesh.init_process_group(backend, f"tcp://localhost:{port}", world, rank,
                            local_rank=local_rank, timeout=DDP_TIMEOUT)
    try:
        mesh.init_model_parallel(world)
        sharding.shard_model(model)
        attn = model.text_decoder.transformer.h[0].attn
        with torch.inference_mode():
            reset_launch_counts()
            t0 = time.perf_counter()
            tokens = model.encode_image(frames)
            torch.cuda.synchronize()
            encode_ms = (time.perf_counter() - t0) * 1e3
            per_image = launch_counts()
            check_tensor_cores(f"tp_narrator rank {rank} bf16 encode_image",
                               n["space"], "K2")
            cached, per_step = _cached_logits(model, tokens, text,
                                              TP_DECODE_STEPS)
            reset_launch_counts()
            t0 = time.perf_counter()
            ids, ppl = _greedy(model, tokens, n, L)
            torch.cuda.synchronize()
            greedy_ms = (time.perf_counter() - t0) * 1e3
            greedy = path_counts()
            line = {"heads": attn.c_proj.in_features // attn.head_dim,
                    "width": model.text_decoder.cache_width(),
                    "launches_per_encode_image": per_image,
                    "launches_per_decode_step": per_step,
                    "launches": greedy, "encode_ms": encode_ms,
                    "greedy_ms": greedy_ms, "ids": ids.tolist(),
                    "by_branch": PATH_BRANCHES, "ln_bwd": PATH_LN_BWD,
                    "finite": bool(torch.isfinite(cached).all()
                                   and torch.isfinite(ppl).all())}
            if rank == 0:
                noise = max_err(ref["cached"], ref["full"])
                partings = _tp_partings(one, ref["tokens"], ids, ref["ids"])
                line["single_process"] = {
                    "logits_err": max_err(cached, ref["full"]),
                    "one_process_cached_err": noise,
                    "logits_cos_min": _cos_min(cached, ref["full"]),
                    "image_tokens_err": max_err(tokens, ref["tokens"]),
                    "ids_one_process": ref["ids"].tolist(),
                    "ids_agree_steps": int((ids == ref["ids"]).all(0).long()
                                           .cumprod(0).sum()) - 1,
                    "partings": partings}
                sp = line["single_process"]
                check(sp["logits_cos_min"] >= 0.99
                      and sp["logits_err"] <= 1.25 * noise
                      and all(p["gap"] <= noise for p in partings
                              if p["step"] <= 4),
                      f"tp_narrator: {world} ranks against one process "
                      f"by the bf16 narrator rule: {sp}")
        want_step = dict.fromkeys(COUNTERS, 0)
        want_step.update({"K9": n["layers"],
                          "K3": 2 * (n["layers"] + n["cross"]) + 1})
        check(per_step == want_step,
              f"tp_narrator rank {rank}: launches per decode step "
              f"{per_step}")
        check(line["finite"], f"tp_narrator rank {rank}: non-finite")
        del model
        what = f"tp_narrator rank {rank} caption step"
        got = _tp_caption_step(n, base, caption, what)
        line["caption_loss"] = got["losses"][0]
        if rank == 0:
            want = ref["step"]
            cmp = _compare_steps((got["losses"], got["grads"], None),
                                 (want["losses"], want["grads"], None))
            pool = "img_attn_pool.to_kv.weight"
            cmp["to_kv_grad_cos"] = torch.nn.functional.cosine_similarity(
                got["grads"][0][pool].flatten(),
                want["grads"][0][pool].flatten(), dim=0).item()
            cmp["grad_norm_ratio"] = _grad_norm_ratios(got["grads"],
                                                       want["grads"])
            cmp["launches"], cmp["launches_one_process"] = \
                got["launches"], want["launches"]
            line["caption_step"] = cmp
            check(cmp["loss_rel_err"] <= 1e-2
                  and cmp["grad_cos_min"] >= 0.99
                  and cmp["to_kv_grad_cos"] >= 0.99
                  and all(abs(x - 1) <= DDP_NORM_RATIO
                          for x in cmp["grad_norm_ratio"]),
                  f"{what} against one process: {cmp}")
            check(got["launches"] == want["launches"],
                  f"{what}: launches {got['launches']}, one process "
                  f"{want['launches']}")
        del got
    finally:
        mesh.destroy_process_group()
    _child_result(out, line)


def phase_tp_narrator() -> dict:
    """The narrator over two gloo ranks on the card at model=2
    (:func:`tp_narrator_child`): GPT-2 XL's 25 heads 13/12, K9 at 832 and
    768 wide, a layer a decode step on each rank; the ranks' greedy ids
    equal. Returns rank 0's greedy launches."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        res = _spawn([("tp_narrator_child",
                       (r, port, 2, "gloo",
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(2)], tmp)
    emit("tp_narrator", card=_smi(), model=TP_NARRATOR["name"],
         dtype="bfloat16", mesh="model=2", cut=TP_NARRATOR["cut"],
         backend="gloo (both ranks on cuda:0)", clips=2,
         return_sequences=2, heads=[r["heads"] for r in res],
         k9_width=[r["width"] for r in res],
         launches_per_decode_step=[r["launches_per_decode_step"]
                                   for r in res],
         encode_ms=[r["encode_ms"] for r in res],
         greedy_ms=[r["greedy_ms"] for r in res],
         ms_note="two processes on one card, each layer's partial sums "
                 "all-reduced through host memory: not a scaling number",
         single_process=res[0]["single_process"],
         caption_batch=4, caption_losses=[r["caption_loss"] for r in res],
         caption_step=res[0]["caption_step"])
    check(res[0]["caption_loss"] == res[1]["caption_loss"],
          "tp_narrator: the ranks' caption losses differ")
    check([r["heads"] for r in res] == [13, 12]
          and [r["width"] for r in res] == [832, 768],
          f"tp_narrator: heads {[r['heads'] for r in res]}")
    check(res[0]["ids"] == res[1]["ids"],
          "tp_narrator: the ranks' greedy ids differ")
    return _merge_path_counts(res[0])


def _ring_inputs(dtype):
    """Seeded CLS-separate q/k/v of the time phase at :data:`RING_SHAPE`
    (qp/kp/vp frame-major row views of one packed tensor, as the model's
    qkv gives them) and the weights of the compared scalar."""
    B, F, N, H, d = RING_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 43)
    packed = torch.randn(B, F, N, 3 * H * d, generator=gen, device=DEVICE)
    cls = torch.randn(B, 1, 3 * H * d, generator=gen, device=DEVICE)
    qp, kp, vp = (t.reshape(B, F, N, H, d) for t in
                  packed.to(dtype).chunk(3, -1))
    cq, ck, cv = (t.reshape(B, 1, H, d) for t in cls.to(dtype).chunk(3, -1))
    w = (torch.randn(B, 1, H, d, generator=gen, device=DEVICE),
         torch.randn(B, F, N, H, d, generator=gen, device=DEVICE))
    return (cq, ck, cv, qp, kp, vp), w


def _time_phase(fn, dtype, grads: bool):
    """``fn`` (the one-process time phase or the ring) on
    :func:`_ring_inputs`: the whole output (CLS row first), its ms, and
    with ``grads`` the gradients of the weighted sum."""
    ins, (wc, wp) = _ring_inputs(dtype)
    ins = [t.detach().clone().requires_grad_(grads) for t in ins]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls, pat = fn(*ins)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    B, F, N, H, d = RING_SHAPE
    whole = torch.cat([cls, pat.reshape(B, F * N, H, d)], 1).detach()
    out = {"out": whole, "ms": ms}
    if grads:
        ((cls.float() * wc).sum() + (pat.float() * wp).sum()).backward()
        out["grads"] = [t.grad for t in ins]
    return out


def _ring_encode(frames):
    """TSF-B at 16 frames (seeded) encoding ``frames`` in bf16, and the
    launches of the encode."""
    model = _clip_model(MODEL, num_frames=RING_SHAPE[1]).to(
        torch.bfloat16).eval()
    with torch.inference_mode():
        reset_launch_counts()
        emb = model.encode_image(frames)
        torch.cuda.synchronize()
    return emb.float(), launch_counts()


def ring_rank_child(rank: int, port: int, world: int, backend: str,
                    out: str) -> None:
    """One of ``world`` ranks of the ring: the time phase at TSF-B width
    with its 16 frames over the ranks (fp32 with gradients, bf16), then a
    TSF-B encode at 16 frames with the ring group set. Rank 0 first runs
    the one-process time phase (K2 and its backward) and encode, and
    holds the ranks' results against them."""
    _child_setup()
    from lavila_tpu_torch.ops import ring_attention as R
    from lavila_tpu_torch.ops.attention import divided_attention_split
    from lavila_tpu_torch.parallel import mesh
    local_rank = rank if backend == "nccl" else 0
    torch.cuda.set_device(local_rank)

    def one(*ins):
        return divided_attention_split(*ins, "time")

    frames, _ = _inputs(2, torch.Generator(device=DEVICE).manual_seed(
        SEED + 47), MODEL["img"], RING_SHAPE[1])
    ref = {}
    if rank == 0:
        ref = {"fp32": _time_phase(one, torch.float32, True),
               "bf16": _time_phase(one, torch.bfloat16, False),
               "encode": _ring_encode(frames)}
    mesh.init_process_group(backend, f"tcp://localhost:{port}", world, rank,
                            local_rank=local_rank, timeout=DDP_TIMEOUT)
    try:
        group = mesh.world_group()

        def ring(*ins):
            return R.divided_time_ring(*ins, group)

        reset_launch_counts()
        got = {"fp32": _time_phase(ring, torch.float32, True),
               "bf16": _time_phase(ring, torch.bfloat16, False)}
        R.set_ring_group(group)
        try:
            emb, launches = _ring_encode(frames)
        finally:
            R.set_ring_group(None)
        counts = path_counts()
        line = {"ms": {k: got[k]["ms"] for k in ("fp32", "bf16")},
                "encode_launches": launches, "launches": counts,
                "by_branch": PATH_BRANCHES, "ln_bwd": PATH_LN_BWD,
                "digest": _digest({"emb": emb})}
        check(launches["K2"] == 0 and launches["K1"] == MODEL["depth"],
              f"ring rank {rank}: encode launches {launches}")
        if rank == 0:
            def rel(a, b):
                return max_err(a, b) / b.float().abs().max().item()
            res = {"fp32_rel_err": rel(got["fp32"]["out"],
                                       ref["fp32"]["out"]),
                   "fp32_grad_rel_err": max(
                       rel(a, b) for a, b in zip(got["fp32"]["grads"],
                                                 ref["fp32"]["grads"])),
                   "bf16_rel_err": rel(got["bf16"]["out"],
                                       ref["bf16"]["out"]),
                   "encode_rel_err": rel(emb, ref["encode"][0]),
                   "encode_cos_min": _cos_min(emb, ref["encode"][0]),
                   "one_process_ms": {k: ref[k]["ms"]
                                      for k in ("fp32", "bf16")},
                   "one_process_encode_launches": ref["encode"][1]}
            line["single_process"] = res
            check(res["fp32_rel_err"] <= TOL[torch.float32]
                  and res["fp32_grad_rel_err"] <= TOL[torch.float32]
                  and res["bf16_rel_err"] <= TOL[torch.bfloat16]
                  and res["encode_rel_err"] <= TOL[torch.bfloat16]
                  and res["encode_cos_min"] >= 0.999,
                  f"ring over {world} ranks against one process: {res}")
    finally:
        mesh.destroy_process_group()
    _child_result(out, line)


def _ring_ranks(world: int, backend: str, phase: str) -> dict:
    """``world`` ranks of :func:`ring_rank_child`: their encodes
    bit-identical; returns rank 0's launches."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        res = _spawn([("ring_rank_child",
                       (r, port, world, backend,
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(world)], tmp)
    emit(phase, card=_smi(), shape="B, F, N, H, d = "
         + ", ".join(map(str, RING_SHAPE)), frames_a_rank=RING_SHAPE[1]
         // world, backend=("gloo (both ranks on cuda:0)"
                            if backend == "gloo" else f"nccl, {world} cards"),
         ms=[r["ms"] for r in res],
         ms_note="host clock of one call, first call of each dtype; "
                 + ("K/V shards through host memory under gloo"
                    if backend == "gloo" else "K/V shards sent card to "
                    "card by NCCL") + ": not a scaling number",
         encode_model=MODEL["name"], encode_launches=res[0][
             "encode_launches"],
         encodes_equal=len({r["digest"] for r in res}) == 1,
         single_process=res[0]["single_process"])
    check(len({r["digest"] for r in res}) == 1,
          f"{phase}: the ranks' encodes differ")
    return _merge_path_counts(res[0])


def phase_ring_two_ranks() -> dict:
    """The ring over two gloo ranks on the card (:func:`_ring_ranks`)."""
    return _ring_ranks(2, "gloo", "ring_two_ranks")


def tp_cards_cli_child(rank: int, world: int, port: int, work: str,
                       out: str) -> None:
    """One of ``world`` NCCL ranks of ``cli.launch --coordinator
    --num-processes --process-id pretrain --mesh-model 2``
    (:data:`DDP_PRETRAIN`): its losses, launches, the shape of its first
    qkv shard and the digest of its replicated masters."""
    _child_setup()
    from lavila_tpu_torch.cli import launch
    from lavila_tpu_torch.cli import main_pretrain as cli
    from lavila_tpu_torch.parallel import sharding
    record = _time_cli_steps(cli)
    reset_launch_counts()
    state = launch.main(["--coordinator", f"localhost:{port}",
                         "--num-processes", str(world), "--process-id",
                         str(rank), "pretrain", *DDP_PRETRAIN,
                         "--mesh-model", "2", "--output-dir", work])
    torch.cuda.synchronize()
    splits = sharding.layout(state.params)
    _child_result(out, {
        "losses": record["losses"], "step_ms": record["ms"],
        "launches": launch_counts(),
        "qkv": list(state.params["visual.blocks.0.attn.qkv.weight"].shape),
        "replicated": _digest({k: p for k, p in state.params.items()
                               if k not in splits}),
        "devices": sorted({str(p.device) for p in state.params.values()})})


def phase_tp_nccl_cards(world: int) -> None:
    """NCCL across ``world`` cards: the TSF-B step at model=``world`` and
    at data=2 x model=2 (:func:`_tp_ranks`), ``main_pretrain
    --mesh-model 2`` through the launcher (replicas of two cards: each
    rank's masters on its card, the model ranks' qkv halves, the
    replicated masters and losses equal, the checkpoint the whole
    layout), and the ring over the ``world`` cards (:func:`_ring_ranks`).
    """
    _tp_ranks(world, world, "nccl", "tp_nccl_cards")
    _tp_ranks(world, 2, "nccl", "tp_nccl_cards")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "run")
        res = _spawn([("tp_cards_cli_child",
                       (r, world, port, work,
                        os.path.join(tmp, f"rank{r}.json")))
                      for r in range(world)], tmp)
        files = sorted(os.listdir(work))
        ckpt = torch.load(os.path.join(work, "checkpoint_latest.pt"),
                          map_location="cpu", weights_only=True)
    whole = list(ckpt["state_dict"]["visual.blocks.0.attn.qkv.weight"].shape)
    want = {k: 3 * n for k, n in _step_launches(MODEL).items()}
    emit("tp_nccl_cards_cli", card=_smi(), model=MODEL["name"],
         dtype="bfloat16", mesh=f"data={world // 2} x model=2",
         steps=3, devices=[r["devices"] for r in res],
         qkv=[r["qkv"] for r in res], checkpoint_qkv=whole,
         losses=[r["losses"] for r in res],
         step_ms=[r["step_ms"] for r in res], files=files,
         launches=res[0]["launches"])
    check(all(r["devices"] == [f"cuda:{i}"] for i, r in enumerate(res)),
          f"tp_nccl_cards_cli: masters on {[r['devices'] for r in res]}")
    check(all(r["qkv"] == [whole[0] // 2, whole[1]] for r in res)
          and whole == [3 * MODEL["width"], MODEL["width"]],
          f"tp_nccl_cards_cli: qkv {[r['qkv'] for r in res]}, "
          f"checkpoint {whole}")
    check(len({r["replicated"] for r in res}) == 1
          and all(len(r["losses"]) == 3 and r["losses"] == res[0]["losses"]
                  and all(map(math.isfinite, r["losses"])) for r in res),
          f"tp_nccl_cards_cli: losses {[r['losses'] for r in res]} or "
          "replicated masters differ")
    check(all(r["launches"] == want for r in res),
          f"tp_nccl_cards_cli: launches {[r['launches'] for r in res]}, "
          f"want {want}")
    _ring_ranks(world, "nccl", "ring_nccl_cards")


KERNELS = [
    ("K1", "divided_space_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:47"),
    ("K2", "divided_time_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:178"),
    ("K3", "layernorm_fwd", "cuda", "lavila_tpu_torch/csrc/layernorm_fwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:64"),
    ("K4", "add_layernorm_fwd", "cuda",
     "lavila_tpu_torch/csrc/layernorm_fwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:230"),
    ("K5", "add_layernorm_nosum_fwd", "cuda",
     "lavila_tpu_torch/csrc/layernorm_fwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:261"),
    ("K6", "divided_space_big_fwd", "cuda",
     "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:445"),
    ("K1 bwd", "divided_space_bwd", "cuda",
     "lavila_tpu_torch/csrc/divided_bwd.cu",
     "lavila_tpu/ops/pallas/divided.py:77"),
    ("K2 bwd", "divided_time_bwd", "cuda",
     "lavila_tpu_torch/csrc/divided_bwd.cu",
     "lavila_tpu/ops/pallas/divided.py:207"),
    ("K3 bwd", "layernorm_bwd", "cuda",
     "lavila_tpu_torch/csrc/layernorm_bwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:82"),
    ("K4 bwd", "add_layernorm_bwd", "cuda",
     "lavila_tpu_torch/csrc/layernorm_bwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:243"),
    ("K5 bwd", "add_layernorm_nosum_bwd", "cuda",
     "lavila_tpu_torch/csrc/layernorm_bwd.cu",
     "lavila_tpu/ops/pallas/layernorm.py:273"),
    ("K6 bwd", "divided_space_big_bwd", "cuda",
     "lavila_tpu_torch/csrc/divided_bwd.cu",
     "lavila_tpu/ops/pallas/divided.py:470"),
    ("K9", "decode_attention", "cuda",
     "lavila_tpu_torch/csrc/decode_attention.cu",
     "lavila_tpu/ops/pallas/decode_attention.py:43"),
    ("K7", "flash_attention", "cuda",
     "lavila_tpu_torch/csrc/flash_attention.cu",
     "lavila_tpu/ops/pallas/flash_attention.py:33"),
    ("K8 fwd", "flash_fwd", "cuda", "lavila_tpu_torch/csrc/flash_attention.cu",
     "lavila_tpu/ops/pallas/flash_attention.py:159"),
    # up to 128 tokens (every text tower) the fused kernel does both
    # TPU kernels' work in one launch; past it the split dq and dk/dv
    ("K8 dq", "flash_bwd_fused / flash_bwd_dq", "cuda",
     "lavila_tpu_torch/csrc/flash_attention.cu",
     "lavila_tpu/ops/pallas/flash_attention.py:204"),
    ("K8 dkv", "flash_bwd_fused / flash_bwd_dkv", "cuda",
     "lavila_tpu_torch/csrc/flash_attention.cu",
     "lavila_tpu/ops/pallas/flash_attention.py:242"),
    # no Pallas kernel: the JAX package's CLS row is XLA ops with a VJP
    ("CLS row", "cls_row_fwd", "cuda", "lavila_tpu_torch/csrc/cls_row.cu",
     "none (lavila_tpu/ops/attention.py:_cls_row_attention, XLA)"),
    ("CLS row bwd", "cls_row_bwd", "cuda",
     "lavila_tpu_torch/csrc/cls_row.cu",
     "none (lavila_tpu/ops/attention.py:_cls_row_vjp_bwd, XLA)"),
]

# the phases in order; a path phase returns its run's launch counts
PHASES = (
    ("kernels", phase_kernels),
    ("kernel_bwd", phase_kernels_bwd),
    ("model", lambda: phase_model(MODEL)),
    ("cli", lambda: phase_cli(MODEL)),
    ("train_step", lambda: phase_train_step(
        MODEL, {torch.float32: 4, torch.bfloat16: 4}, (16, 48))),
    ("pretrain_cli", lambda: phase_pretrain_cli(MODEL, 5, 16)),
    ("finetune_step", lambda: phase_finetune_step(MODEL_CUT)),
    ("finetune_cli", lambda: phase_finetune_cli(MODEL)),
    ("ssl_train_step", lambda: phase_train_step(
        MODEL_CUT, {torch.float32: 4, torch.bfloat16: 16}, (16,),
        "ssl_train_step", SEED + 14, kind="ssl")),
    ("ssl_pretrain_cli", lambda: phase_pretrain_cli(
        MODEL, 3, 16, ("--metadata-aux", "synthetic_aux"))),
    ("classify_step", lambda: phase_classify_step(MODEL_CUT)),
    ("classify_cli", lambda: phase_classify_cli(MODEL)),
    ("large224_model", lambda: phase_model(LARGE224)),
    ("large224_train_step", lambda: phase_train_step(
        LARGE224_CUT, {torch.float32: 2, torch.bfloat16: 4}, (8,),
        "large224_train_step", SEED + 11)),
    ("large224_cli", lambda: phase_cli(LARGE224)),
    ("narrator", lambda: phase_narrator(NARRATOR_CUT)),
    ("infer_narrator_cli", lambda: phase_infer_narrator_cli(NARRATOR)),
    ("narrator_train_step",
     lambda: phase_narrator_train_step(NARRATOR_CUT)),
    ("eval_narrator_cli", lambda: phase_eval_narrator_cli(NARRATOR)),
    ("large_model", lambda: phase_model(LARGE)),
    ("large_cli", lambda: phase_cli(LARGE)),
    ("large_train_step", lambda: phase_large_train_step(LARGE_CUT)),
    ("large_pretrain_cli",
     lambda: phase_pretrain_cli(LARGE, 3, 8, ("--use-checkpoint",))),
    ("flagship_narrator", lambda: phase_narrator(FLAGSHIP_CUT)),
    ("flagship_infer_narrator_cli",
     lambda: phase_infer_narrator_cli(FLAGSHIP)),
    ("vclm_pretrain_cli", lambda: phase_vclm_pretrain_cli(FLAGSHIP)),
    ("distilbert_model", lambda: phase_distilbert_model(DISTIL_LARGE)),
    ("hf_model", lambda: phase_distilbert_model(HF_MODEL)),
    ("distilbert_cli", lambda: phase_cli(DISTIL_LARGE)),
    ("distilbert_train_step", lambda: phase_train_step(
        DISTIL_BASE_CUT, {torch.float32: 4, torch.bfloat16: 16}, (16,),
        "distilbert_train_step", SEED + 13)),
    ("distilbert_pretrain_cli",
     lambda: phase_pretrain_cli(DISTIL_BASE, 3, 16)),
    ("vit_model", lambda: (phase_model(VIT_L336), phase_model(VIT_B16))),
    ("vit_train_step", lambda: phase_train_step(
        VIT_B16_CUT, {torch.float32: 2, torch.bfloat16: 8}, (16,),
        "vit_train_step", SEED + 19)),
    ("vit_cli", lambda: phase_cli(VIT_L336)),
    ("vit_narrator", lambda: (
        phase_narrator(VIT_NARRATOR_CUT),
        phase_narrator(VIT_NARRATOR_LARGE, measure=False))),
    ("vit_infer_narrator_cli",
     lambda: phase_infer_narrator_cli(VIT_NARRATOR)),
    ("gated_timesformer", lambda: phase_gated_timesformer(GATED_CUT)),
    ("remat_policies", lambda: phase_remat_policies(LARGE_CUT)),
    ("openai_init", phase_openai_init),
    ("resnet", phase_resnet),
    ("ddp_nccl_world1", phase_ddp_nccl_world1),
    ("ddp_two_ranks", phase_ddp_two_ranks),
    ("ddp_infer_narrator", phase_ddp_infer_narrator),
    ("tp_two_ranks", phase_tp_two_ranks),
    ("tp_narrator", phase_tp_narrator),
    ("ring_two_ranks", phase_ring_two_ranks),
)
PATH_PHASES = ("cli", "pretrain_cli", "finetune_cli", "ssl_pretrain_cli",
               "classify_cli", "large224_cli",
               "infer_narrator_cli", "eval_narrator_cli", "large_cli",
               "large_pretrain_cli", "flagship_infer_narrator_cli",
               "vclm_pretrain_cli", "distilbert_cli",
               "distilbert_pretrain_cli", "vit_cli", "vit_infer_narrator_cli",
               "gated_timesformer", "remat_policies", "openai_init",
               "resnet", "ddp_nccl_world1", "ddp_infer_narrator",
               "tp_two_ranks", "tp_narrator", "ring_two_ranks")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--nccl-ranks", type=int, default=None,
                        help="run only the data- and tensor-parallel "
                             "phases and the ring across this many cards, "
                             "one NCCL rank a card")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if args.nccl_ranks is not None and \
            torch.cuda.device_count() < args.nccl_ranks:
        print(f"chip_smoke: --nccl-ranks {args.nccl_ranks} needs as many "
              f"cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import lavila_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = phase_device()
    build_seconds = phase_build()
    global SSL_CHECKPOINT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    SSL_CHECKPOINT = os.path.join(tmp.name, "ssl_pretrain.pt")
    if args.nccl_ranks is not None:
        return _main_nccl_cards(args.nccl_ranks, device, t_start,
                                build_seconds)
    emit("depth_cuts", what="models cut in depth for the time limit, "
         "widths as published (PERF.md §4)", cuts={
             "TSF-B: ssl_train_step, finetune_step, classify_step, "
             "ddp_two_ranks": MODEL_CUT["cut"],
             "TSF-B + DistilBERT: distilbert_train_step":
                 DISTIL_BASE_CUT["cut"],
             "gated TSF-B: gated_timesformer (not its CLI)":
                 GATED_CUT["cut"],
             "TSF-L@224: large224_train_step": LARGE224_CUT["cut"],
             "TSF-L@336: large_train_step, remat_policies":
                 LARGE_CUT["cut"],
             "ViT-B/16: vit_train_step": VIT_B16_CUT["cut"],
             "TSF-B + GPT-2 XL: narrator, narrator_train_step, "
             "tp_narrator": NARRATOR_CUT["cut"],
             "flagship: flagship_narrator": FLAGSHIP_CUT["cut"],
             "ViT-L/14@336 + GPT-2 XL: vit_narrator":
                 VIT_NARRATOR_CUT["cut"]})
    summary, counts = {}, dict.fromkeys(COUNTERS, 0)
    for name, phase in PHASES:
        t0 = time.perf_counter()
        try:
            out = phase()
        except Exception:  # report every phase, then fail at the end
            traceback.print_exc()
            check(False, f"phase {name} raised")
            continue
        finally:
            torch.cuda.empty_cache()
            emit("phase_done", name=name, seconds=time.perf_counter() - t0)
        if name in ("kernels", "kernel_bwd"):
            summary.update(out)
        elif name in PATH_PHASES:  # each run counted from zero
            for k, v in out.items():
                counts[k] += v
            if name.endswith("infer_narrator_cli") and \
                    "narrator" in summary.get("K3", {}):
                narr = summary["K3"]["narrator"]
                narr["launches"] = narr.get("launches", 0) + out["K3"]
    rows = []
    for key, name, route, source, replaces in KERNELS:
        s = summary.get(key, {})
        sides = [side for side, _ in SIDE_CASES.get(key.removesuffix(" bwd"),
                                                    ()) if side in s]
        launches = counts[key] + (counts[FUSED_INTO[key]]
                                  if key in FUSED_INTO else 0)
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": s.get("max_abs_err"),
               **{k: s.get(k) for k in _SUMMARY_KEYS},
               **{k: s[k] for k in _EXTRA_KEYS if k in s},
               "at": s.get("at"), **{side: s[side] for side in sides}}
        if key in ("K3 bwd", "K4 bwd", "K5 bwd"):
            # one kernel behind all three, its branches counted together
            row["launches_by_branch"] = PATH_LN_BWD
        if key in PATH_BRANCHES:
            by = PATH_BRANCHES[key]
            row["launches_by_branch"] = by
            # the paths run K1, K6, K7 and K8 in bf16 at head_dim 64 (77
            # text tokens): the tensor cores
            check(not any(n for b, n in by.items() if b not in TC_BRANCHES),
                  f"{name}: launches off the tensor cores on the path {by}")
        rows.append(row)
        check(launches > 0, f"{name} never launched on the path")
    ln_bwd = sum(counts[k] for k in ("K3 bwd", "K4 bwd", "K5 bwd"))
    check(sum(PATH_LN_BWD.values()) == ln_bwd,
          f"LayerNorm backward: {ln_bwd} calls on the paths, launches by "
          f"branch {PATH_LN_BWD}")
    emit("recipe_launches_by_branch", run="vclm_pretrain_cli",
         dtype="float32 (the narration from its checkpoint bfloat16)",
         launches_by_branch=RECIPE_BRANCHES)
    emit("total", seconds=time.perf_counter() - t_start,
         build_seconds=build_seconds)
    print(json.dumps({"kernels": rows}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


def _main_nccl_cards(world: int, device: dict, t_start: float,
                     build_seconds: float) -> int:
    """``--nccl-ranks``: :func:`phase_ddp_nccl_cards` and
    :func:`phase_tp_nccl_cards` alone, then the same last line as the
    whole run."""
    for name, phase in (("ddp_nccl_cards", phase_ddp_nccl_cards),
                        ("tp_nccl_cards", phase_tp_nccl_cards)):
        t0 = time.perf_counter()
        try:
            phase(world)
        except Exception:
            traceback.print_exc()
            check(False, f"phase {name} raised")
        finally:
            torch.cuda.empty_cache()
        emit("phase_done", name=name, seconds=time.perf_counter() - t0)
    emit("total", seconds=time.perf_counter() - t_start,
         build_seconds=build_seconds)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
