#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through the
kernels written for Hopper, and check them: the zero-shot dual encoder
(serving), the dual-encoder pretraining step, the EK-100 MIR retrieval
fine-tune and the narrator's sampled decoding, at TSF-B width, with the
TSF-L@224 dual encoder (N = 256: K1's tensor-core kernels) and with the
336px TSF-L towers (the high-resolution dual encoder and LaViLa's
flagship narrator).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (PATH or $CUDA_HOME, default
/usr/local/cuda) and ``triton``; with no CUDA device it exits non-zero
and prints no result. Phases, each printing JSON lines:

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
     LayerNorm at TSF-L@336's and TSF-B's patch rows), K6 (spatial phase
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
     (``scripts/time_library_calls.py``). kernel_bwd: the same for the
     backward kernels (K8's whole backward: the fused kernel up to 128
     tokens, dq then dk/dv past it and in fp32; K1 also at
     TSF-L@224's N = 256, bf16 at batch 8 and fp32 at batch 1; the
     LayerNorm backward, K3/K4/K5 bwd, one CUDA kernel: also on ragged
     rows (6273), one row, CLS rows (8, 1024), the fine-tune's (25088,
     768), D = 1600 and bf16 rows with fp32 γ, each with the branch it
     took), on strided qkv views, errors relative to the reference's
     largest value, and two calls checked bit-identical; K1's and K6's
     with the floor of their tensor-core split (7 products against the
     bound's 5).
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
     ``total.pkl``.
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

Every path phase (5, 7, finetune_cli, large224_cli, 9, 10-13, 15, 16's
CLI) zeroes
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
forward and the fused backward only, which the bf16 encodes and steps
check too). The text tower runs K7 under inference_mode (serving) and
K8's forward and backward (one fused launch a layer in bf16) in every
train step.
TF32 is off for matmuls and cuDNN convolutions, so fp32 comparisons are
fp32. Any failed check exits non-zero without the final line; the final
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import subprocess
import sys
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
            "depth": 12, "space": "K1"}
FLAGSHIP = {"name": "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL",
            "layers": 48, "cross": 16, "bos": 50256, "eos": 50256,
            "img": 336, "depth": 24, "space": "K6"}
# the least time the card could take: bytes over HBM3's 3.35 TB/s, or
# operations over the dense peak of their type (bf16 tensor cores, fp32
# outside them); NVIDIA's H100 SXM data sheet, at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    with mock.patch("lavila_tpu_torch.ops.attention.divided_phase",
                    KD.divided_phase_reference), \
            mock.patch("lavila_tpu_torch.ops.attention.flash_attention",
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
            "K8 dq": ("flash", "flash_dq"), "K8 dkv": ("flash", "flash_dkv")}
# K8's backward kernels: the fused one ("K8 bwd") does the work of the
# TPU's dq and dk/dv kernels up to 128 tokens; their rows sum it in
FUSED_INTO = {"K8 dq": "K8 bwd", "K8 dkv": "K8 bwd"}


def _counter(module: str) -> dict:
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    return {"divided": KD, "layernorm": KL, "decode": KDec,
            "flash": KF}[module].launches


BRANCHES = ("tc", "simt")
# the flash kernels' counters by branch (kernels/flash.py:flash_branch)
FLASH_BRANCHES = {"flash": BRANCHES, "flash_fwd": BRANCHES,
                  "flash_bwd": ("fused",), "flash_dq": ("split", "simt"),
                  "flash_dkv": ("split", "simt")}
# the branches a bf16 path at head_dim 64 may take: the tensor cores
TC_BRANCHES = ("tc", "fused")
# K1's, K2's, K6's, K7's and K8's launches on the path runs by branch,
# filled by path_counts()
PATH_BRANCHES = {k: dict.fromkeys(BRANCHES, 0)
                 for k in ("K1", "K1 bwd", "K2", "K2 bwd", "K6", "K6 bwd",
                           "K7", "K8 fwd")}
PATH_BRANCHES.update({k: dict.fromkeys(("fused", "split", "simt"), 0)
                      for k in ("K8 dq", "K8 dkv")})


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


def path_counts() -> dict:
    """:func:`launch_counts` at the end of a path run, whose K1, K2, K6,
    K7 and K8 launches by branch are added to PATH_BRANCHES (K8 dq's and
    dkv's with the fused kernel's)."""
    for name, by in PATH_BRANCHES.items():
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
    for m in ("divided", "layernorm", "decode", "flash"):
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


def _ln_pre(m) -> int:
    """1 where tower ``m`` has ``ln_pre`` (every tower but the CLIP_HF
    one's), else 0."""
    return int(m.get("ln_pre", True))


def _ln_bwd_block_calls(m, batch: int, dtype) -> int:
    """LayerNorm backward calls of one train step of dual encoder ``m``
    at ``batch`` clips whose rows one block's rings hold at once: the CLS
    rows' (norm3, norm1, norm2 a block, ln_pre's CLS half and the final
    norm), where ``batch`` rows fit; the patches', the text tower's (77
    rows a caption) and K4's/K5's take the grid."""
    from lavila_tpu_torch.kernels import layernorm as KL
    plan = KL.bwd_shape(m["width"], torch.empty((), dtype=dtype)
                        .element_size(), 2)
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
    half), K5 (norm1) and K4 (norm2) on the patch half; ln_pre on both
    halves (where the tower has it) and the final norm."""
    depth = m["depth"]
    want = dict.fromkeys(COUNTERS, 0)
    want.update({m["space"]: depth, "K2": depth,
                 "K3": 4 * depth + 1 + 2 * _ln_pre(m), "K4": depth,
                 "K5": depth})
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
                   dtype=torch.bfloat16) -> dict:
    """Kernel launches of one train step of dual encoder ``m`` in
    ``dtype``: the encode's, the text tower's LayerNorms (ln_1, ln_2 per
    block, ln_final) and causal attention (K8's forward), and one
    backward each (K8's: one fused launch a layer in bf16, dq and dk/dv
    in fp32), except that the tower returns only the CLS row, so the last
    block's patch outputs never reach the loss: autograd runs no backward
    for its spatial phase or its K4. With remat every video block runs
    its forward again in the backward (the text tower has no remat).
    DistilBERT's norms run K3 and K5 forward and backward, its attention
    no kernel."""
    depth = m["depth"]
    want = _encode_launches(m)
    text = _text_launches(m)
    r = 2 if remat else 1
    blocks = {k: v * r for k, v in want.items()}
    # ln_pre and the final norm run once, outside the blocks
    blocks["K3"] = want["K3"] + 4 * depth * (r - 1) + text["K3"]
    blocks["K5"] += text["K5"]
    blocks.update({f"{m['space']} bwd": depth - 1, "K2 bwd": depth,
                   "K3 bwd": want["K3"] + text["K3"], "K4 bwd": depth - 1,
                   "K5 bwd": depth + text["K5"]})
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


def phase_build() -> None:
    from lavila_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    ptxas = [ln for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds, so=build.library_path().name,
         ptxas=ptxas)


def _keys(axis, F, N) -> int:
    return N + 1 if axis == "space" else F + 1


def _phase_extras(args, run, library_call, out=None, do=None) -> dict:
    """For a divided-phase case, K1's, K2's or K6's (``args`` the
    forward's): the branch it took (with ``do`` and ``out`` the
    backward's), and the profiler's device time of ``run`` and of the
    library call on the same input (``scripts/time_spatial_phase.py``),
    beside their event times."""
    from lavila_tpu_torch.kernels import divided as KD
    q, k, v, ck, cv, axis, H, _ = args
    ts = spatial()
    return {"branch": KD.phase_branch(q, k, v, ck, cv, axis, H, do, out),
            "device_ms": ts.measure(run, 20)["device_ms"],
            "library_device_ms": ts.measure(library_call, 20)["device_ms"]}


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


def _ln_case(shape, dtype, gen, bias: bool = True, bert: bool = False
             ) -> dict:
    """One K3 case; ``bias=False`` hands the kernel a zero bias, as
    ``BiasFreeLayerNorm`` (the pooler's norms) does; ``bert``:
    DistilBERT's eps and flat rows (:func:`_flat_rows`)."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    eps = _flat_rows(x) if bert else 1e-6
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    b = (0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    if not bias:
        b = torch.zeros_like(b)
    y = KL.layer_norm(x, w, b, eps)
    ref = KL.layer_norm_reference(x.float(), w.float(), b.float(), eps)
    torch.cuda.synchronize()
    err, tol = max_err(y, ref), TOL[dtype]
    lib = library().layer_norm_call(x, w, b, eps)
    extras = _device_extras(lambda: KL.layer_norm(x, w, b, eps), lib,
                            dtype) if bert else {}
    # ~8 fp32 operations per element (statistics, normalise, scale, shift)
    return {"out_err": err, "tol": tol, "ok": err <= tol, **extras,
            "ms": time_ms(lambda: KL.layer_norm(x, w, b, eps)),
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
    got = KL.add_layer_norm(*args)
    ref = KL.add_layer_norm_reference(*(t.float() for t in args[:4]),
                                      *args[4:])
    torch.cuda.synchronize()
    got, ref = (got, ref) if return_sum else ((got,), (ref,))
    err, tol = max(map(max_err, got, ref)), TOL[dtype]
    lib = library().add_layer_norm_call(*args)
    extras = _device_extras(lambda: KL.add_layer_norm(*args), lib,
                            dtype) if bert else {}
    # reads a, b, w, bias; writes y (and the sum); ~9 fp32 operations
    # per element (the add, statistics, normalise, scale, shift)
    return {"out_err": err, "tol": tol, "ok": err <= tol, **extras,
            "ms": time_ms(lambda: KL.add_layer_norm(*args)),
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
    return {"out_err": err, "tol": tol, "v_new_exact": exact,
            "ok": err <= tol and exact,
            "ms": time_ms(lambda: KDec.decode_attention(*args)),
            "plain_ms": time_ms(
                lambda: KDec.decode_attention_reference(*args)),
            **bound((2 * B * nv * D + 4 * B * D) * it, 4 * B * (nv + 1) * D,
                    dtype),
            "library_ms": time_ms(library().decode_call(*args))}


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
    their event times: these calls (K7, K8, DistilBERT's LayerNorms) are
    short, and their event times carry the wrapper's host cost."""
    if dtype != torch.bfloat16:
        return {}
    ts = spatial()
    return {"device_ms": ts.measure(run, 20)["device_ms"],
            "library_device_ms": ts.measure(library_call, 20)["device_ms"]}


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
    ref, ref_lse = KF.flash_fwd_reference(q.float(), k.float(), v.float(),
                                          causal)
    torch.cuda.synchronize()
    out, lse = got if with_lse else (got, None)
    err = max_err(out, ref)
    lse_err = max_err(lse, ref_lse) if with_lse else 0.0
    tol = TOL[dtype]
    it, D = q.element_size(), H * d
    lib = library().flash_fwd_call(q, k, v, causal)
    want = "tc" if dtype == torch.bfloat16 else "simt"
    # reads q, k, v; writes out (and lse); QKᵀ and PV over the pairs
    return {"out_err": err, "lse_err": lse_err, "tol": tol, "branch": branch,
            "ok": err <= tol and lse_err <= tol and branch == want,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(lambda: (
                KF.flash_fwd_reference if with_lse
                else KF.flash_attention_reference)(q, k, v, causal)),
            **bound((2 * B * Lq * D + 2 * B * Lk * D) * it
                    + (B * Lq * H * 4 if with_lse else 0),
                    4 * B * H * _pairs(Lq, Lk, causal) * d, dtype),
            "library_ms": time_ms(lib)}


def _flash_bwd_case(B, H, Lq, Lk, d, causal, dtype, gen) -> dict:
    """K8's whole backward on the forward kernel's out and lse against
    the plain backward in fp32 on the same values (errors relative to the
    reference's largest value), bit-identical over two calls, with the
    branch it took: in bf16 the fused kernel up to 128 tokens (one
    launch), the split past it (dq, then dk/dv); in fp32 the SIMT dq and
    dk/dv. Times are the whole backward's, the library call's (SDPA's by
    autograd) and the plain version's too."""
    from lavila_tpu_torch.kernels import flash as KF
    q, k, v = _flash_qkv(B, H, Lq, Lk, d, dtype, gen)
    scale = d ** -0.5
    out, lse = KF._forward(q, k, v, causal, scale, with_lse=True)
    do = torch.randn(B, Lq, H, d, generator=gen, device=DEVICE).to(dtype)
    args = (q, k, v, do, out, lse, causal, scale)
    branch = KF.flash_branch(q, k, v, do, out)
    got = KF.flash_bwd(*args)
    again = KF.flash_bwd(*args)
    ref = KF.flash_bwd_reference(*(t.float() for t in args[:5]), lse,
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
    # reads q, k, v, do, out, lse; writes dq, dk, dv; five products (S,
    # dP, dV, dQ, dK) over the pairs the mask lets through
    return {"rel_err": errs, "abs_err_dq": max_err(got[0], ref[0]),
            "abs_err_dkv": max(max_err(got[1], ref[1]),
                               max_err(got[2], ref[2])),
            "tol": tol, "deterministic": deterministic, "branch": branch,
            "ok": max(errs.values()) <= tol and deterministic
            and branch == want,
            **_device_extras(run, lib, dtype), "ms": time_ms(run),
            "plain_ms": time_ms(lambda: KF.flash_bwd_reference(*args)),
            **bound((4 * B * Lq * D + 4 * B * Lk * D) * it + B * Lq * H * 4,
                    10 * B * H * _pairs(Lq, Lk, causal) * d, dtype),
            "library_ms": time_ms(lib)}


# the main-path case of each kernel, whose numbers go into the summary:
# TSF-B at batch 8 for K1/K2/K3, TSF-L@336 at batch 8 for K4/K5/K6
MAIN_CASE = {"K1": (8, 4, 196, 768, 12), "K2": (8, 4, 196, 768, 12),
             "K3": (8 * 4 * 196, 768), "K4": (8 * 4 * 576, 1024),
             "K5": (8 * 4 * 576, 1024), "K6": (8, 4, 576, 1024, 16),
             "K9": (160, 77, 1600, 25, 15),
             # TSF-B's text tower at 16 captions (B, H, Lq, Lk, d); K8 dq
             # and dkv: the fused backward there
             **dict.fromkeys(("K7", "K8 fwd", "K8 dq", "K8 dkv"),
                             (16, 8, 77, 77, 64))}
# further cases a kernel's summary keeps under a name: K3 on the
# narrator's decode path (one decode step's 160 GPT-2 XL rows), K1 at
# TSF-L@224 (N = 256) and at TSF-B's serving batch 32, K6 at the
# TSF-L@336 remat step's batch 32, K2 at the fine-tune's 16 frames and
# at TSF-L@336
SIDE_CASES = {"K3": (("narrator", (160, 1, 1600)),
                     ("finetune", (8 * 16 * 196, 768)), ("cls", (8, 1024)),
                     ("text", (8, 77, 512)), ("distilbert", BERT_ROWS)),
              "K5": (("distilbert", BERT_ROWS),),
              "K1": (("tsf_l_224", (8, 4, 256, 1024, 16)),
                     ("b32", (32, 4, 196, 768, 12))),
              "K6": (("b32", (32, 4, 576, 1024, 16)),),
              "K2": (("f16", (8, 16, 196, 768, 12)),
                     ("tsf_l_336", (8, 4, 576, 1024, 16))),
              **dict.fromkeys(("K7", "K8 fwd"),
                              (("b256", (256, 8, 77, 77, 64)),)),
              # K8's backward at 256 captions (fused) and past 128 tokens
              # (the split dq and dk/dv)
              **dict.fromkeys(("K8 dq", "K8 dkv"),
                              (("b256", (256, 8, 77, 77, 64)),
                               ("split", (4, 8, 130, 260, 64))))}
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
                  # the narrator's: a decode step's GPT-2 XL norms (D =
                  # 1600 masked to a 2048 block), the pooler's bias-free
                  # norms on 16 clips' 256 queries
                  ("K3", "ln", (160, 1, 1600), dtype),
                  ("K3", "ln_nobias", (16 * 256, 1600), dtype),
                  # DistilBERT's emb_layer_norm and residual norms
                  ("K3", "ln_bert", BERT_ROWS, dtype),
                  ("K5", "add_ln_nosum_bert", BERT_ROWS, dtype)]
        cases += [(k, kind, shape, dtype)
                  for k, kind in (("K4", "add_ln"), ("K5", "add_ln_nosum"))
                  for shape in ((8 * 4 * 576, 1024), (32 * 4 * 196, 768))]
        # K9: the narrator's 160 rows of GPT-2 XL, and TSF-B width
        cases += [("K9", "decode", (B, 77, D, H, nv), dtype)
                  for B, D, H in ((160, 1600, 25), (16, 768, 12))
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
                  for kind, shape in FLASH_CASES]
    cases += [(k, "causal", (256, 8, 77, 77, 64), bf16)
              for k in ("K7", "K8 fwd")]
    summary = {}
    with torch.inference_mode():
        for name, kind, shape, dtype in cases:
            if kind.startswith("add_ln"):
                res = _add_ln_case(shape, dtype, gen, kind == "add_ln",
                                   kind.endswith("_bert"))
            elif kind.startswith("ln"):
                res = _ln_case(shape, dtype, gen, kind != "ln_nobias",
                               kind.endswith("_bert"))
            elif kind == "decode":
                res = _decode_case(*shape, dtype, gen)
            elif kind in ("causal", "full"):
                res = _flash_case(name, *shape, kind == "causal", dtype, gen)
            else:
                res = _phase_case(kind, *shape[:3], shape[3], shape[4],
                                  dtype, gen)
            emit("kernel", kernel=name, case=kind, shape=list(shape),
                 dtype=dname(dtype), **res)
            check(res["ok"], f"{name} {kind} {shape} {dtype}: error "
                  f"{res['out_err']} (lse {res.get('lse_err')}) > "
                  f"{res['tol']} or branch {res.get('branch')}")
            _summarise(summary, name, shape, dtype, res,
                       ("out_err", "lse_err"))
            torch.cuda.empty_cache()
    return summary


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
    kernels (7 products against 5)."""
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
                           lambda: KD.divided_phase_bwd(*args), lib, out, do)
    if axis == "space":
        extras["split_floor_ms"] = (14 * rows * _keys(axis, F, N) * D
                                    / PEAK_FLOPS[dtype] * 1e3)
    # reads q, k, v, do, out, ck, cv, lse; writes dq, dk, dv, dck, dcv;
    # five products (S, dP, dV, dQ, dK) of 2 operations per term
    return {"rel_err": errs, "abs_err": abs_err, "tol": tol,
            "deterministic": deterministic,
            "ok": max(errs.values()) <= tol and deterministic
            and _branch_ok(extras["branch"], dtype, D // H), **extras,
            "ms": time_ms(lambda: KD.divided_phase_bwd(*args)),
            "plain_ms": time_ms(
                lambda: KD.divided_phase_bwd_reference(*args)),
            **bound((8 * rows * D + 4 * B * D) * it + rows * H * 4,
                    10 * rows * _keys(axis, F, N) * D, dtype),
            "library_ms": time_ms(lib)}


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
    step's fp32 γ); ``bert`` as :func:`_ln_case`."""
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
                            dtype) if bert else {}
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
    summary = {}
    flash = [(kind, shape, dtype) for dtype in (torch.float32, torch.bfloat16)
             for kind, shape in FLASH_CASES]
    flash.append(("causal", (256, 8, 77, 77, 64), torch.bfloat16))
    for kind, shape, dtype in flash:
        with torch.no_grad():
            res = _flash_bwd_case(*shape, kind == "causal", dtype, gen)
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
    for name, kind, shape, dtype in cases:
        # "+f32w": fp32 γ beside the rows' dtype
        wdtype = torch.float32 if kind.endswith("+f32w") else None
        with torch.no_grad():
            bert = kind.endswith("_bert")
            if kind.startswith("add_ln"):
                res = _add_ln_bwd_case(shape, dtype, gen,
                                       kind.startswith("add_ln+")
                                       or kind == "add_ln", wdtype, bert)
            elif kind.startswith("ln"):
                res = _ln_bwd_case(shape, dtype, gen, wdtype, bert)
            else:
                res = _phase_bwd_case(kind, *shape[:3], shape[3], shape[4],
                                      dtype, gen)
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
    return summary


def _clip_model(m, **kw):
    """Dual encoder ``m`` initialised on the card from a seeded generator,
    its time attention given seeded noise."""
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = build_model(m["name"], device=DEVICE, generator=gen, **kw)
    with torch.no_grad():
        for blk in model.visual.blocks:
            for lin in (blk.timeattn.qkv, blk.timeattn.proj):
                lin.weight.normal_(0.0, lin.in_features ** -0.5,
                                   generator=gen)
                lin.bias.normal_(0.0, 0.02, generator=gen)
    return model


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


def phase_model(m) -> None:
    """Dual encoder ``m``: embeddings on the kernel path against the plain
    path on the same weights (fp32, then bf16), launches per call, then
    encode_image clips/s."""
    from lavila_tpu_torch.models.dual_encoder import l2_normalize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    frames, text = _inputs(4, gen, m["img"])
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
        emit("model", model=m["name"], dtype=dname(dtype), batch=4,
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


def phase_cli(m) -> dict:
    """The port CLI's functions on the synthetic dataset. Returns the
    launch counts of this run, the serving path's."""
    import numpy as np

    from lavila_tpu_torch.data import transforms as T
    from lavila_tpu_torch.data.datasets import (DatasetConfig,
                                                VideoCaptionDataset)
    from lavila_tpu_torch.data.loader import DataLoader
    from lavila_tpu_torch.eval import metrics as M
    from lavila_tpu_torch.cli import eval_zeroshot as cli

    args = cli.get_args_parser().parse_args(
        ["--model", m["name"], "--bf16", "--device",
         DEVICE, "--clip-length", "4", "--batch-size", "8", "--workers",
         "4"])
    t0 = time.perf_counter()
    with bert_vocab() if _bert(m) else nullcontext():
        model, tokenizer, name = cli.load_model_from_checkpoint(args)
    load_seconds = time.perf_counter() - t0
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


def _make_state(model, dtype, seed: int = SEED + 8, frozen=None):
    """A TrainState with the CLI's default AdamW recipe (warm-up from
    1e-6 over 100-step epochs); drop-path masks from a seeded generator;
    the parameters that ``frozen`` names left out of the optimizer."""
    from lavila_tpu_torch.train.freeze import freeze_by_predicate
    from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from lavila_tpu_torch.train.step import TrainState
    schedule = cosine_schedule(3e-5, 1e-5, 5, 100, warmup_epochs=1,
                               start_warmup_lr=1e-6)
    return TrainState.create(
        model, lambda params: make_optimizer(
            freeze_by_predicate(params, frozen or (lambda n: False)),
            schedule), dtype=dtype,
        generator=torch.Generator(device=DEVICE).manual_seed(seed))


def _train_batch(B, gen, size: int = 224, frames: int = 4,
                 bert: bool = False):
    """A batch of ``B`` clips; ``bert``: DistilBERT captions and their
    masks (:func:`_bert_text`)."""
    frames, text = _inputs(B, gen, size, frames)
    # the EK-100 relevancy of each clip, for the adaptive margin
    rel = torch.rand(B, generator=gen, device=DEVICE)
    batch = {"frames": frames, "text": text, "relevancy": rel}
    if bert:
        batch["text"], batch["mask"] = _bert_text(B, gen)
    return batch


def _run_steps(m, base, dtype, batch, plain: bool, steps: int = 2,
               retrieval: bool = False):
    """``steps`` train steps from a copy of ``base`` (dual encoder
    ``m``; pretraining's, or with ``retrieval`` the fine-tune's: adaptive
    max-margin, logit_scale frozen): the losses, each step's fp32
    gradients and the launch counts of each step; on the kernels every
    step's LayerNorm backward is checked by branch, and the first step's
    launches of its kernel on the device (traced) one a call."""
    from lavila_tpu_torch.train.freeze import logit_scale_only
    from lavila_tpu_torch.train.step import (make_clip_train_step,
                                             make_retrieval_train_step)
    state = _make_state(copy.deepcopy(base).train(), dtype,
                        frozen=logit_scale_only if retrieval else None)
    # normalised embeddings (--norm-embed) keep the logits within
    # ±logit_scale; raw random-init embeddings give logits in the
    # hundreds, where bf16 rounding alone moves the loss by percents
    step_fn = (make_retrieval_train_step(norm_embed=True) if retrieval
               else make_clip_train_step(norm_embed=True))
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
            if dtype == torch.bfloat16 and not plain and not _bert(m):
                check_flash_tc(f"bf16 train step {len(counts)}")
                check_tensor_cores(f"bf16 train step {len(counts)}", "K2",
                                   "K2 bwd")
            losses.append(metrics["loss"].item())
            grads.append({k: p.grad.clone() for k, p in state.params.items()})
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
    worst = {"matrices": (1.0, None), "embeddings": (1.0, None)}
    for step, (ag, bg) in enumerate(zip(a_grads, b_grads)):
        for name, g in bg.items():
            x = ag[name]
            if name.endswith(ZERO_GRAD):
                zero_grad = max(zero_grad, g.abs().max().item(),
                                x.abs().max().item())
                continue
            scale = g.abs().max().item()
            if scale > 0:
                worst_err = max(worst_err, max_err(x, g) / scale)
            if g.dim() >= 2 and scale > 0:
                cos = torch.nn.functional.cosine_similarity(
                    x.flatten(), g.flatten(), dim=0).item()
                kind = "embeddings" if g.dim() == 3 else "matrices"
                if cos < worst[kind][0]:
                    worst[kind] = (cos, f"step {step}: {name}")
    return {"loss_rel_err": rel_loss, "grad_rel_err_max": worst_err,
            "grad_cos_min": worst["matrices"][0],
            "grad_cos_min_at": worst["matrices"][1],
            "embed_grad_cos_min": worst["embeddings"][0],
            "embed_grad_cos_min_at": worst["embeddings"][1],
            "zero_grad_max": zero_grad}


def phase_train_step(m, batches: dict, throughput: tuple,
                     phase: str = "train_step", seed: int = SEED + 3) -> None:
    """The train step of dual encoder ``m`` at full depth, kernel path
    against the plain path from the same weights and batch (``batches``:
    the batch size of each dtype, one batch drawn per size); then train
    clips/s at the ``throughput`` batch sizes."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    base = _clip_model(m)
    data = {}
    for dtype, size in batches.items():
        if size not in data:
            data[size] = _train_batch(size, gen, m["img"], bert=_bert(m))
        batch = data[size]
        k_run = _run_steps(m, base, dtype, batch, False)
        p_run = _run_steps(m, base, dtype, batch, True)
        res = _compare_steps(k_run, p_run)
        name = f"{m['name']} {dname(dtype)}"
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
    _train_throughput(base, gen, m, throughput)


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


def _train_throughput(base, gen, m, batches, iters: int = 10) -> None:
    """Train clips/s and peak memory, bf16, kernel and plain path in
    alternating order, at each of ``batches``: for TSF-B 16 (bench.py's
    TSF-B batch), where the host's issue time bounds the step, and 48,
    where the device does; for TSF-L@224 8; for TSF-B + DistilBERT 16,
    with the kernel path's step profiled (device busy time, idle
    share)."""
    from lavila_tpu_torch.train.step import make_clip_train_step
    state = _make_state(base.train(), torch.bfloat16)
    step_fn = make_clip_train_step()
    for batch in batches:
        data = _train_batch(batch, gen, m["img"], bert=_bert(m))
        rates, peaks = {}, {}
        for path in ("kernels", "plain", "plain", "kernels"):
            with plain_path() if path == "plain" else nullcontext():
                rate, peak = _time_steps(state, step_fn, data, iters)
            rates.setdefault(path, []).append(rate)
            peaks.setdefault(path, []).append(peak)
        emit("train_throughput", what="train step clips/s",
             model=m["name"], dtype="bfloat16", batch=batch, frames=4,
             iters=iters, remat=False, order="kernels, plain, plain, "
             "kernels", clips_per_s=rates, peak_memory_gib=peaks)
        if _bert(m):
            emit("train_profile", model=m["name"], dtype="bfloat16",
                 batch=batch, **_profile(lambda: step_fn(state, data)))
        del data


def phase_large_train_step() -> None:
    """TSF-L@336's train step: kernels against plain (fp32, batch 2),
    remat against no remat with drop-path 0.1 (fp32, batch 2, both on the
    kernels), then bf16 clips/s and peak memory with and without remat."""
    from lavila_tpu_torch.train.step import make_clip_train_step
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    batch = _train_batch(2, gen, LARGE["img"])
    fp32 = torch.float32
    base = _clip_model(LARGE)
    k_run = _run_steps(LARGE, base, fp32, batch, False)
    p_run = _run_steps(LARGE, base, fp32, batch, True)
    res = _compare_steps(k_run, p_run)
    emit("large_train_step", model=LARGE["name"], dtype="float32", batch=2,
         steps=2, what="kernels vs plain", loss_kernels=k_run[0],
         loss_plain=p_run[0], launches_per_step=k_run[2], **res)
    check(all(math.isfinite(x) for x in k_run[0] + p_run[0])
          and res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"TSF-L@336 train step fp32 kernels vs plain: {res}")
    want = _step_launches(LARGE, dtype=fp32)
    check(all(c == want for c in k_run[2]),
          f"TSF-L@336 train step launches {k_run[2]}, want {want}")
    del k_run, p_run

    # remat: the same weights, drop-path 0.1, masks from one seeded
    # generator (the TrainState's), remat off against on
    runs = {}
    for remat in (False, True):
        model = _clip_model(LARGE, drop_path_rate=0.1, remat=remat)
        model.load_state_dict(base.state_dict())
        runs[remat] = _run_steps(LARGE, model, fp32, batch, False)
        del model
    res = _compare_steps(runs[True], runs[False])
    emit("large_train_step", model=LARGE["name"], dtype="float32", batch=2,
         steps=2, what="remat vs no remat, drop_path_rate 0.1",
         loss_remat=runs[True][0], loss_no_remat=runs[False][0],
         launches_per_step_remat=runs[True][2], **res)
    check(res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"TSF-L@336 train step remat vs no remat: {res}")
    want = _step_launches(LARGE, remat=True, dtype=fp32)
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
    data = _train_batch(8, gen, LARGE["img"])
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
            check_ln_bwd(f"TSF-L@336 bf16 step ({key})", LARGE, 8, 7)
        rates.setdefault(key, []).append(rate)
        peaks.setdefault(key, []).append(peak)
    emit("train_throughput", what="train step clips/s", model=LARGE["name"],
         dtype="bfloat16", batch=8, frames=4, iters=5,
         order="kernels, kernels+remat, plain+remat, plain+remat, "
         "kernels+remat, kernels", clips_per_s=rates, peak_memory_gib=peaks)
    del data
    state.model.visual.remat = True
    for batch_size in (32, 16):
        data = _train_batch(batch_size, gen, LARGE["img"])
        try:
            rate, peak = _time_steps(state, step_fn, data, 5)
        except torch.cuda.OutOfMemoryError:
            emit("train_throughput", model=LARGE["name"], remat=True,
                 batch=batch_size, out_of_memory=True)
            del data
            torch.cuda.empty_cache()
            continue
        emit("train_throughput", what="train step clips/s",
             model=LARGE["name"], dtype="bfloat16", batch=batch_size,
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
        args = ez.get_args_parser().parse_args(
            ["--checkpoint", os.path.join(out, "checkpoint_latest.pt"),
             "--device", DEVICE, "--bf16"])
        with bert_vocab() if _bert(m) else nullcontext():
            model, _, name = ez.load_model_from_checkpoint(args)
    same = all(torch.equal(p, state.params[k].to(p.dtype))
               for k, p in model.named_parameters())
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


def phase_finetune_step() -> None:
    """The retrieval fine-tune's step on BASE at 16 frames (adaptive
    max-margin with relevancy weights, logit_scale frozen): 2 fp32 steps,
    kernel path against plain path from the same weights and batch, held
    to the pretraining step's limits; then bf16 clips/s and peak memory
    at batch 8, kernels/plain/plain/kernels."""
    from lavila_tpu_torch.train.freeze import logit_scale_only
    from lavila_tpu_torch.train.step import make_retrieval_train_step
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    base = _clip_model(MODEL, num_frames=16)
    batch = _train_batch(4, gen, MODEL["img"], 16)
    k_run = _run_steps(MODEL, base, torch.float32, batch, False,
                       retrieval=True)
    p_run = _run_steps(MODEL, base, torch.float32, batch, True,
                       retrieval=True)
    res = _compare_steps(k_run, p_run)
    emit("finetune_step", model=MODEL["name"], dtype="float32", batch=4,
         frames=16, steps=2, loss="adaptive_max_margin",
         loss_kernels=k_run[0], loss_plain=p_run[0],
         launches_per_step=k_run[2], **res)
    check(all(math.isfinite(x) for x in k_run[0] + p_run[0])
          and res["loss_rel_err"] <= 1e-5 and res["grad_rel_err_max"] <= 1e-4,
          f"fine-tune step fp32 kernels vs plain: {res}")
    want = _step_launches(MODEL, dtype=torch.float32)
    check(all(c == want for c in k_run[2]),
          f"fine-tune step launches {k_run[2]}, want {want}")
    del k_run, p_run
    state = _make_state(base.train(), torch.bfloat16, frozen=logit_scale_only)
    step_fn = make_retrieval_train_step(norm_embed=True)
    data = _train_batch(8, gen, MODEL["img"], 16)
    rates, peaks = {}, {}
    for path in ("kernels", "plain", "plain", "kernels"):
        reset_launch_counts()
        with plain_path() if path == "plain" else nullcontext():
            rate, peak = _time_steps(state, step_fn, data, 5)
        if path == "kernels":  # K2 over 16 frames on the tensor cores
            check_tensor_cores("fine-tune bf16 step", "K2", "K2 bwd")
            check_ln_bwd("fine-tune bf16 step", MODEL, 8, 7)
        rates.setdefault(path, []).append(rate)
        peaks.setdefault(path, []).append(peak)
    emit("train_throughput", what="retrieval fine-tune step clips/s",
         model=MODEL["name"], dtype="bfloat16", batch=8, frames=16, iters=5,
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


def _narrator_model(n):
    """Narrator ``n`` (fp32) initialised on the card from a seeded
    generator, its cross-attention gates and its time attention given
    seeded non-zero values (zero gates would make the cross-attention
    check vacuous, as zero time attention would K2's). Returns it and the
    init's seconds."""
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    model = build_model(n["name"], device=DEVICE, generator=gen,
                        gated_xattn=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        for blk in model.text_decoder.transformer.h:
            if blk.has_cross:
                for a in (blk.alpha_cattn, blk.alpha_dense):
                    a.uniform_(0.3, 0.9, generator=gen)
        for blk in model.visual.blocks:
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
                       dtype=tokens.dtype, device=DEVICE)
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


def _cos_min(a, b) -> float:
    """The smallest cosine between matching rows (last axis)."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def phase_narrator(n) -> None:
    """Narrator ``n``, kernel path against plain path on the same weights
    (fp32, then bf16), a profile of decode steps and narrations/s."""
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
            if dtype == torch.bfloat16:
                check_tensor_cores(f"narrator {n['name']} bf16 "
                                   "encode_image", n["space"], "K2")
            cached, per_step = _cached_logits(model, tokens, text, 8)
            ids, ppl = _greedy(model, tokens, n, L)
            with plain_path():
                tokens_ref = model.encode_image(frames)
                full = model.text_decoder(text, encoder_states=tokens_ref)
                cached_ref, _ = _cached_logits(model, tokens_ref, text, 8)
                ids_ref, ppl_ref = _greedy(model, tokens_ref, n, L)
        name = dname(dtype)
        res = {"logits_err": max_err(cached, full),
               "plain_cached_err": max_err(cached_ref, full),
               "logits_cos_min": _cos_min(cached, full),
               "image_tokens_err": max_err(tokens, tokens_ref),
               "ids_equal": bool(torch.equal(ids, ids_ref)),
               "ids_agree_steps": int((ids == ids_ref).all(0).long()
                                      .cumprod(0).sum()) - 1,
               "ppl_rel_err": ((ppl - ppl_ref).abs() / ppl_ref).max().item(),
               "finite": bool(torch.isfinite(cached).all()
                              and torch.isfinite(ppl).all())}
        emit("narrator", model=n["name"], dtype=name, clips=2,
             return_sequences=2, init_seconds=init_s,
             launches_per_encode_image=per_image,
             launches_per_decode_step=per_step, ids=ids.tolist(),
             ids_plain=ids_ref.tolist(), **res)
        check(res["finite"] and tokens.shape == (2, 256, 1600),
              f"narrator {n['name']} {name}: non-finite or misshapen "
              "outputs")
        want_step = dict.fromkeys(COUNTERS, 0)
        want_step.update({"K9": n["layers"],
                          "K3": 2 * (n["layers"] + n["cross"]) + 1})
        check(per_step == want_step,
              f"narrator {n['name']} {name}: launches per decode step "
              f"{per_step}")
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
                  and res["ppl_rel_err"] <= 1e-4,
                  f"narrator {n['name']} fp32 kernels vs plain: {res}")
        else:
            check(res["logits_cos_min"] >= 0.99
                  and res["ids_agree_steps"] >= 4,
                  f"narrator {n['name']} bf16 kernels vs plain: {res}")
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
                  for k in ("K1", "K2", "K4", "K5", "K6"))
          and counts["K3"] >= steps * (2 * (layers + n["cross"]) + 1),
          f"infer CLI {n['name']} launches {counts}")
    return counts


KERNELS = [
    ("K1", "divided_space_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:47"),
    ("K2", "divided_time_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:178"),
    ("K3", "layernorm_fwd", "triton", "lavila_tpu_torch/kernels/layernorm.py",
     "lavila_tpu/ops/pallas/layernorm.py:64"),
    ("K4", "add_layernorm_fwd", "triton",
     "lavila_tpu_torch/kernels/layernorm.py",
     "lavila_tpu/ops/pallas/layernorm.py:230"),
    ("K5", "add_layernorm_nosum_fwd", "triton",
     "lavila_tpu_torch/kernels/layernorm.py",
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
    ("finetune_step", phase_finetune_step),
    ("finetune_cli", lambda: phase_finetune_cli(MODEL)),
    ("large224_model", lambda: phase_model(LARGE224)),
    ("large224_train_step", lambda: phase_train_step(
        LARGE224, {torch.float32: 2, torch.bfloat16: 4}, (8,),
        "large224_train_step", SEED + 11)),
    ("large224_cli", lambda: phase_cli(LARGE224)),
    ("narrator", lambda: phase_narrator(NARRATOR)),
    ("infer_narrator_cli", lambda: phase_infer_narrator_cli(NARRATOR)),
    ("large_model", lambda: phase_model(LARGE)),
    ("large_cli", lambda: phase_cli(LARGE)),
    ("large_train_step", phase_large_train_step),
    ("large_pretrain_cli",
     lambda: phase_pretrain_cli(LARGE, 3, 8, ("--use-checkpoint",))),
    ("flagship_narrator", lambda: phase_narrator(FLAGSHIP)),
    ("flagship_infer_narrator_cli",
     lambda: phase_infer_narrator_cli(FLAGSHIP)),
    ("distilbert_model", lambda: phase_distilbert_model(DISTIL_LARGE)),
    ("hf_model", lambda: phase_distilbert_model(HF_MODEL)),
    ("distilbert_cli", lambda: phase_cli(DISTIL_LARGE)),
    ("distilbert_train_step", lambda: phase_train_step(
        DISTIL_BASE, {torch.float32: 4, torch.bfloat16: 16}, (16,),
        "distilbert_train_step", SEED + 13)),
    ("distilbert_pretrain_cli",
     lambda: phase_pretrain_cli(DISTIL_BASE, 3, 16)),
)
PATH_PHASES = ("cli", "pretrain_cli", "finetune_cli", "large224_cli",
               "infer_narrator_cli", "large_cli", "large_pretrain_cli",
               "flagship_infer_narrator_cli", "distilbert_cli",
               "distilbert_pretrain_cli")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import lavila_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    device = phase_device()
    phase_build()
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
    print(json.dumps({"kernels": rows}), flush=True)
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
