#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through the
kernels written for Hopper, and check them: the zero-shot dual encoder
(serving) and the dual-encoder pretraining step.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (PATH or $CUDA_HOME, default
/usr/local/cuda) and ``triton``; with no CUDA device it exits non-zero
and prints no result. Phases, each printing JSON lines:

  1. device: ``nvidia-smi`` name and power limit, torch's device name.
  2. build: nvcc builds ``lavila_tpu_torch/csrc/*.cu`` (timed).
  3. kernels: K1 (spatial phase), K2 (temporal phase, F=4 and F=16) and
     K3 (LayerNorm) against their plain PyTorch versions on seeded
     inputs, fp32 and bf16, with errors, tolerances and CUDA-event times.
     kernel_bwd: the same for their backward kernels, on strided qkv
     views, errors relative to the reference's largest value, and two
     calls checked bit-identical.
  4. model: CLIP_OPENAI_TIMESFORMER_BASE from a seeded generator, time
     attention given seeded noise (its zero init would make K2's check
     vacuous), embeddings on the kernel path against the plain functions
     on the same weights, launch counts per call, and encode_image
     clips/s at batch 32 in bf16 on both paths.
  5. entry point: the port CLI's ``load_model_from_checkpoint`` (BASE,
     bf16) and ``embed_dataset`` over the synthetic dataset, scored by
     ``lavila_tpu.eval.metrics`` on an identity relevancy matrix.
  6. train_step: 2 AdamW steps of BASE at full depth (``norm_embed``),
     fp32 and bf16, kernel path against the plain path from the same
     weights and batch (losses and every gradient), launches per step,
     then train clips/s and peak memory at batch 16 and 48 in bf16 on
     both paths.
  7. pretrain_cli: the port's pretraining CLI for 5 steps (BASE, bf16,
     batch 16, synthetic data), then the zero-shot loader reads its
     checkpoint and embeds a batch. The launch counts of this run, the
     training path's, go into the kernel summary line.

TF32 is off for matmuls and cuDNN convolutions, so fp32 comparisons are
fp32. Any failed check exits non-zero without the final line; the final
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# the model of the path: TSF-B video tower (12 blocks) + CLIP text tower
MODEL = {"name": "CLIP_OPENAI_TIMESFORMER_BASE", "img": 224, "depth": 12,
         "text_depth": 12, "embed": 256}
# Each kernel case is held against the plain version run in fp32 on the
# same input values, so the bound is the kernel's own error. fp32:
# summation order only; bf16: the kernels compute in fp32 and round the
# output to bf16 once, half an ulp (<= 1/64 below 8 for unit-scale data).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FAILURES: list[str] = []


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


@contextmanager
def plain_path():
    """Route the model's single dispatch sites to the plain versions."""
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import layernorm as KL
    with mock.patch("lavila_tpu_torch.ops.attention.divided_phase",
                    KD.divided_phase_reference), \
            mock.patch("lavila_tpu_torch.ops.basic.layer_norm",
                       KL.layer_norm_reference):
        yield


# kernel name -> (module's launch counter, its key)
COUNTERS = {"K1": ("divided", "space"), "K2": ("divided", "time"),
            "K3": ("layernorm", "layernorm"),
            "K1 bwd": ("divided", "space_bwd"),
            "K2 bwd": ("divided", "time_bwd"),
            "K3 bwd": ("layernorm", "layernorm_bwd")}


def _counter(module: str) -> dict:
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import layernorm as KL
    return {"divided": KD, "layernorm": KL}[module].launches


def launch_counts() -> dict:
    return {name: _counter(m)[key] for name, (m, key) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, key in COUNTERS.values():
        _counter(m)[key] = 0


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


def _phase_case(axis, B, F, N, D, H, dtype, gen) -> dict:
    """One K1/K2 case on strided q/k/v views of a (B, F, N, 3D) tensor,
    as the attention block hands them over."""
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
    tol = TOL[dtype]
    return {"out_err": err, "lse_err": lse_err, "tol": tol,
            "ok": err <= tol and lse_err <= tol,
            "ms": time_ms(lambda: KD.divided_phase(*args)),
            "plain_ms": time_ms(lambda: KD.divided_phase_reference(*args))}


def _ln_case(shape, dtype, gen) -> dict:
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    b = (0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    y = KL.layer_norm(x, w, b, 1e-6)
    ref = KL.layer_norm_reference(x.float(), w.float(), b.float(), 1e-6)
    torch.cuda.synchronize()
    err, tol = max_err(y, ref), TOL[dtype]
    return {"out_err": err, "tol": tol, "ok": err <= tol,
            "ms": time_ms(lambda: KL.layer_norm(x, w, b, 1e-6)),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_reference(x, w, b, 1e-6))}


def phase_kernels() -> dict:
    """Every kernel case; returns the main-path (bf16) case per kernel
    and each kernel's largest error over its cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("K1", "space", (8, 4, 196, 768, 12), dtype),
                  ("K2", "time", (8, 4, 196, 768, 12), dtype),
                  ("K2", "time", (8, 16, 196, 768, 12), dtype),
                  ("K3", "ln", (8, 77, 512), dtype),
                  ("K3", "ln", (8 * 4 * 196, 768), dtype)]
    summary = {}
    with torch.inference_mode():
        for name, kind, shape, dtype in cases:
            if kind == "ln":
                res = _ln_case(shape, dtype, gen)
            else:
                res = _phase_case(kind, *shape[:3], shape[3], shape[4],
                                  dtype, gen)
            emit("kernel", kernel=name, shape=list(shape),
                 dtype=str(dtype).removeprefix("torch."), **res)
            check(res["ok"], f"{name} {kind} {shape} {dtype}: error "
                  f"{res['out_err']} (lse {res.get('lse_err')}) > "
                  f"{res['tol']}")
            s = summary.setdefault(name, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], res["out_err"],
                                   res.get("lse_err", 0.0))
            main_shape = {"K1": 4, "K2": 4}.get(name)
            if dtype == torch.bfloat16 and (
                    shape[1] == main_shape or shape == (8 * 4 * 196, 768)):
                s.update(ms=res["ms"], plain_ms=res["plain_ms"],
                         at=list(shape))
    return summary


def _rel_err(got, ref) -> float:
    """Largest error relative to the reference's largest magnitude."""
    return max_err(got, ref) / max(ref.float().abs().max().item(), 1e-30)


def _all_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _phase_bwd_case(axis, B, F, N, D, H, dtype, gen) -> dict:
    """K1/K2 bwd on strided q/k/v views, out and lse from the forward
    kernel, against the plain backward in fp32 on the same values."""
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
    tol = TOL[dtype]
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "ok": max(errs.values()) <= tol and _all_equal(got, again),
            "ms": time_ms(lambda: KD.divided_phase_bwd(*args)),
            "plain_ms": time_ms(
                lambda: KD.divided_phase_bwd_reference(*args))}


def _ln_bwd_case(shape, dtype, gen) -> dict:
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    dy = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    got = KL.layer_norm_bwd(x, w, dy, 1e-6)
    again = KL.layer_norm_bwd(x, w, dy, 1e-6)
    ref = KL.layer_norm_bwd_reference(x.float(), w.float(), dy.float(), 1e-6)
    torch.cuda.synchronize()
    errs = {n: _rel_err(a, b) for n, a, b in
            zip(("dx", "dweight", "dbias"), got, ref)}
    tol = TOL[dtype]
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "ok": max(errs.values()) <= tol and _all_equal(got, again),
            "ms": time_ms(lambda: KL.layer_norm_bwd(x, w, dy, 1e-6)),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_bwd_reference(x, w, dy, 1e-6))}


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
                  ("K3 bwd", "ln", (8, 77, 512), dtype),
                  ("K3 bwd", "ln", (8 * 4 * 196, 768), dtype)]
    summary = {}
    with torch.no_grad():
        for name, kind, shape, dtype in cases:
            if kind == "ln":
                res = _ln_bwd_case(shape, dtype, gen)
            else:
                res = _phase_bwd_case(kind, *shape[:3], shape[3], shape[4],
                                      dtype, gen)
            emit("kernel_bwd", kernel=name, shape=list(shape),
                 dtype=str(dtype).removeprefix("torch."), **res)
            check(res["ok"], f"{name} {shape} {dtype}: relative errors "
                  f"{res['rel_err']} > {res['tol']} or not deterministic "
                  f"({res['deterministic']})")
            s = summary.setdefault(name, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], res["abs_err"])
            if dtype == torch.bfloat16 and (
                    (kind != "ln" and shape[1] == 4)
                    or shape == (8 * 4 * 196, 768)):
                s.update(ms=res["ms"], plain_ms=res["plain_ms"],
                         at=list(shape))
    return summary


def _base_model():
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(MODEL["name"], device=DEVICE, generator=gen)
    with torch.no_grad():
        for blk in model.visual.blocks:
            for lin in (blk.timeattn.qkv, blk.timeattn.proj):
                std = lin.in_features ** -0.5
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=gen) * std)
                lin.bias.copy_(torch.randn(lin.bias.shape,
                                           generator=gen) * 0.02)
    return model


def _inputs(B, gen):
    size = MODEL["img"]
    frames = torch.randn(B, 4, size, size, 3, generator=gen, device=DEVICE)
    text = torch.randint(1, 49407, (B, 77), generator=gen, device=DEVICE)
    eot = torch.randint(5, 77, (B,), generator=gen, device=DEVICE)
    text[torch.arange(B, device=DEVICE), eot] = 49407
    return frames, text


def phase_model() -> None:
    from lavila_tpu_torch.models.dual_encoder import l2_normalize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    frames, text = _inputs(4, gen)
    model = _base_model()
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            img = model.encode_image(frames)
            torch.cuda.synchronize()
            per_image = launch_counts()
            reset_launch_counts()
            txt = model.encode_text(text)
            torch.cuda.synchronize()
            per_text = launch_counts()
            with plain_path():
                img_ref = model.encode_image(frames)
                txt_ref = model.encode_text(text)
        res = {}
        for name, a, b in (("image", img, img_ref), ("text", txt, txt_ref)):
            a, b = l2_normalize(a.float()), l2_normalize(b.float())
            res[f"{name}_max_err"] = max_err(a, b)
            res[f"{name}_cos_min"] = (a * b).sum(-1).min().item()
            res[f"{name}_finite"] = bool(torch.isfinite(a).all())
        emit("model", model=MODEL["name"],
             dtype=str(dtype).removeprefix("torch."), batch=4,
             launches_per_encode_image=per_image,
             launches_per_encode_text=per_text, **res)
        check(res["image_finite"] and res["text_finite"],
              f"BASE {dtype}: non-finite embeddings")
        depth = MODEL["depth"]
        check(per_image["K1"] == depth and per_image["K2"] == depth
              and per_image["K3"] > 0 and per_text["K3"] > 0,
              f"BASE {dtype}: launches image {per_image} text {per_text}")
        if dtype == torch.float32:
            check(res["image_max_err"] <= 1e-3 and
                  res["text_max_err"] <= 1e-3,
                  f"BASE fp32 kernel vs plain: {res}")
        else:
            check(res["image_cos_min"] >= 0.999 and
                  res["text_cos_min"] >= 0.999,
                  f"BASE bf16 kernel vs plain: {res}")
            _throughput(model, gen)


def _throughput(model, gen, batch: int = 32, iters: int = 5) -> None:
    size = MODEL["img"]
    frames = torch.randn(batch, 4, size, size, 3, generator=gen,
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
    emit("throughput", what="encode_image clips/s", model=MODEL["name"],
         dtype="bfloat16", batch=batch,
         frames=4, iters=iters, order="kernels, plain, plain, kernels",
         clips_per_s=rates)


def phase_cli() -> dict:
    """The port CLI's functions on the synthetic dataset. Returns the
    launch counts of this run, the main path's."""
    import numpy as np

    from lavila_tpu.data import transforms as T
    from lavila_tpu.data.datasets import DatasetConfig, VideoCaptionDataset
    from lavila_tpu.data.loader import DataLoader
    from lavila_tpu.eval import metrics as M
    from lavila_tpu_torch.cli import eval_zeroshot as cli

    args = cli.get_args_parser().parse_args(
        ["--model", MODEL["name"], "--bf16", "--device",
         DEVICE, "--clip-length", "4", "--batch-size", "8", "--workers",
         "4"])
    model, tokenizer, name = cli.load_model_from_checkpoint(args)
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
    v, t, _ = cli.embed_dataset(model, loader)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    sim = v @ t.T
    rel = np.eye(len(v), dtype=np.float32)
    v_map, t_map, avg_map = M.retrieval_map(sim, rel)
    v_ndcg, t_ndcg, avg_ndcg = M.retrieval_ndcg(sim, rel)
    metrics = {"mAP_v2t": v_map, "mAP_t2v": t_map, "mAP_avg": avg_map,
               "nDCG_v2t": v_ndcg, "nDCG_t2v": t_ndcg,
               "nDCG_avg": avg_ndcg}
    emit("cli", model=name, dtype="bfloat16", clips=len(v),
         embed_shape=[list(v.shape), list(t.shape)], seconds=seconds,
         launches=counts, metrics=metrics)
    dim = MODEL["embed"]
    check(v.shape == (len(ds), dim) and t.shape == (len(ds), dim)
          and bool(np.isfinite(v).all() and np.isfinite(t).all()),
          f"CLI embeddings {v.shape} {t.shape} not finite or misshapen")
    check(all(0.0 <= x <= 1.0 for x in metrics.values()),
          f"CLI metrics out of range: {metrics}")
    batches = -(-len(ds) // args.batch_size)
    check(counts["K1"] == counts["K2"] == MODEL["depth"] * batches
          and counts["K3"] > 0,
          f"CLI launches {counts} for {batches} batches")
    return counts


def _step_launches() -> dict:
    """Kernel launches of one train step. LayerNorms of one forward: per
    video block norm3, norm1 and norm2, each on the CLS row and on the
    patches; ln_pre on both and the final norm; per text block ln_1 and
    ln_2; ln_final (100 for BASE). The tower returns only the CLS row, so
    the last block's patch outputs never reach the loss: autograd runs
    no backward for its spatial phase (K1) or its norm2 on the patches
    (K3)."""
    depth = MODEL["depth"]
    norms = 6 * depth + 3 + 2 * MODEL["text_depth"] + 1
    return {"K1": depth, "K2": depth, "K3": norms, "K1 bwd": depth - 1,
            "K2 bwd": depth, "K3 bwd": norms - 1}


def _make_state(model, dtype):
    """A TrainState with the CLI's default AdamW recipe (warm-up from
    1e-6 over 100-step epochs)."""
    from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from lavila_tpu_torch.train.step import TrainState
    schedule = cosine_schedule(3e-5, 1e-5, 5, 100, warmup_epochs=1,
                               start_warmup_lr=1e-6)
    return TrainState.create(
        model, lambda params: make_optimizer(params, schedule), dtype=dtype)


def _train_batch(B, gen):
    frames, text = _inputs(B, gen)
    return {"frames": frames, "text": text}


def _run_steps(base, dtype, batch, plain: bool, steps: int = 2):
    """``steps`` train steps from a copy of ``base``: the losses, each
    step's fp32 gradients and the launch counts of each step."""
    import copy

    from lavila_tpu_torch.train.step import make_clip_train_step
    state = _make_state(copy.deepcopy(base).train(), dtype)
    # normalised embeddings (--norm-embed) keep the logits within
    # ±logit_scale; raw random-init embeddings give logits in the
    # hundreds, where bf16 rounding alone moves the loss by percents
    step_fn = make_clip_train_step(norm_embed=True)
    losses, grads, counts = [], [], []
    with plain_path() if plain else nullcontext():
        for _ in range(steps):
            reset_launch_counts()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            counts.append(launch_counts())
            losses.append(metrics["loss"].item())
            grads.append({k: p.grad.clone() for k, p in state.params.items()})
    return losses, grads, counts


def phase_train_step() -> None:
    """The train step on BASE at full depth, kernel path against the
    plain path from the same weights and batch; then train clips/s."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    base = _base_model()
    batch = _train_batch(4, gen)
    for dtype in (torch.float32, torch.bfloat16):
        k_loss, k_grads, counts = _run_steps(base, dtype, batch, False)
        p_loss, p_grads, _ = _run_steps(base, dtype, batch, True)
        rel_loss = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
        # cosines: every weight matrix (2-D, and the 4-D patch-embed
        # kernel) is held to the bound; the 3-D embeddings (cls_token,
        # pos_embed, temporal_embed) are reported beside them
        worst_err = 0.0
        worst = {"matrices": (1.0, None), "embeddings": (1.0, None)}
        for step, (kg, pg) in enumerate(zip(k_grads, p_grads)):
            for name, g in pg.items():
                a = kg[name]
                scale = g.abs().max().item()
                if scale > 0:
                    worst_err = max(worst_err, max_err(a, g) / scale)
                if g.dim() >= 2 and scale > 0:
                    cos = torch.nn.functional.cosine_similarity(
                        a.flatten(), g.flatten(), dim=0).item()
                    kind = "embeddings" if g.dim() == 3 else "matrices"
                    if cos < worst[kind][0]:
                        worst[kind] = (cos, f"step {step}: {name}")
        worst_cos = worst["matrices"][0]
        name = str(dtype).removeprefix("torch.")
        emit("train_step", model=MODEL["name"], dtype=name, batch=4,
             steps=2, loss_kernels=k_loss, loss_plain=p_loss,
             loss_rel_err=rel_loss, grad_rel_err_max=worst_err,
             grad_cos_min=worst_cos, grad_cos_min_at=worst["matrices"][1],
             embed_grad_cos_min=worst["embeddings"][0],
             embed_grad_cos_min_at=worst["embeddings"][1],
             launches_per_step=counts)
        check(all(math.isfinite(x) for x in k_loss + p_loss),
              f"train step {name}: non-finite loss {k_loss} {p_loss}")
        want = _step_launches()
        check(all(c == want for c in counts),
              f"train step {name}: launches {counts}, want {want}")
        if dtype == torch.float32:
            check(rel_loss <= 1e-5 and worst_err <= 1e-4,
                  f"train step fp32 kernels vs plain: loss {rel_loss}, "
                  f"gradient {worst_err}")
        else:
            check(rel_loss <= 1e-2 and worst_cos >= 0.99,
                  f"train step bf16 kernels vs plain: loss {rel_loss}, "
                  f"cosine {worst_cos}")
    del k_grads, p_grads
    _train_throughput(base, gen)


def _train_throughput(base, gen, iters: int = 10) -> None:
    """Train clips/s, bf16, kernel and plain path in alternating order:
    at batch 16 (bench.py's TSF-B batch), where the host's issue time
    bounds the step, and at batch 48, where the device does."""
    from lavila_tpu_torch.train.step import make_clip_train_step
    state = _make_state(base.train(), torch.bfloat16)
    step_fn = make_clip_train_step()
    for batch in (16, 48):
        data = _train_batch(batch, gen)
        rates, peaks = {}, {}
        for path in ("kernels", "plain", "plain", "kernels"):
            with plain_path() if path == "plain" else nullcontext():
                torch.cuda.reset_peak_memory_stats()
                for _ in range(3):
                    step_fn(state, data)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    step_fn(state, data)
                torch.cuda.synchronize()
                rates.setdefault(path, []).append(
                    batch * iters / (time.perf_counter() - t0))
                peaks.setdefault(path, []).append(
                    torch.cuda.max_memory_allocated() / 2**30)
        emit("train_throughput", what="train step clips/s",
             model=MODEL["name"], dtype="bfloat16", batch=batch, frames=4,
             iters=iters, order="kernels, plain, plain, kernels",
             clips_per_s=rates, peak_memory_gib=peaks)
        del data


def phase_pretrain_cli() -> dict:
    """The port's pretraining CLI for 5 steps on the synthetic dataset
    (BASE, bf16, batch 16), then the port's zero-shot loader reads the
    checkpoint and embeds a batch: train → save → serve. Returns the
    launch counts of the training run, the main path's."""
    import tempfile

    from lavila_tpu.config import parse_config
    from lavila_tpu_torch.cli import eval_zeroshot as ez
    from lavila_tpu_torch.cli import main_pretrain as cli
    with tempfile.TemporaryDirectory() as out:
        cfg = parse_config(cli.TorchPretrainConfig, [
            "--dataset", "synthetic", "--model", MODEL["name"], "--steps",
            "5", "--batch-size", "16", "--workers", "4", "--print-freq",
            "1", "--device", DEVICE, "--output-dir", out])
        reset_launch_counts()
        t0 = time.perf_counter()
        state = cli.main(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        with open(os.path.join(out, "log.txt")) as f:
            log = json.loads(f.readlines()[-1])
        files = sorted(os.listdir(out))
        args = ez.get_args_parser().parse_args(
            ["--checkpoint", os.path.join(out, "checkpoint_latest.pt"),
             "--device", DEVICE, "--bf16"])
        model, _, name = ez.load_model_from_checkpoint(args)
    same = all(torch.equal(p, state.params[k].to(p.dtype))
               for k, p in model.named_parameters())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    frames, text = _inputs(2, gen)
    with torch.inference_mode():
        img, txt = model.encode_image(frames), model.encode_text(text)
    emit("pretrain_cli", model=name, dtype="bfloat16", batch=16, steps=5,
         seconds=seconds, step=state.step, train_loss=log["train_loss"],
         files=files, launches=counts, reloaded_equal=same,
         embed_shape=[list(img.shape), list(txt.shape)])
    check(math.isfinite(log["train_loss"]) and state.step == 5,
          f"pretrain CLI: loss {log['train_loss']}, step {state.step}")
    check({"checkpoint_latest.pt", "checkpoint_latest.pt.json",
           "checkpoint_0000.pt", "checkpoint_0000.pt.json"} <= set(files),
          f"pretrain CLI wrote {files}")
    check(same, "the served model differs from the trained masters")
    check(img.shape == (2, MODEL["embed"]) and txt.shape == (2, MODEL["embed"])
          and bool(torch.isfinite(img).all() and torch.isfinite(txt).all()),
          f"served embeddings {img.shape} {txt.shape} not finite")
    check(counts == {k: 5 * n for k, n in _step_launches().items()},
          f"pretrain CLI launches {counts} for 5 steps")
    return counts


KERNELS = [
    ("K1", "divided_space_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:47"),
    ("K2", "divided_time_fwd", "cuda", "lavila_tpu_torch/csrc/divided_fwd.cu",
     "lavila_tpu/ops/pallas/divided.py:178"),
    ("K3", "layernorm_fwd", "triton", "lavila_tpu_torch/kernels/layernorm.py",
     "lavila_tpu/ops/pallas/layernorm.py:64"),
    ("K1 bwd", "divided_space_bwd", "cuda",
     "lavila_tpu_torch/csrc/divided_bwd.cu",
     "lavila_tpu/ops/pallas/divided.py:77"),
    ("K2 bwd", "divided_time_bwd", "cuda",
     "lavila_tpu_torch/csrc/divided_bwd.cu",
     "lavila_tpu/ops/pallas/divided.py:207"),
    ("K3 bwd", "layernorm_bwd", "triton",
     "lavila_tpu_torch/kernels/layernorm.py",
     "lavila_tpu/ops/pallas/layernorm.py:82"),
]


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
    summary, counts = {}, {}
    for name, phase in (("kernels", phase_kernels),
                        ("kernel_bwd", phase_kernels_bwd),
                        ("model", phase_model), ("cli", phase_cli),
                        ("train_step", phase_train_step),
                        ("pretrain_cli", phase_pretrain_cli)):
        try:
            out = phase()
        except Exception:  # report every phase, then fail at the end
            traceback.print_exc()
            check(False, f"phase {name} raised")
            continue
        if name in ("kernels", "kernel_bwd"):
            summary.update(out)
        elif name == "pretrain_cli":
            counts = out
    rows = []
    for key, name, route, source, replaces in KERNELS:
        s = summary.get(key, {})
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": counts.get(key, 0),
                     "max_abs_err": s.get("max_abs_err"),
                     "ms": s.get("ms"), "plain_ms": s.get("plain_ms")})
        check(counts.get(key, 0) > 0, f"{name} never launched on the path")
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
