#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through the
kernels written for Hopper, and check them: the zero-shot dual encoder
(serving), the dual-encoder pretraining step and the narrator's sampled
decoding.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (PATH or $CUDA_HOME, default
/usr/local/cuda) and ``triton``; with no CUDA device it exits non-zero
and prints no result. Phases, each printing JSON lines:

  1. device: ``nvidia-smi`` name and power limit, torch's device name.
  2. build: nvcc builds ``lavila_tpu_torch/csrc/*.cu`` (timed).
  3. kernels: K1 (spatial phase), K2 (temporal phase, F=4 and F=16), K3
     (LayerNorm; the towers' widths and the narrator's: a decode step's
     (160, 1, 1600) and the pooler's bias-free (4096, 1600)) and K9
     (decode attention; GPT-2 XL and TSF-B widths, ``num_valid`` 0, 1,
     15 and 77) against their plain PyTorch versions
     on seeded inputs, fp32 and bf16, with errors, tolerances,
     CUDA-event times, the card's bound for the same work and the time
     of one PyTorch library call computing it
     (``scripts/time_library_calls.py``). kernel_bwd: the same for the
     backward kernels, on strided qkv views, errors relative to the
     reference's largest value, and two calls checked bit-identical.
  4. model: CLIP_OPENAI_TIMESFORMER_BASE from a seeded generator, time
     attention given seeded noise (its zero init would make K2's check
     vacuous), embeddings on the kernel path against the plain functions
     on the same weights, launch counts per call, and encode_image
     clips/s at batch 32 in bf16 on both paths.
  5. entry point: the port CLI's ``load_model_from_checkpoint`` (BASE,
     bf16) and ``embed_dataset`` over the synthetic dataset, scored by
     the port's ``lavila_tpu_torch.eval.metrics`` on an identity
     relevancy matrix.
  6. train_step: 2 AdamW steps of BASE at full depth (``norm_embed``),
     fp32 and bf16, kernel path against the plain path from the same
     weights and batch (losses and every gradient), launches per step,
     then train clips/s and peak memory at batch 16 and 48 in bf16 on
     both paths.
  7. pretrain_cli: the port's pretraining CLI for 5 steps (BASE, bf16,
     batch 16, synthetic data), then the zero-shot loader reads its
     checkpoint and embeds a batch. The launch counts of this run, the
     training path's, go into the kernel summary line for K1-K3.
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
     ``total.pkl``. Its launch counts go into the summary line for K9,
     and for K3 under ``narrator``.

TF32 is off for matmuls and cuDNN convolutions, so fp32 comparisons are
fp32. Any failed check exits non-zero without the final line; the final
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# the model of the path: TSF-B video tower (12 blocks) + CLIP text tower
MODEL = {"name": "CLIP_OPENAI_TIMESFORMER_BASE", "img": 224, "depth": 12,
         "text_depth": 12, "embed": 256}
# Each kernel case is held against the plain version run in fp32 on the
# same input values, so the bound is the kernel's own error. fp32:
# summation order only; bf16: the kernels compute in fp32 and round the
# output to bf16 once, half an ulp (<= 1/64 below 8 for unit-scale data).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FAILURES: list[str] = []
# the narrator of the decode path: TSF-B + GPT-2 XL (48 layers, 24 with
# cross-attention); BOS = EOS = GPT-2's <|endoftext|>
NARRATOR = {"name": "VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL", "layers": 48,
            "cross": 24, "bos": 50256, "eos": 50256}
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


@contextmanager
def plain_path():
    """Route the model's single dispatch sites to the plain versions."""
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import layernorm as KL
    with mock.patch("lavila_tpu_torch.ops.attention.divided_phase",
                    KD.divided_phase_reference), \
            mock.patch("lavila_tpu_torch.ops.basic.layer_norm",
                       KL.layer_norm_reference), \
            mock.patch("lavila_tpu_torch.models.gpt2.decode_attention",
                       KDec.decode_attention_reference):
        yield


# kernel name -> (module's launch counter, its key)
COUNTERS = {"K1": ("divided", "space"), "K2": ("divided", "time"),
            "K3": ("layernorm", "layernorm"),
            "K1 bwd": ("divided", "space_bwd"),
            "K2 bwd": ("divided", "time_bwd"),
            "K3 bwd": ("layernorm", "layernorm_bwd"),
            "K9": ("decode", "decode")}


def _counter(module: str) -> dict:
    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import layernorm as KL
    return {"divided": KD, "layernorm": KL, "decode": KDec}[module].launches


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


def _keys(axis, F, N) -> int:
    return N + 1 if axis == "space" else F + 1


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
    it, rows = q.element_size(), B * F * N
    return {"out_err": err, "lse_err": lse_err, "tol": tol,
            "ok": err <= tol and lse_err <= tol,
            "ms": time_ms(lambda: KD.divided_phase(*args)),
            "plain_ms": time_ms(lambda: KD.divided_phase_reference(*args)),
            **bound((4 * rows * D + 2 * B * D) * it + rows * H * 4,
                    4 * rows * _keys(axis, F, N) * D, dtype),
            "library_ms": time_ms(library().divided_fwd_call(
                q, k, v, ck, cv, axis, H))}


def _ln_case(shape, dtype, gen, bias: bool = True) -> dict:
    """One K3 case; ``bias=False`` hands the kernel a zero bias, as
    ``BiasFreeLayerNorm`` (the pooler's norms) does."""
    from lavila_tpu_torch.kernels import layernorm as KL
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    b = (0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    if not bias:
        b = torch.zeros_like(b)
    y = KL.layer_norm(x, w, b, 1e-6)
    ref = KL.layer_norm_reference(x.float(), w.float(), b.float(), 1e-6)
    torch.cuda.synchronize()
    err, tol = max_err(y, ref), TOL[dtype]
    # ~8 fp32 operations per element (statistics, normalise, scale, shift)
    return {"out_err": err, "tol": tol, "ok": err <= tol,
            "ms": time_ms(lambda: KL.layer_norm(x, w, b, 1e-6)),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_reference(x, w, b, 1e-6)),
            **bound((2 * x.numel() + 2 * D) * x.element_size(),
                    8 * x.numel(), torch.float32),
            "library_ms": time_ms(library().layer_norm_call(x, w, b, 1e-6))}


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


# the main-path case of each kernel, whose numbers go into the summary
MAIN_CASE = {"K1": (8, 4, 196, 768, 12), "K2": (8, 4, 196, 768, 12),
             "K3": (8 * 4 * 196, 768), "K9": (160, 77, 1600, 25, 15)}
# K3 runs on the training path (MAIN_CASE) and on the narrator's decode
# path, whose case (one decode step's 160 GPT-2 XL rows) the summary
# keeps under "narrator"
NARRATOR_CASE = {"K3": (160, 1, 1600)}
_SUMMARY_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def _summarise(summary, name, shape, dtype, res, err_keys) -> None:
    s = summary.setdefault(name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"],
                           *(res.get(k, 0.0) for k in err_keys))
    if dtype != torch.bfloat16:
        return
    main = {k: res[k] for k in _SUMMARY_KEYS} | {"at": list(shape)}
    if shape == MAIN_CASE[name.removesuffix(" bwd")]:
        s.update(main)
    if shape == NARRATOR_CASE.get(name):
        s["narrator"] = main


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
                  ("K3", "ln", (8 * 4 * 196, 768), dtype),
                  # the narrator's: a decode step's GPT-2 XL norms (D =
                  # 1600 masked to a 2048 block), the pooler's bias-free
                  # norms on 16 clips' 256 queries
                  ("K3", "ln", (160, 1, 1600), dtype),
                  ("K3", "ln_nobias", (16 * 256, 1600), dtype)]
        # K9: the narrator's 160 rows of GPT-2 XL, and TSF-B width
        cases += [("K9", "decode", (B, 77, D, H, nv), dtype)
                  for B, D, H in ((160, 1600, 25), (16, 768, 12))
                  for nv in (0, 1, 15, 77)]
    summary = {}
    with torch.inference_mode():
        for name, kind, shape, dtype in cases:
            if kind.startswith("ln"):
                res = _ln_case(shape, dtype, gen, bias=kind == "ln")
            elif kind == "decode":
                res = _decode_case(*shape, dtype, gen)
            else:
                res = _phase_case(kind, *shape[:3], shape[3], shape[4],
                                  dtype, gen)
            emit("kernel", kernel=name, case=kind, shape=list(shape),
                 dtype=str(dtype).removeprefix("torch."), **res)
            check(res["ok"], f"{name} {kind} {shape} {dtype}: error "
                  f"{res['out_err']} (lse {res.get('lse_err')}) > "
                  f"{res['tol']}")
            _summarise(summary, name, shape, dtype, res,
                       ("out_err", "lse_err"))
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
    it, rows = q.element_size(), B * F * N
    # reads q, k, v, do, out, ck, cv, lse; writes dq, dk, dv, dck, dcv;
    # five products (S, dP, dV, dQ, dK) of 2 operations per term
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "ok": max(errs.values()) <= tol and _all_equal(got, again),
            "ms": time_ms(lambda: KD.divided_phase_bwd(*args)),
            "plain_ms": time_ms(
                lambda: KD.divided_phase_bwd_reference(*args)),
            **bound((8 * rows * D + 4 * B * D) * it + rows * H * 4,
                    10 * rows * _keys(axis, F, N) * D, dtype),
            "library_ms": time_ms(library().divided_bwd_call(
                q, k, v, ck, cv, do, axis, H))}


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
    b = torch.zeros_like(w)
    # reads x, dy, w; writes dx, dw, db; ~12 fp32 operations per element
    return {"rel_err": errs, "abs_err": max(map(max_err, got, ref)),
            "tol": tol, "deterministic": _all_equal(got, again),
            "ok": max(errs.values()) <= tol and _all_equal(got, again),
            "ms": time_ms(lambda: KL.layer_norm_bwd(x, w, dy, 1e-6)),
            "plain_ms": time_ms(
                lambda: KL.layer_norm_bwd_reference(x, w, dy, 1e-6)),
            **bound((3 * x.numel() + 3 * D) * x.element_size(),
                    12 * x.numel(), torch.float32),
            "library_ms": time_ms(library().layer_norm_bwd_call(
                x, w, b, dy, 1e-6))}


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
    for name, kind, shape, dtype in cases:
        with torch.no_grad():
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
        _summarise(summary, name, shape, dtype, res, ("abs_err",))
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

    from lavila_tpu_torch.data import transforms as T
    from lavila_tpu_torch.data.datasets import (DatasetConfig,
                                                VideoCaptionDataset)
    from lavila_tpu_torch.data.loader import DataLoader
    from lavila_tpu_torch.eval import metrics as M
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
            "K2 bwd": depth, "K3 bwd": norms - 1, "K9": 0}


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

    from lavila_tpu_torch.config import parse_config
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


def _narrator_model():
    """The GPT-2 XL narrator (fp32) initialised on the card from a seeded
    generator, its cross-attention gates and its time attention given
    seeded non-zero values (zero gates would make the cross-attention
    check vacuous, as zero time attention would K2's). Returns it and the
    init's seconds."""
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    model = build_model(NARRATOR["name"], device=DEVICE, generator=gen,
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


def _greedy(model, tokens, L: int):
    return model.generate(tokens, generator=None, bos_id=NARRATOR["bos"],
                          eos_id=NARRATOR["eos"], max_text_length=L,
                          top_k=1, num_return_sequences=2)


def _cos_min(a, b) -> float:
    """The smallest cosine between matching rows (last axis)."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def phase_narrator() -> None:
    """The GPT-2 XL narrator, kernel path against plain path on the same
    weights (fp32, then bf16), a profile of decode steps and
    narrations/s."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    model, init_s = _narrator_model()
    frames, _ = _inputs(2, gen)
    text = torch.randint(0, 50257, (2, 8), generator=gen, device=DEVICE)
    text[:, 0] = NARRATOR["bos"]
    L = 16
    for dtype in (torch.float32, torch.bfloat16):
        model = model.to(dtype)
        with torch.inference_mode():
            reset_launch_counts()
            tokens = model.encode_image(frames)
            torch.cuda.synchronize()
            per_image = launch_counts()
            cached, per_step = _cached_logits(model, tokens, text, 8)
            ids, ppl = _greedy(model, tokens, L)
            with plain_path():
                tokens_ref = model.encode_image(frames)
                full = model.text_decoder(text, encoder_states=tokens_ref)
                cached_ref, _ = _cached_logits(model, tokens_ref, text, 8)
                ids_ref, ppl_ref = _greedy(model, tokens_ref, L)
        name = str(dtype).removeprefix("torch.")
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
        emit("narrator", model=NARRATOR["name"], dtype=name, clips=2,
             return_sequences=2, init_seconds=init_s,
             launches_per_encode_image=per_image,
             launches_per_decode_step=per_step, ids=ids.tolist(),
             ids_plain=ids_ref.tolist(), **res)
        check(res["finite"] and tokens.shape == (2, 256, 1600),
              f"narrator {name}: non-finite or misshapen outputs")
        check(per_step["K9"] == NARRATOR["layers"] and per_step["K3"] == 2 * (
            NARRATOR["layers"] + NARRATOR["cross"]) + 1,
              f"narrator {name}: launches per decode step {per_step}")
        check(per_image["K1"] == per_image["K2"] == 12
              and per_image["K9"] == 0,
              f"narrator {name}: launches per encode_image {per_image}")
        if dtype == torch.float32:
            # 48 layers; the cached steps' (B, 1, D) products and the full
            # forward's (B, 8, D) ones sum in other orders
            check(res["logits_err"] <= 1e-3 and res["ids_equal"]
                  and res["ppl_rel_err"] <= 1e-4,
                  f"narrator fp32 kernels vs plain: {res}")
        else:
            check(res["logits_cos_min"] >= 0.99
                  and res["ids_agree_steps"] >= 4,
                  f"narrator bf16 kernels vs plain: {res}")
    _decode_profile(model, gen)
    _narration_throughput(model, gen)


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


def _decode_profile(model, gen, steps: int = 5) -> None:
    """Host time against device time over ``steps`` decode steps of the
    throughput shape (160 rows, bf16, cache positions 8..12): the steps
    timed as they run, then the same steps traced with torch.profiler for
    the device time by kernel and K9's share. The idle share is the
    device time over the untraced step."""
    from lavila_tpu_torch.models.gpt2 import init_cache
    frames, _ = _inputs(16, gen)
    with torch.inference_mode():
        tokens = model.encode_image(frames).repeat_interleave(10, 0)
        kv = model.prepare_decode(tokens)
        cache = init_cache(model.text_decoder.cfg, tokens.shape[0], 77,
                           dtype=tokens.dtype, device=DEVICE)
        cur = torch.full((tokens.shape[0], 1), NARRATOR["bos"],
                         device=DEVICE)
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
    emit("decode_profile", model=NARRATOR["name"], dtype="bfloat16",
         rows=tokens.shape[0], steps=steps, host_issue_ms_per_step=host,
         wall_ms_per_step=wall, traced_host_issue_ms_per_step=traced_host,
         traced_wall_ms_per_step=traced_wall,
         device_ms_per_step=device_ms or "not measured",
         k9_ms_per_step=k9_ms, device_idle_share=(
             1 - device_ms / wall) if device_ms else None,
         top=[{"kernel": k[:90], "ms_per_step": t, "launches_per_step": n}
              for k, t, n in rows[:12]])


def _narration_throughput(model, gen, clips: int = 16, nrs: int = 10,
                          L: int = 77) -> None:
    """Narrations/s (clips × return sequences per second, encode and
    decode), bf16, kernel and plain path in alternating order, with the
    decode steps run (read from the ids, and held against K9's launches
    on the kernel path), ms per step and peak memory."""
    frames, _ = _inputs(clips, gen)
    kw = dict(bos_id=NARRATOR["bos"], eos_id=NARRATOR["eos"],
              temperature=0.7, top_p=0.95, num_return_sequences=nrs)
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
        steps = _steps_run(ids, NARRATOR["eos"], L)
        for k, v in (("narrations_per_s", clips * nrs / (t2 - t0)),
                     ("encode_ms", (t1 - t0) * 1e3),
                     ("decode_steps", steps),
                     ("ms_per_step", (t2 - t1) * 1e3 / steps),
                     ("peak_memory_gib",
                      torch.cuda.max_memory_allocated() / 2**30)):
            out.setdefault(k, {}).setdefault(path, []).append(v)
        check(bool(torch.isfinite(ppl).all()) and ids.shape[0] == clips * nrs,
              f"narration throughput {path}: bad outputs")
        k9 = launch_counts()["K9"]
        check(k9 == (steps * NARRATOR["layers"] if path == "kernels" else 0),
              f"narration throughput {path}: {k9} K9 launches for {steps} "
              "decode steps")
    emit("narrator_throughput", what="narrations/s", model=NARRATOR["name"],
         dtype="bfloat16", clips=clips, return_sequences=nrs,
         max_text_length=L, temperature=0.7, top_p=0.95,
         order="kernels, plain, plain, kernels", **out)


def phase_infer_narrator_cli() -> dict:
    """The port's narrator inference CLI on one batch of the synthetic
    dataset (GPT-2 XL, bf16, 16 clips x 10 captions). Returns the launch
    counts of this run, the decode path's."""
    import pickle
    import tempfile

    from lavila_tpu_torch.cli import main_infer_narrator as cli
    with tempfile.TemporaryDirectory() as out:
        args = cli.get_args_parser().parse_args(
            ["--dataset", "synthetic", "--model", NARRATOR["name"], "--bf16",
             "--device", DEVICE, "--batch-size", "16", "--max-samples", "16",
             "--num-return-sequences", "10", "--workers", "4",
             "--output-dir", out])
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        with open(os.path.join(out, "total.pkl"), "rb") as f:
            total = pickle.load(f)
        files = sorted(os.listdir(out))
    ok = (len(total) == 16 and all(
        r[0] == "synthetic" and len(r[3]) == len(r[4]) == 10
        and all(isinstance(c, str) for c in r[3])
        and all(math.isfinite(x) for x in r[4]) for r in total))
    first = ([*total[0][:3], total[0][3][:2], total[0][4][:2]] if total
             else None)
    emit("infer_narrator_cli", model=NARRATOR["name"], dtype="bfloat16",
         clips=16, return_sequences=10, seconds=seconds, files=files,
         records=len(total), first_record=first, launches=counts)
    check(ok and {"cache.0.pkl", "total.pkl"} <= set(files),
          f"infer CLI wrote {files}, {len(total)} records")
    layers = NARRATOR["layers"]
    steps = counts["K9"] // layers
    check(counts["K9"] > 0 and counts["K9"] % layers == 0 and steps <= 76
          and counts["K1"] == 12 and counts["K2"] == 12
          and counts["K3"] >= steps * (2 * (layers + NARRATOR["cross"]) + 1),
          f"infer CLI launches {counts}")
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
    ("K9", "decode_attention", "cuda",
     "lavila_tpu_torch/csrc/decode_attention.cu",
     "lavila_tpu/ops/pallas/decode_attention.py:43"),
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
                        ("pretrain_cli", phase_pretrain_cli),
                        ("narrator", phase_narrator),
                        ("infer_narrator_cli", phase_infer_narrator_cli)):
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
        elif name == "pretrain_cli":  # the training path: K1-K3
            counts.update({k: v for k, v in out.items() if k != "K9"})
        elif name == "infer_narrator_cli":  # the decode path: K9, K3
            counts["K9"] = out["K9"]
            if "narrator" in summary.get("K3", {}):
                summary["K3"]["narrator"]["launches"] = out["K3"]
    rows = []
    for key, name, route, source, replaces in KERNELS:
        s = summary.get(key, {})
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": counts.get(key, 0),
                     "max_abs_err": s.get("max_abs_err"),
                     **{k: s.get(k) for k in _SUMMARY_KEYS},
                     "at": s.get("at")}
                    | ({"narrator": s["narrator"]} if "narrator" in s else {}))
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
