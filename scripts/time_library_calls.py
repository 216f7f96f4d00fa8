#!/usr/bin/env python3
"""Time one PyTorch library call per ported kernel, as a yardstick.

For each hand-written kernel of ``lavila_tpu_torch`` this builds the
single PyTorch call that computes the same function on the same inputs
and times it on the card (CUDA events):

  * K1/K2/K6 forward: ``F.scaled_dot_product_attention`` over each group
    with the CLS key/value row concatenated in front of its keys (space:
    a group is one frame, N + 1 keys, for K1 and for K6's larger frames;
    time: one position, F + 1 keys); backward: ``torch.autograd.grad`` of
    that call.
  * K3 forward: ``F.layer_norm``; backward: ``torch.autograd.grad`` of it.
  * K4/K5 forward: ``a + b`` then ``F.layer_norm`` (two calls: PyTorch has
    no single fused one); backward: ``torch.autograd.grad`` of the pair.
  * K9: ``F.scaled_dot_product_attention`` of a ``(B, H, 1, d)`` query
    over the ``num_valid`` cache rows with the current token appended.
  * K7 and K8 forward: ``F.scaled_dot_product_attention(q, k, v,
    is_causal=...)`` on head-major ``(B, H, L, d)`` copies of the
    token-major inputs (made once, outside the timed call); K8's
    backward (dq and dk/dv together): ``torch.autograd.grad`` of it.
  * The CLS row forward: ``F.scaled_dot_product_attention`` of the
    ``(B, H, 1, d)`` CLS query over head-major ``(B, H, 1 + F·N, d)``
    copies of ``[cls; patches]`` (made once, outside the timed call);
    backward: ``torch.autograd.grad`` of it.

The port never calls these: ``chip_smoke.py`` imports the builders below
to report ``library_ms`` beside each kernel, and run alone the script
prints the times at the shapes of the port's main paths, one JSON line
each, after the card's name and power limit. It then times the short
calls, K3's forward, K7, K8's forward and backward and K9, at their
main-path shapes by the profiler's device time (the kernels' own time,
without the wrapper's host cost that their event times carry), the
port's kernel and the library call in turns on the same input
(``scripts/time_spatial_phase.py``'s ``measure``), and K3's backward,
K4's and K5's forward and backward (beside the add and ``F.layer_norm``)
and K2's forward and backward likewise. K3's backward runs at TSF-B's
patch rows (6272, 768), the fine-tune's (25088, 768), TSF-L@336's
(18432, 1024), the CLS rows (8, 768) and (8, 1024) and the text tower's
(8, 77, 512); K4 and K5 at TSF-L@336's (18432, 1024), the fine-tune's
(25088, 768) and TSF-B's (6272, 768). K3's forward runs at TSF-B's patch
rows, a decode step's (160, 1, 1600), GPT-2 XL's caption rows (608,
1600) and DistilBERT's (1232, 768) at eps 1e-12 with 16 flat rows. K7
and K8 run at the text towers' shapes: 16 captions x 8 heads
(TSF-B's b16 step), 32 x 12 (TSF-L@336's b32 remat step) and 256 x 8, on
in_proj views, and K7 at CLIP RN50's attention pool (8 images x 32 heads,
one query over 50 keys, not causal, with its bound and its plain
version's time); K8's backward is ``flash_bwd``, whichever kernels it
launches, beside SDPA's backward by autograd. K2 runs at TSF-B's (8, 4,
196, 768, 12 heads), the fine-tune's 16 frames (8, 16, 196, 768, 12),
TSF-L@336's (8, 4, 576, 1024, 16) and TSF-L@224's (8, 4, 256, 1024, 16),
on strided qkv views, with the launch counter each call bumps (its
branch). Last, the host cost of the LayerNorm forward's calls (K3 at the
three short rows and the patch rows, K4 and K5 at the patch rows) beside
``F.layer_norm``'s (K4/K5: the add and ``F.layer_norm``): CUDA events
over 200 calls issued back to back, and ``time.perf_counter`` over 1,000
calls issued (then over the same calls to their end). ``--repo`` times
another checkout's kernels (an unpacked ``git archive`` of a parent
commit) and then only the device times and the LayerNorm forward's host
costs, which are all that depend on the tree, so that two trees can be
timed in turns in one call:

    python3 scripts/time_library_calls.py [--repo DIR --label NAME] \
        [--out chiprun_out/lib.json]

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.nn import functional as F

HERE = os.path.dirname(os.path.abspath(__file__))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events)."""
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


def _grouped_qkv(qp, kp, vp, ck, cv, axis: str, heads: int):
    """K1/K2's inputs ``(B, F, N, D)`` and CLS rows ``(B, D)`` as SDPA's
    ``(groups, H, S, d)`` query and ``(groups, H, S + 1, d)`` keys and
    values, the CLS row first."""
    B, F_, N, D = qp.shape
    d = D // heads

    def grouped(t):  # (B, G, S, H, d) → (B·G, H, S, d)
        t = t.reshape(B, F_, N, heads, d)
        t = t.transpose(1, 2) if axis == "time" else t
        return t.reshape(-1, t.shape[2], heads, d).transpose(1, 2)

    q, k, v = grouped(qp), grouped(kp), grouped(vp)
    G = q.shape[0] // B

    def with_cls(c, t):
        c = c.reshape(B, 1, heads, 1, d).expand(B, G, heads, 1, d)
        return torch.cat([c.reshape(B * G, heads, 1, d), t], dim=2)

    return (q.contiguous(), with_cls(ck, k).contiguous(),
            with_cls(cv, v).contiguous())


def divided_fwd_call(qp, kp, vp, ck, cv, axis: str, heads: int):
    """K1 (space) / K2 (time) forward as one SDPA call."""
    q, k, v = _grouped_qkv(qp, kp, vp, ck, cv, axis, heads)
    return lambda: F.scaled_dot_product_attention(q, k, v)


def divided_bwd_call(qp, kp, vp, ck, cv, do, axis: str, heads: int):
    """K1/K2 backward: the gradient of that SDPA call for ``do``."""
    q, k, v = (t.detach().requires_grad_()
               for t in _grouped_qkv(qp, kp, vp, ck, cv, axis, heads))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v)
    g = _grouped_qkv(do, do, do, ck, cv, axis, heads)[0]
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def layer_norm_call(x, w, b, eps: float):
    return lambda: F.layer_norm(x, (x.shape[-1],), w, b, eps)


def layer_norm_bwd_call(x, w, b, dy, eps: float):
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    with torch.enable_grad():
        y = F.layer_norm(x, (x.shape[-1],), w, b, eps)
    return lambda: torch.autograd.grad(y, (x, w, b), dy, retain_graph=True)


def add_layer_norm_call(a, b, w, bias, eps: float, return_sum: bool):
    """K4 (``return_sum``: the sum returned too) / K5: the add, then
    ``F.layer_norm`` of the sum (two library calls)."""
    def call():
        s = a + b
        y = F.layer_norm(s, (s.shape[-1],), w, bias, eps)
        return (y, s) if return_sum else y
    return call


def add_layer_norm_bwd_call(a, b, w, bias, dy, dsum, eps: float):
    """K4 (``dsum`` given) / K5 backward: the gradient of that pair of
    calls for (a, b, w, bias)."""
    a, b, w, bias = (t.detach().requires_grad_() for t in (a, b, w, bias))
    with torch.enable_grad():
        out = add_layer_norm_call(a, b, w, bias, eps, dsum is not None)()
    outs, cots = ((out, (dy, dsum)) if dsum is not None else
                  ((out,), (dy,)))
    return lambda: torch.autograd.grad(outs, (a, b, w, bias), cots,
                                       retain_graph=True)


def decode_call(q, k_cache, v_cache, k_new, v_new, num_valid: int,
                heads: int):
    """K9 as SDPA: a ``(B, H, 1, d)`` query over the valid cache rows
    and the current token."""
    B, D = q.shape
    d = D // heads

    def heads_major(t):  # (B, L, D) → (B, H, L, d)
        return t.reshape(B, -1, heads, d).transpose(1, 2)

    k = heads_major(torch.cat([k_cache[:, :num_valid], k_new[:, None]], 1))
    v = heads_major(torch.cat([v_cache[:, :num_valid], v_new[:, None]], 1))
    qh = heads_major(q[:, None])
    return lambda: F.scaled_dot_product_attention(qh, k, v)


def moe_grouped_mm_call(x, weights, idx, w1, w2, w1s, w2s):
    """The expert layer's two grouped products as ``torch._grouped_mm``
    (its rows sorted by expert by torch ops first, outside the timed
    call; the routed and shared experts as one group list); None where
    this PyTorch has no ``_grouped_mm``."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    T, k = idx.shape
    S = w1s.shape[0]
    groups = torch.cat([idx.reshape(-1).long(), w1.shape[0] + torch.arange(
        S, device=x.device).repeat_interleave(T)])
    order = torch.sort(groups, stable=True).indices
    tokens = torch.cat([torch.arange(T * k, device=x.device) // k,
                        torch.arange(T, device=x.device).repeat(S)])
    xs = x[tokens[order]].contiguous()
    counts = torch.bincount(groups, minlength=w1.shape[0] + S)
    offs = counts.cumsum(0).int()
    up = torch.cat([w1, w1s]).transpose(-2, -1)     # (G, D, 2I)
    down = torch.cat([w2, w2s]).transpose(-2, -1)   # (G, I, D)
    inner = w2.shape[2]

    def call():
        gu = torch._grouped_mm(xs, up, offs=offs)
        h = F.silu(gu[:, :inner]) * gu[:, inner:]
        return torch._grouped_mm(h, down, offs=offs)
    return call


def _heads_major(t):
    """(B, L, H, d) → a contiguous (B, H, L, d) copy."""
    return t.transpose(1, 2).contiguous()


def flash_fwd_call(q, k, v, causal: bool):
    """K7 / K8 forward as one SDPA call (the causal mask as its
    ``is_causal``: equal lengths, the same absolute mask)."""
    qh, kh, vh = map(_heads_major, (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)


def flash_bwd_call(q, k, v, do, causal: bool):
    """K8's backward: the gradient of that SDPA call for ``do``."""
    qh, kh, vh = (_heads_major(t).requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    g = _heads_major(do)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), g,
                                       retain_graph=True)


def _cls_row_qkv(cls_q, cls_k, cls_v, kp, vp):
    """The CLS row's inputs (``(B, 1, H, d)`` rows, ``(B, F, N, H, d)``
    patches) as SDPA's ``(B, H, 1, d)`` query and ``(B, H, 1 + F·N, d)``
    keys and values, the CLS row first."""
    B, F_, N, H, d = kp.shape

    def keys(c, p):
        return torch.cat([c, p.reshape(B, F_ * N, H, d)], 1)
    return (_heads_major(cls_q), _heads_major(keys(cls_k, kp)),
            _heads_major(keys(cls_v, vp)))


def cls_row_call(cls_q, cls_k, cls_v, kp, vp):
    """The CLS row's forward as one SDPA call."""
    q, k, v = _cls_row_qkv(cls_q, cls_k, cls_v, kp, vp)
    return lambda: F.scaled_dot_product_attention(q, k, v)


def cls_row_bwd_call(cls_q, cls_k, cls_v, kp, vp, g):
    """The CLS row's backward: the gradient of that SDPA call for ``g``
    ``(B, 1, H, d)``."""
    q, k, v = (t.detach().requires_grad_()
               for t in _cls_row_qkv(cls_q, cls_k, cls_v, kp, vp))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v)
    g = _heads_major(g)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


# K2's shapes (B, F, N, D, heads): TSF-B, the fine-tune's 16 frames,
# TSF-L@336, TSF-L@224
TIME_CASES = ((8, 4, 196, 768, 12), (8, 16, 196, 768, 12),
              (8, 4, 576, 1024, 16), (8, 4, 256, 1024, 16))
# K3 backward's rows: TSF-B's patches, the fine-tune's 16 frames,
# TSF-L@336's patches, the CLS rows of TSF-B and TSF-L at batch 8, and
# the text tower's 8 captions of 77 tokens
LN_BWD_CASES = ((8 * 4 * 196, 768), (8 * 16 * 196, 768),
                (8 * 4 * 576, 1024), (8, 768), (8, 1024), (8, 77, 512))
# K4's and K5's rows: TSF-L@336's patches, the fine-tune's and TSF-B's
ADD_LN_CASES = ((8 * 4 * 576, 1024), (32 * 4 * 196, 768), (8 * 4 * 196, 768))
# K3 forward's rows (shape, eps, flat): TSF-B's patches, a decode step's,
# GPT-2 XL's caption rows, DistilBERT's at its eps with 16 flat rows
LN_FWD_CASES = (((8 * 4 * 196, 768), 1e-6, False),
                ((160, 1, 1600), 1e-6, False), ((8 * 76, 1600), 1e-6, False),
                ((16 * 77, 768), 1e-12, True))


def _flat(x):
    """DistilBERT's flat rows: rows 0-15 at multiples of 1/8 (variance
    0, rstd 1e6 at eps 1e-12)."""
    x[:16] = torch.arange(16, device=x.device)[:, None].to(x.dtype) / 8
    return x


def kernel_device_times(gen) -> list:
    """K2 forward and backward (:data:`TIME_CASES`), K3 forward (TSF-B's
    6272 x 768 rows and a decode step's (160, 1, 1600)) and backward
    (:data:`LN_BWD_CASES`), K4 and K5 forward and backward
    (:data:`ADD_LN_CASES`), K7 and K8's forward and backward (the text
    towers' causal attention: 16 captions x 8 heads, 32 x 12 and 256 x
    8, 77 tokens of 64; K7 also at RN50's attention pool) and K9 (160
    GPT-2 XL rows, 15 valid of 77),
    bf16: the port's kernel and the library call, kernel, library,
    library, kernel, each by the profiler's device time and by CUDA
    events."""
    sys.path.insert(0, HERE)
    from time_spatial_phase import measure

    from lavila_tpu_torch.kernels import decode as KDec
    from lavila_tpu_torch.kernels import divided as KD
    from lavila_tpu_torch.kernels import flash as KF
    from lavila_tpu_torch.kernels import layernorm as KL
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    cases = []
    for B, F_, N, D, H in TIME_CASES:
        q, k, v = rand(B, F_, N, 3 * D).chunk(3, dim=-1)
        _, ck, cv = rand(B, 3 * D).chunk(3, dim=-1)
        scale = (D // H) ** -0.5
        fwd = (q, k, v, ck, cv, "time", H, scale)
        out, lse = KD.divided_phase(*fwd)
        do = rand(B, F_, N, D)
        bwd = (q, k, v, ck, cv, do, out, lse, "time", H, scale)
        cases.append(("K2", [B, F_, N, D, H],
                      lambda fwd=fwd: KD.divided_phase(*fwd),
                      divided_fwd_call(q, k, v, ck, cv, "time", H)))
        cases.append(("K2 bwd", [B, F_, N, D, H],
                      lambda bwd=bwd: KD.divided_phase_bwd(*bwd),
                      divided_bwd_call(q, k, v, ck, cv, do, "time", H)))
    for shape, eps, flat in LN_FWD_CASES:
        x, w, b = rand(*shape), rand(shape[-1]), rand(shape[-1])
        if flat:
            _flat(x)
        cases.append(("K3", list(shape),
                      lambda x=x, w=w, b=b, eps=eps: KL.layer_norm(x, w, b,
                                                                   eps),
                      layer_norm_call(x, w, b, eps)))
    for shape in LN_BWD_CASES:
        x, w, b, dy = rand(*shape), rand(shape[-1]), rand(shape[-1]), \
            rand(*shape)
        cases.append(("K3 bwd", list(shape),
                      lambda x=x, w=w, dy=dy: KL.layer_norm_bwd(x, w, dy,
                                                                1e-6),
                      layer_norm_bwd_call(x, w, b, dy, 1e-6)))
    for shape in ADD_LN_CASES:
        a, r, dy, ds = (rand(*shape) for _ in range(4))
        w, b = rand(shape[-1]), rand(shape[-1])
        for name, dsum in (("K4", ds), ("K5", None)):
            k4 = dsum is not None
            cases.append((name, list(shape),
                          lambda a=a, r=r, w=w, b=b, k4=k4:
                          KL.add_layer_norm(a, r, w, b, 1e-6, k4),
                          add_layer_norm_call(a, r, w, b, 1e-6, k4)))
            # K4 from the saved sum (a) and d(sum); K5 from the pair
            bwd = (a, None, w, dy, ds, 1e-6) if k4 else \
                (a, r, w, dy, None, 1e-6)
            cases.append((f"{name} bwd", list(shape),
                          lambda bwd=bwd: KL.add_layer_norm_bwd(*bwd),
                          add_layer_norm_bwd_call(a, r, w, b, dy, dsum,
                                                  1e-6)))
    scale = 64 ** -0.5
    for B, H in ((16, 8), (32, 12), (256, 8)):
        q, k, v = rand(B, 77, 3 * H * 64).reshape(B, 77, 3 * H, 64).chunk(
            3, dim=2)
        for name, with_lse in (("K7", False), ("K8 fwd", True)):
            cases.append((name, [B, H, 77, 77, 64],
                          lambda q=q, k=k, v=v, w=with_lse: KF._forward(
                              q, k, v, True, scale, w),
                          flash_fwd_call(q, k, v, True)))
        _, lse = KF._forward(q, k, v, True, scale, True)
        do = rand(B, 77, H, 64)
        args = (q, k, v, do, lse, True, scale)
        cases.append(("K8 bwd", [B, H, 77, 77, 64],
                      lambda args=args: KF.flash_bwd(*args),
                      flash_bwd_call(q, k, v, do, True)))
    # CLIP RN50's attention pool (models/resnet_clip.py) at 8 images: one
    # query over the 7·7 + 1 tokens, 32 heads of 64, not causal
    qp, kp, vp = rand(8, 1, 32, 64), rand(8, 50, 32, 64), rand(8, 50, 32, 64)
    cases.append(("K7", [8, 32, 1, 50, 64],
                  lambda: KF._forward(qp, kp, vp, False, scale, False),
                  flash_fwd_call(qp, kp, vp, False)))
    # its bound: q, k, v read and the output written once (bf16), the two
    # products' operations at the bf16 peak (989 TFLOP/s; 3.35 TB/s)
    pool_bytes = 2 * (2 * qp.numel() + kp.numel() + vp.numel())
    pool_flops = 4 * 8 * 32 * 1 * 50 * 64
    bounds = {("K7", (8, 32, 1, 50, 64)): {
        "bound_ms": max(pool_bytes / 3.35e12, pool_flops / 989e12) * 1e3,
        "bound_by": "bytes" if pool_bytes / 3.35e12 >= pool_flops / 989e12
        else "operations"}}
    # and its plain version (the port's reference path, several launches)
    plains = {("K7", (8, 32, 1, 50, 64)):
              lambda: KF.flash_attention_reference(qp, kp, vp, False, scale)}
    qd, kn, vn = rand(160, 3 * 1600).chunk(3, dim=-1)
    kc, vc = rand(160, 77, 1600), rand(160, 77, 1600)
    dec = (qd, kc, vc, kn, vn, 15, 25)
    cases.append(("K9", [160, 77, 1600, 25, 15],
                  lambda: KDec.decode_attention(*dec), decode_call(*dec)))
    lines = []
    counters = [KD.launches, KL.launches, KF.launches, KDec.launches]
    # no_grad, not inference_mode: SDPA's backward runs autograd
    with torch.no_grad():
        for name, shape, kernel, lib in cases:
            before = [dict(c) for c in counters]
            kernel()
            bumped = [k for c, b in zip(counters, before) for k, n in c.items()
                      if n != b[k]]
            runs = {"kernel": [], "library": []}
            for who in ("kernel", "library", "library", "kernel"):
                runs[who].append(measure(kernel if who == "kernel" else lib,
                                         50))
            plain = plains.get((name, tuple(shape)))
            if plain is not None:
                runs["plain"] = [measure(plain, 50) for _ in range(2)]
            lines.append({"kernel": name, "shape": shape, "dtype": "bfloat16",
                          "counter": bumped,
                          **{f"{who}_{k}": [r[k] for r in rs]
                             for who, rs in runs.items()
                             for k in ("device_ms", "event_ms")},
                          "kernels": runs["kernel"][0]["kernels"],
                          "library_kernels": runs["library"][0]["kernels"],
                          **bounds.get((name, tuple(shape)), {})})
    return lines


def _host_ms(fn, calls: int) -> tuple:
    """ms per call of ``calls`` issued back to back by the host's clock:
    the issue alone, and to the last one's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / calls * 1e3, (time.perf_counter() - t0) / calls * 1e3


def ln_fwd_host_costs(gen) -> list:
    """The LayerNorm forward's host cost, bf16: K3 at
    :data:`LN_FWD_CASES`, K4 and K5 at :data:`ADD_LN_CASES`, the port's
    call and the library's, kernel, library, library, kernel: CUDA events
    per call over 200 calls back to back (:func:`time_ms`), and the host
    clock over 1,000 (:func:`_host_ms`)."""
    from lavila_tpu_torch.kernels import layernorm as KL
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    cases = []
    for shape, eps, flat in LN_FWD_CASES:
        x, w, b = rand(*shape), rand(shape[-1]), rand(shape[-1])
        if flat:
            _flat(x)
        cases.append(("K3", shape, lambda x=x, w=w, b=b, eps=eps:
                      KL.layer_norm(x, w, b, eps),
                      layer_norm_call(x, w, b, eps)))
    for shape in ADD_LN_CASES:
        a, r = rand(*shape), rand(*shape)
        w, b = rand(shape[-1]), rand(shape[-1])
        for name, k4 in (("K4", True), ("K5", False)):
            cases.append((name, shape, lambda a=a, r=r, w=w, b=b, k4=k4:
                          KL.add_layer_norm(a, r, w, b, 1e-6, k4),
                          add_layer_norm_call(a, r, w, b, 1e-6, k4)))
    lines = []
    with torch.inference_mode():
        for name, shape, kernel, lib in cases:
            runs = {"kernel": [], "library": []}
            for who in ("kernel", "library", "library", "kernel"):
                fn = kernel if who == "kernel" else lib
                issue, wall = _host_ms(fn, 1000)
                runs[who].append({"event_ms": time_ms(fn, 200, 10),
                                  "host_issue_ms": issue,
                                  "host_wall_ms": wall})
            lines.append({"kernel": name, "shape": list(shape),
                          "dtype": "bfloat16", "host_cost": True,
                          **{f"{who}_{k}": [r[k] for r in rs]
                             for who, rs in runs.items()
                             for k in ("event_ms", "host_issue_ms",
                                       "host_wall_ms")}})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default="",
                    help="time this checkout's kernels (device times only)")
    ap.add_argument("--label", default="",
                    help="a name for the tree, copied into every line")
    ap.add_argument("--out", default="", help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_library_calls: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo or os.path.dirname(HERE)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.repo:
        lines = kernel_device_times(gen) + ln_fwd_host_costs(gen)
        _write(lines, smi, args)
        return 0
    lines = []

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for kern, axis, shape, heads in (
                ("K1", "space", (8, 4, 196, 768), 12),
                ("K2", "time", (8, 4, 196, 768), 12),
                ("K2", "time", (8, 16, 196, 768), 12),
                ("K6", "space", (8, 4, 576, 1024), 16),
                ("K2", "time", (8, 4, 576, 1024), 16)):
            qp, kp, vp, do = (rand(*shape, dtype=dtype) for _ in range(4))
            ck, cv = (rand(shape[0], shape[3], dtype=dtype) for _ in range(2))
            lines.append({"kernel": kern, "shape": list(shape), "dtype": name,
                          "library_ms": time_ms(divided_fwd_call(
                              qp, kp, vp, ck, cv, axis, heads))})
            lines.append({"kernel": f"{kern} bwd", "shape": list(shape),
                          "dtype": name, "library_ms": time_ms(
                              divided_bwd_call(qp, kp, vp, ck, cv, do, axis,
                                               heads))})
            del qp, kp, vp, do
        for shape in ((8 * 4 * 576, 1024), (32 * 4 * 196, 768)):
            a, b, dy, ds = (rand(*shape, dtype=dtype) for _ in range(4))
            w, bias = (rand(shape[-1], dtype=dtype) for _ in range(2))
            for kern, dsum in (("K4", ds), ("K5", None)):
                lines.append({"kernel": kern, "shape": list(shape),
                              "dtype": name, "calls": 2, "library_ms":
                              time_ms(add_layer_norm_call(
                                  a, b, w, bias, 1e-6, dsum is not None))})
                lines.append({"kernel": f"{kern} bwd", "shape": list(shape),
                              "dtype": name, "library_ms": time_ms(
                                  add_layer_norm_bwd_call(a, b, w, bias, dy,
                                                          dsum, 1e-6))})
        for shape in ((8 * 4 * 196, 768), (8, 77, 512), (160, 1, 1600)):
            x, dy = rand(*shape, dtype=dtype), rand(*shape, dtype=dtype)
            w, b = rand(shape[-1], dtype=dtype), rand(shape[-1], dtype=dtype)
            lines.append({"kernel": "K3", "shape": list(shape), "dtype": name,
                          "library_ms": time_ms(layer_norm_call(x, w, b,
                                                                1e-6))})
            lines.append({"kernel": "K3 bwd", "shape": list(shape),
                          "dtype": name, "library_ms": time_ms(
                              layer_norm_bwd_call(x, w, b, dy, 1e-6))})
        for B, K, D, H in ((160, 77, 1600, 25), (16, 77, 768, 12)):
            q, kn, vn = (rand(B, D, dtype=dtype) for _ in range(3))
            kc, vc = (rand(B, K, D, dtype=dtype) for _ in range(2))
            for nv in (1, 15, 77):
                lines.append({"kernel": "K9", "shape": [B, K, D, H],
                              "num_valid": nv, "dtype": name,
                              "library_ms": time_ms(decode_call(
                                  q, kc, vc, kn, vn, nv, H))})
        # the CLIP text towers' causal attention (TSF-B: 8 heads, TSF-L:
        # 12) at 16 and 256 captions, and an uneven non-causal case
        for B, H, Lq, Lk, causal in ((16, 8, 77, 77, True),
                                     (256, 8, 77, 77, True),
                                     (16, 12, 77, 77, True),
                                     (2, 3, 130, 260, False)):
            q, do = rand(B, Lq, H, 64, dtype=dtype), rand(B, Lq, H, 64,
                                                           dtype=dtype)
            k, v = (rand(B, Lk, H, 64, dtype=dtype) for _ in range(2))
            shape = [B, H, Lq, Lk, 64]
            lines.append({"kernel": "K7/K8 fwd", "shape": shape,
                          "causal": causal, "dtype": name, "library_ms":
                          time_ms(flash_fwd_call(q, k, v, causal))})
            lines.append({"kernel": "K8 bwd", "shape": shape,
                          "causal": causal, "dtype": name, "library_ms":
                          time_ms(flash_bwd_call(q, k, v, do, causal))})
    lines += kernel_device_times(gen) + ln_fwd_host_costs(gen)
    _write(lines, smi, args)
    return 0


def _write(lines, smi: str, args) -> None:
    """Print the lines, with the card and the tree's label; append them
    to ``--out``."""
    lines = [{"device": smi, "tree": args.label, **line} for line in lines]
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    sys.exit(main())
