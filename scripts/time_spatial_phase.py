#!/usr/bin/env python3
"""Time the spatial divided-attention phase (K1, and K6 on the same
input) on one NVIDIA GPU, by CUDA events and by the device time that
``torch.profiler`` reads for each kernel.

For each case (B, F, N, D, heads), bf16, q/k/v as the column blocks of
one ``(B, F, N, 3D)`` tensor and ck/cv as those of one ``(B, 3D)`` row
(as the attention block hands them over), it times:

  * K1 forward and backward through the port's wrapper
    (``kernels/divided.py``: ``divided_phase``, ``divided_phase_bwd``);
  * K6's C entry points (``lavila_divided_space_big_fwd``/``_bwd``)
    called directly on the same input, N ≤ 256 included, which the
    wrapper never routes there;
  * SDPA forward and backward with the CLS key concatenated
    (``scripts/time_library_calls.py``).

Each line gives the event time (mean of ``--iters`` back-to-back calls,
the wrapper's host cost included), the profiler's device time per call
summed over the kernels it launched, and those kernels by name.
``--repo`` imports ``lavila_tpu_torch`` from another checkout (an
unpacked ``git archive`` of a parent commit), so that two trees can be
timed in turns in one call:

    python3 scripts/time_spatial_phase.py [--repo DIR] [--label NAME] \\
        [--out k1.jsonl]

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = ((8, 4, 196, 768, 12), (32, 4, 196, 768, 12),
         (8, 4, 256, 1024, 16))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def measure(fn, iters: int) -> dict:
    """Event ms per call, then the profiler's device ms per call and the
    kernels it ran (name: ms per call, launches per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key[:80]: (_device_us(e) / iters / 1e3, e.count / iters)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Command Buffer")}
    device = sum(t for t, _ in kernels.values())
    return {"event_ms": ms,
            "device_ms": device if kernels else "not measured",
            "kernels": {k: {"ms": t, "launches": c}
                        for k, (t, c) in kernels.items()}}


def _inputs(B, F, N, D, gen):
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device="cuda").to(
        torch.bfloat16)
    cls = torch.randn(B, 3 * D, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = cls.chunk(3, dim=-1)
    do = torch.randn(B, F, N, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, k, v, ck, cv, do


def k6_calls(build, q, k, v, ck, cv, do, out, lse, H, scale):
    """K6's forward and backward C entry points on K1's input (fp32 or
    bf16; ``do`` is read only by the backward)."""
    lib = build.library()
    dtype = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    B, F, N, D = q.shape
    strides = [build.row_stride(t, n) for t, n in
               ((q, "q"), (k, "k"), (v, "v"), (ck, "ck"), (cv, "cv"))]
    stream = torch.cuda.current_stream().cuda_stream
    o6 = torch.empty_like(out)
    l6 = torch.empty_like(lse)
    grads = [torch.empty_like(out) for _ in range(3)]
    grads += [torch.empty_like(ck, memory_format=torch.contiguous_format)
              for _ in range(2)]
    parts = [torch.empty((B, F, D), dtype=torch.float32, device="cuda")
             for _ in range(2)]
    delta = torch.empty_like(lse)

    def fwd():
        err = lib.lavila_divided_space_big_fwd(
            *(t.data_ptr() for t in (q, k, v, ck, cv, o6, l6)), B, F, N, H,
            D // H, *strides, scale, dtype, stream)
        build.check(err, "space_big_fwd")

    def bwd():
        err = lib.lavila_divided_space_big_bwd(
            *(t.data_ptr() for t in (q, k, v, ck, cv, do, out, lse, delta,
                                     *grads, *parts)), B, F, N, H, D // H,
            *strides, scale, dtype, stream)
        build.check(err, "space_big_bwd")
    return fwd, bwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(HERE),
                    help="the checkout whose lavila_tpu_torch is timed")
    ap.add_argument("--label", default="",
                    help="a name for the tree, copied into every line")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="", help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_spatial_phase: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    sys.path.insert(0, HERE)
    import time_library_calls as lib_calls

    from lavila_tpu_torch.kernels import build
    from lavila_tpu_torch.kernels import divided as KD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for B, F, N, D, H in CASES:
        q, k, v, ck, cv, do = _inputs(B, F, N, D, gen)
        scale = (D // H) ** -0.5
        with torch.no_grad():
            out, lse = KD.divided_phase(q, k, v, ck, cv, "space", H, scale)
            bwd_args = (q, k, v, ck, cv, do, out, lse, "space", H, scale)
            k6_fwd, k6_bwd = k6_calls(build, q, k, v, ck, cv, do, out,
                                      lse, H, scale)
            timed = {
                "K1 fwd": lambda: KD.divided_phase(q, k, v, ck, cv, "space",
                                                   H, scale),
                "K1 bwd": lambda: KD.divided_phase_bwd(*bwd_args),
                "K6 fwd": k6_fwd, "K6 bwd": k6_bwd,
                "SDPA fwd": lib_calls.divided_fwd_call(q, k, v, ck, cv,
                                                       "space", H),
                "SDPA bwd": lib_calls.divided_bwd_call(q, k, v, ck, cv, do,
                                                       "space", H)}
            for name, fn in timed.items():
                line = {"tree": args.label, "what": name,
                        "shape": [B, F, N, D, H], "dtype": "bfloat16",
                        **measure(fn, args.iters)}
                lines.append(line)
                print(json.dumps(line), flush=True)
        del q, k, v, ck, cv, do, out, lse
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps({"device": smi, "tree": args.label}) + "\n")
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
