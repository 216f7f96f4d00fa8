#!/usr/bin/env python3
"""Time the spatial divided-attention phase (K1 for N <= 256, K6 past
it) on one NVIDIA GPU, by CUDA events and by the device time that
``torch.profiler`` reads for each kernel.

For each case (B, F, N, D, heads), bf16, q/k/v as the column blocks of
one ``(B, F, N, 3D)`` tensor and ck/cv as those of one ``(B, 3D)`` row
(as the attention block hands them over), it times:

  * the phase forward and backward through the port's wrapper
    (``kernels/divided.py``: ``divided_phase``, ``divided_phase_bwd``),
    which takes K1's or K6's C entry points by N, with the launch counter
    the call bumps (its kernel and branch);
  * SDPA forward and backward with the CLS key concatenated
    (``scripts/time_library_calls.py``), the yardstick.

Each line gives the event time (mean of ``--iters`` back-to-back calls,
the wrapper's host cost included), the profiler's device time per call
summed over the kernels it launched, and those kernels by name. The
cases: TSF-B (N = 196) at batch 8 and 32, TSF-L@224 (256), TSF-L@336
(576) at batch 8 and at the remat step's 32, and a ragged 441 (21 x 21
patches) at TSF-B width. ``--repo`` imports ``lavila_tpu_torch`` from
another checkout (an unpacked ``git archive`` of a parent commit), so
that two trees can be timed in turns in one call:

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
         (8, 4, 256, 1024, 16), (8, 4, 576, 1024, 16),
         (32, 4, 576, 1024, 16), (8, 4, 441, 768, 12))


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
        kernel = "K1" if N <= 256 else "K6"
        with torch.no_grad():
            out, lse = KD.divided_phase(q, k, v, ck, cv, "space", H, scale)
            bwd_args = (q, k, v, ck, cv, do, out, lse, "space", H, scale)
            timed = {
                f"{kernel} fwd": lambda: KD.divided_phase(
                    q, k, v, ck, cv, "space", H, scale),
                f"{kernel} bwd": lambda: KD.divided_phase_bwd(*bwd_args),
                "SDPA fwd": lib_calls.divided_fwd_call(q, k, v, ck, cv,
                                                       "space", H),
                "SDPA bwd": lib_calls.divided_bwd_call(q, k, v, ck, cv, do,
                                                       "space", H)}
            for name, fn in timed.items():
                line = {"tree": args.label, "what": name,
                        "shape": [B, F, N, D, H], "dtype": "bfloat16"}
                if name.startswith("K"):  # the launch counter it bumps
                    before = dict(KD.launches)
                    fn()
                    line["counter"] = [key for key, n in KD.launches.items()
                                       if n != before[key]]
                line.update(measure(fn, args.iters))
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
