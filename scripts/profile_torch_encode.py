#!/usr/bin/env python3
"""Where the time of the PyTorch port's zero-shot encoders goes, on one
NVIDIA GPU: ``encode_image`` and ``encode_text`` of a zoo model with seeded
weights, timed with CUDA events, then traced with ``torch.profiler`` for a
per-kernel breakdown of device time, the kernel launches per call and
the device's idle share; the flash kernels' share (K7/K8, the CLIP text
tower's attention) and the LayerNorm backward's (every kernel whose name
holds ``ln_bwd``: K3/K4/K5 backward) are reported on their own. With ``--train``, the same
for one dual-encoder train step (AdamW, the CLI's defaults) instead.

    python3 scripts/profile_torch_encode.py [--batch 32] [--bf16] \\
        [--train [--remat]] [--model NAME] [--out profile.json]

Prints one JSON object (also written to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(fn, iters: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
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
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    # device kernels only: CPU-side ops and ranges (aten::, autograd
    # nodes) and annotations mirrored on the device's timeline
    # (Optimizer.step) also carry their kernels' device time, and the
    # profiler's own "Command Buffer Full" markers are no kernels
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Command Buffer")]
    busy = sum(r[1] for r in kernels)
    kernels.sort(key=lambda r: -r[1])
    flash = [r for r in kernels if "flash_" in r[0]]
    ln_bwd = [r for r in kernels if "ln_bwd" in r[0]]
    return {"ms_per_call": ms, "traced_wall_ms_per_call": wall_us / iters
            / 1e3, "device_busy_ms_per_call": busy / iters / 1e3,
            "idle_share": max(0.0, 1 - busy / wall_us),
            "launches_per_call": sum(r[2] for r in kernels) / iters,
            "flash_ms_per_call": sum(r[1] for r in flash) / iters / 1e3,
            "flash_launches_per_call": sum(r[2] for r in flash) / iters,
            "ln_bwd_ms_per_call": sum(r[1] for r in ln_bwd) / iters / 1e3,
            "ln_bwd_launches_per_call": sum(r[2] for r in ln_bwd) / iters,
            "top_kernels": [{"kernel": k[:120], "ms_per_call": t / iters
                             / 1e3, "share": t / busy, "calls": c / iters}
                            for k, t, c in kernels[:25]]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="CLIP_OPENAI_TIMESFORMER_BASE")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="profile the train step, not the encoders")
    p.add_argument("--remat", action="store_true",
                   help="the video tower with remat (--use-checkpoint)")
    p.add_argument("--out", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_encode: needs a CUDA device")
    from lavila_tpu_torch.models import build_model
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # the train step keeps fp32 masters and makes its own working copy
    model = build_model(args.model, device="cuda",
                        dtype=torch.float32 if args.train else dtype,
                        generator=torch.Generator().manual_seed(0),
                        num_frames=args.frames, train=args.train,
                        remat=args.remat)
    size = model.visual.patch_embed.proj.kernel_size[0] * int(
        model.visual.num_patches ** 0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn(args.batch, args.frames, size, size, 3,
                         generator=gen, device="cuda")
    text = torch.randint(1, 49408, (args.batch, 77), generator=gen,
                         device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": smi, "model": args.model, "batch": args.batch,
           "frames": args.frames, "dtype": str(dtype)}
    if args.train:
        from lavila_tpu_torch.train.optim import make_optimizer
        from lavila_tpu_torch.train.step import (TrainState,
                                                 make_clip_train_step)
        state = TrainState.create(
            model, lambda params: make_optimizer(params, 3e-5), dtype=dtype)
        step = make_clip_train_step()
        batch = {"frames": frames, "text": text}
        out["train_step"] = profile(lambda: step(state, batch), args.iters)
        out["train_step"]["clips_per_s"] = (
            args.batch / out["train_step"]["ms_per_call"] * 1e3)
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    else:
        with torch.inference_mode():
            out["encode_image"] = profile(
                lambda: model.encode_image(frames), args.iters)
            out["encode_text"] = profile(lambda: model.encode_text(text),
                                         args.iters)
        out["encode_image"]["clips_per_s"] = (
            args.batch / out["encode_image"]["ms_per_call"] * 1e3)
    text_out = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text_out)
    print(text_out)


if __name__ == "__main__":
    main()
