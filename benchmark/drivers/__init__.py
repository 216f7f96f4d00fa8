"""The traffic kinds, one driver each: ``train`` (pretraining steps),
``encode`` (zero-shot video embedding calls) and ``narrate`` (the
narrator's sampled captions). A driver is a ``Driver(ctx)`` whose
constructor is the set-up, with ``unit(i)`` (one unit of the window,
ended at a synchronise or a copy to the host), ``end_to_end(window)``,
``describe(window)``, ``attempted(window)``, ``release()`` (frees the
program) and ``check(window)`` (the comparison with the reference, run
after ``release``), and optionally ``min_units``, the units the window
runs at least (those its check compares)."""

from __future__ import annotations

import time

import torch

from benchmark.portbench import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_program(ctx, spec, dtype, train: bool, **kwargs):
    """The port's model, built by ``models.build_model`` on the device,
    then holding the weights drawn from the seed (in ``dtype``)."""
    t0 = time.perf_counter()
    if ctx.device != "cpu":
        from lavila_tpu_torch.kernels import build
        build.library()  # builds the kernel library on a checkout's first run
        t0 = ctx.timed("kernel_library", t0)
    from lavila_tpu_torch.models import build_model
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    model = build_model(ctx.cfg["model"], device=ctx.device, dtype=dtype,
                        generator=gen, train=train, **kwargs)
    t0 = ctx.timed("build_model", t0)
    W.load(model, W.draw(spec, ctx.seed, ctx.device, dtype,
                         ctx.cfg["scalars"]))
    ctx.sync()
    ctx.timed("weights", t0)
    return model


def reference_weights(ctx, spec, dtype) -> dict:
    """The same weights again, as float32 leaves for the reference."""
    return {k: v.float() for k, v in W.draw(
        spec, ctx.seed, ctx.device, dtype, ctx.cfg["scalars"]).items()}
