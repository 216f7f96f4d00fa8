"""Zero-shot video embedding: ``encode_image`` of the dual encoder (bf16
weights, inference mode), one call of ``batch`` clips a unit, the
embeddings copied to the host at its end.

The window's answers are all kept. After the window the reference
embeds each batch of the pool once, and the check takes every call's
rows against it: ``embed_err`` is the largest relative L2 distance of a
row, ``|program - reference| / |reference|``.
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark.drivers import DTYPES, build_program, reference_weights
from benchmark.portbench import compare as C
from benchmark.portbench import traffic as T
from benchmark.reference import models as R
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.roofline import model_flops


def p95(values: list[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        self.spec = R.dual_encoder_spec(cfg)
        self.dtype = DTYPES[cfg["dtype"]]
        self.model = build_program(ctx, self.spec, self.dtype, train=False,
                                   num_frames=cfg["tower"]["num_frames"])
        t0 = time.perf_counter()
        self.frames = T.clips(t, cfg["tower"], ctx.seed, ctx.device,
                              self.dtype)
        ctx.sync()
        t0 = ctx.timed("inputs", t0)
        self.outputs = None  # the warm-up's answers are not kept
        for i in range(t["warmup"]):
            self.unit(i)
        ctx.timed("warmup", t0)
        self.outputs = []

    def unit(self, i: int) -> dict:
        j = i % self.frames.shape[0]
        t0 = time.perf_counter()
        with torch.inference_mode():
            e = self.model.encode_image(self.frames[j])
        issue = time.perf_counter() - t0
        out = e.float().cpu()
        if self.outputs is not None:
            self.outputs.append((j, out))
        return {"work": self.frames.shape[1], "issue_s": issue}

    def end_to_end(self, window) -> dict:
        lat = [u["end"] - u["start"] for u in window.units]
        return {"encode_clips_per_s": window.work / window.elapsed,
                "encode_ms_p95": p95(lat) * 1e3}

    def describe(self, window) -> dict:
        lat = sorted(u["end"] - u["start"] for u in window.units)
        return {"calls": len(lat), "call_ms_median": 1e3 * lat[len(lat) // 2],
                "p95_samples_beyond": len(lat) - int(0.95 * len(lat)),
                "model_flops_per_call": model_flops.encode(
                    self.ctx.cfg, self.ctx.traffic["batch"])}

    def attempted(self, window) -> int:
        return len(window.units)

    def release(self) -> None:
        self.model = None

    def reference_embeddings(self, num: Numerics) -> list[torch.Tensor]:
        strict_fp32()
        p = reference_weights(self.ctx, self.spec, self.dtype)
        with torch.no_grad():
            return [R.encode_image(p, f, self.ctx.cfg, num).cpu()
                    for f in self.frames]

    @staticmethod
    def row_errors(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        return (torch.linalg.vector_norm(got - ref, dim=-1)
                / torch.linalg.vector_norm(ref, dim=-1))

    def check(self, window):
        ref = self.reference_embeddings(Numerics("fp32"))
        limit = self.ctx.cell["check"]["limits"]["embed_err"]
        errs = [float(self.row_errors(out, ref[j]).max())
                for j, out in self.outputs]
        checks = [C.check("embed_err", max(errs), limit)]
        extra = {"calls_checked": len(errs)}
        extra["control"] = {
            mode: {"embed_err": max(
                float(self.row_errors(c, r).max()) for c, r in zip(
                    self.reference_embeddings(Numerics(mode)), ref))}
            for mode in self.ctx.controls}
        return checks, sum(e > limit for e in errs), extra
