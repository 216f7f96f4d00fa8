"""Pretraining steps of the dual encoder: ``make_clip_train_step`` over a
``TrainState`` (bf16 compute on fp32 masters, AdamW), one step a unit,
each batch from the pool in turn, the unit ended by a synchronise.

Set-up builds the one ``TrainState`` and drives it through its first
``check.steps`` steps on the pool's first batches, through the same step
function the window calls. It keeps each step's loss, the first gradient
as AdamW holds it after one step (``exp_avg / (1 - beta1)``), and the
masters' change after the last of those steps; the window then goes on
from that state, and its first ``check.window_steps`` units keep their
losses too (on the device, read after the window), so that the steps
the window times, warm, are compared as well. The compared steps take
the pool's batches in turn, rows that all differ. After the window the
reference takes the same initial weights and batches through as many
steps of its own, and the check compares, by the worst step or leaf
(``portbench.compare``): ``loss_gap`` (relative, over every compared
step), ``grad_gap`` and ``change_gap`` (after the set-up's steps).
"""

from __future__ import annotations

import time

import torch

from benchmark.drivers import DTYPES, build_program, reference_weights
from benchmark.portbench import compare as C
from benchmark.portbench import traffic as T
from benchmark.reference import models as R
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.roofline import model_flops


class Driver:
    def __init__(self, ctx):
        from lavila_tpu_torch.train.optim import make_optimizer
        from lavila_tpu_torch.train.step import (TrainState,
                                                 make_clip_train_step)
        self.ctx = ctx
        cfg, t, opt = ctx.cfg, ctx.traffic, ctx.cfg["optimizer"]
        self.spec = R.dual_encoder_spec(cfg)
        model = build_program(ctx, self.spec, torch.float32, train=True,
                              num_frames=cfg["tower"]["num_frames"],
                              remat=cfg["remat"],
                              remat_policy=cfg["remat_policy"])
        t0 = time.perf_counter()
        self.state = TrainState.create(
            model, lambda params: make_optimizer(
                params, opt["lr"], weight_decay=opt["weight_decay"],
                betas=tuple(opt["betas"]), eps=opt["eps"]),
            dtype=DTYPES[cfg["dtype"]])
        self.step = make_clip_train_step(norm_embed=cfg["norm_embed"])
        t0 = ctx.timed("train_state", t0)
        self.frames = T.clips(t, cfg["tower"], ctx.seed, ctx.device,
                              DTYPES[cfg["dtype"]])
        self.ids, self.mask = T.captions(t, ctx.seed, ctx.device)
        ctx.sync()
        t0 = ctx.timed("inputs", t0)
        self.first = self._first_steps(ctx.cell["check"]["steps"])
        ctx.timed("first_steps", t0)
        self.n = ctx.cell["check"]["steps"]
        self.min_units = ctx.cell["check"]["window_steps"]
        self.window_losses = []

    def batch(self, i: int) -> dict:
        j = i % self.frames.shape[0]
        return {"frames": self.frames[j], "text": self.ids[j],
                "mask": self.mask[j]}

    def _first_steps(self, steps: int) -> dict:
        state, losses = self.state, []
        for i in range(steps):
            state, m = self.step(state, self.batch(i))
            losses.append(m["loss"])
            if i == 0:
                b1 = self.ctx.cfg["optimizer"]["betas"][0]
                inner = state.optimizer.inner
                # a step that left no moments has handed AdamW nothing
                grad = C.leaf_norms({
                    n: inner.state[p].get("exp_avg", torch.zeros_like(p))
                    / (1 - b1) for n, p in state.params.items()})
        self.state = state
        start = reference_weights(self.ctx, self.spec, torch.float32)
        change = C.leaf_norms({n: p.detach() - start[n]
                               for n, p in state.params.items()})
        return {"loss": [float(x) for x in losses], "grad": grad,
                "change": change}

    def unit(self, i: int) -> dict:
        b = self.batch(self.n + i)
        t0 = time.perf_counter()
        self.state, m = self.step(self.state, b)
        issue = time.perf_counter() - t0
        if i < self.ctx.cell["check"]["window_steps"]:
            self.window_losses.append(m["loss"])
        self.ctx.sync()
        return {"work": self.frames.shape[1], "issue_s": issue}

    def end_to_end(self, window) -> dict:
        return {"train_clips_per_s": window.work / window.elapsed}

    def describe(self, window) -> dict:
        t = self.ctx.traffic
        return {"first_losses": self.first["loss"],
                "model_flops_per_step": model_flops.train_step(
                    self.ctx.cfg, t["batch"], t["captions"]["text_len"])}

    def attempted(self, window) -> int:
        return len(window.units)

    def release(self) -> None:
        self.state = None
        self.step = None

    def reference_readings(self, num: Numerics, half: bool = False) -> dict:
        """The reference's steps from the same weights and batches:
        losses, first gradient and change norms. ``half``: the loss of
        the first step over the first half of the batch (a fault's
        reading), no steps."""
        ctx, cfg = self.ctx, self.ctx.cfg
        strict_fp32()
        params = {k: v.clone().requires_grad_(True) for k, v in
                  reference_weights(ctx, self.spec, torch.float32).items()}
        if half:
            b = self.batch(0)
            h = b["frames"].shape[0] // 2
            with torch.no_grad():
                loss = R.clip_loss(params, {k: v[:h] for k, v in b.items()},
                                   cfg, num)
            return {"loss": [float(loss)]}
        opt = cfg["optimizer"]
        adamw = R.AdamW(params, opt["lr"], opt["weight_decay"],
                        tuple(opt["betas"]), opt["eps"])
        losses, grad, change = [], None, None
        check = ctx.cell["check"]
        start = reference_weights(ctx, self.spec, torch.float32)
        for i in range(check["steps"] + check["window_steps"]):
            loss = R.clip_loss(params, self.batch(i), cfg, num,
                               remat=cfg["remat"])
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            if i == 0:
                grad = C.leaf_norms(grads)
            adamw.step(params, grads)
            losses.append(float(loss.detach()))
            del grads, loss
            if i + 1 == check["steps"]:
                change = C.leaf_norms({n: p.detach() - start[n]
                                       for n, p in params.items()})
        return {"loss": losses, "grad": grad, "change": change}

    def gaps(self, got: dict, ref: dict) -> dict:
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
        grad, grad_at = C.worst_leaf_gap(got["grad"], ref["grad"])
        change, change_at = C.worst_leaf_gap(
            got["change"], ref["change"], C.moved_leaves(ref["grad"]))
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
                "grad_leaf": grad_at, "change_leaf": change_at}

    def check(self, window):
        got = dict(self.first, loss=self.first["loss"] + [
            float(x) for x in self.window_losses])
        ref = self.reference_readings(Numerics("fp32"))
        if len(got["loss"]) != len(ref["loss"]):
            raise RuntimeError(f"{len(got['loss'])} steps kept, the "
                               f"reference took {len(ref['loss'])}")
        gaps = self.gaps(got, ref)
        limits = self.ctx.cell["check"]["limits"]
        checks = [C.check(k, gaps[k], limits[k])
                  for k in ("loss_gap", "grad_gap", "change_gap")]
        failed = sum(abs(a - b) / abs(b) > limits["loss_gap"]
                     for a, b in zip(got["loss"], ref["loss"]))
        extra = {"program": gaps, "reference_loss": ref["loss"],
                 "program_loss": got["loss"]}
        extra["control"] = {
            mode: self.gaps(self.reference_readings(Numerics(mode)), ref)
            for mode in self.ctx.controls}
        if self.ctx.controls:
            half = self.reference_readings(Numerics("fp32"), half=True)
            extra["half_batch_loss_gap"] = abs(
                half["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
        return checks, int(failed), extra
