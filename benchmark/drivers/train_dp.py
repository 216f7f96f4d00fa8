"""Data-parallel pretraining over the cell's cards: the ``train`` driver's
steps, one rank a card, each rank on its own shard of every global batch.

The harness's process is rank 0. Set-up builds the port's kernel library
once, starts the other ranks (this module run as a program, one process
a rank), and every rank joins one process group through the port's own
bootstrap (``parallel/mesh.py:init_process_group``, NCCL on the cards,
gloo on the CPU, ``tcp://localhost:<free port>``). Every rank then
builds the program as the ``train`` driver does (``build_model``,
``TrainState``, ``make_clip_train_step``) from the same seeded weights,
rank 0's state sent to the others (``mesh.broadcast_params``), and makes
the whole pool from the seed, keeping its rows ``[rank·b, (rank + 1)·b)``
of each global batch (``b`` = batch ÷ ranks). The step's loss gathers
the ranks' embeddings, so it is the global batch's InfoNCE, and the
step averages the gradients over the ranks (the ``update.average``
span).

Rank 0 leads: before each thing the ranks do together (a step, freeing
the program, a reference pass, the end) it broadcasts a command, and the
other ranks wait for it. A unit is one global step, its work the global
batch.

The check is the ``train`` driver's (``loss_gap``, ``grad_gap``,
``change_gap``, by the cell's limits) against a reference of the global
batch, split over the ranks: each rank computes its shard's embeddings
in float32, gathers the others' (``torch.distributed``'s own
``all_gather``, not differentiated), and differentiates the global loss
through its own rows; the ranks' gradients summed are the global
gradient (the logit scale's, which every rank reaches directly, divided
by the ranks). Every rank then takes the same AdamW step. At the end
every rank makes one last collective and leaves the group at the same
point; rank 0 then waits for the other ranks to exit.
"""

from __future__ import annotations

import argparse
import atexit
import gc
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from benchmark.drivers import DTYPES, build_program, reference_weights
from benchmark.drivers import train
from benchmark.portbench import compare as C
from benchmark.portbench import files, guard, harness
from benchmark.portbench import traffic as T
from benchmark.reference import models as R
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.roofline import model_flops

# the commands rank 0 broadcasts: (command, argument, argument)
STEP, RELEASE, REFERENCE, STOP = range(4)
# a reference pass's numerics, by the index the command carries
MODES = ("fp32",) + harness.CONTROLS
# the module each other rank runs
WORKER = "benchmark.drivers.train_dp"
# seconds any collective may wait (the traced window's summary keeps
# the other ranks waiting on rank 0), and rank 0 on the others' exit
TIMEOUT_S = 300
EXIT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver(train.Driver):
    def __init__(self, ctx, rank: int = 0, port: int | None = None):
        from lavila_tpu_torch.parallel import mesh
        from lavila_tpu_torch.train.optim import make_optimizer
        from lavila_tpu_torch.train.step import (TrainState,
                                                 make_clip_train_step)
        self.ctx, self.rank, self.ranks = ctx, rank, []
        cfg, t, opt = ctx.cfg, ctx.traffic, ctx.cfg["optimizer"]
        self.world = t["ranks"]
        t0 = time.perf_counter()
        if ctx.device != "cpu":
            from lavila_tpu_torch.kernels import build
            build.library()  # built once, before the other ranks load it
            t0 = ctx.timed("kernel_library", t0)
        if rank == 0:
            port = free_port()
            self._start_ranks(port)
        mesh.init_process_group(mesh.backend_for(ctx.device),
                                f"tcp://localhost:{port}", self.world, rank,
                                timeout=TIMEOUT_S)
        self.comm = (torch.device("cuda", torch.cuda.current_device())
                     if ctx.device != "cpu" else torch.device("cpu"))
        ctx.timed("ranks", t0)
        self.spec = R.dual_encoder_spec(cfg)
        model = build_program(
            ctx, self.spec, torch.float32, train=True,
            num_frames=cfg["tower"]["num_frames"], remat=cfg["remat"],
            remat_policy=cfg["remat_policy"])
        t0 = time.perf_counter()
        self.state = TrainState.create(
            model, lambda params: make_optimizer(
                params, opt["lr"], weight_decay=opt["weight_decay"],
                betas=tuple(opt["betas"]), eps=opt["eps"]),
            dtype=DTYPES[cfg["dtype"]])
        mesh.broadcast_params(self.state)
        self.step = make_clip_train_step(norm_embed=cfg["norm_embed"])
        t0 = ctx.timed("train_state", t0)
        b = t["batch"] // self.world
        rows = slice(rank * b, (rank + 1) * b)
        pool = (T.clips(t, cfg["tower"], ctx.seed, ctx.device,
                        DTYPES[cfg["dtype"]]),
                *T.captions(t, ctx.seed, ctx.device))
        self.frames, self.ids, self.mask = (x[:, rows].contiguous()
                                            for x in pool)
        del pool
        ctx.sync()
        t0 = ctx.timed("inputs", t0)
        self.first = self._first_steps(ctx.cell["check"]["steps"])
        ctx.timed("first_steps", t0)
        self.n = ctx.cell["check"]["steps"]
        self.min_units = ctx.cell["check"]["window_steps"]
        self.window_losses = []

    # ---- rank 0's lead

    def _start_ranks(self, port: int) -> None:
        import lavila_tpu_torch
        ctx = self.ctx
        env = dict(os.environ)
        # the port's package wherever this process found it
        path = str(Path(lavila_tpu_torch.__file__).resolve().parents[1])
        env["PYTHONPATH"] = ":".join(
            p for p in (str(ctx.root), path, env.get("PYTHONPATH")) if p)
        for r in range(1, self.world):
            self.ranks.append(subprocess.Popen(
                [sys.executable, "-m", WORKER, "--root", str(ctx.root),
                 "--workload", ctx.cell["name"], "--seed", str(ctx.seed),
                 "--device", ctx.device, "--rank", str(r),
                 "--port", str(port)],
                cwd=ctx.root, env=env, stdout=2))
        atexit.register(self._kill_ranks)

    def _kill_ranks(self) -> None:
        for p in self.ranks:
            if p.poll() is None:
                p.kill()

    def _command(self, op: int, a: int = 0, b: int = 0) -> None:
        dist.broadcast(torch.tensor([op, a, b], dtype=torch.long,
                                    device=self.comm), 0)

    def _wait_command(self) -> tuple:
        cmd = torch.empty(3, dtype=torch.long, device=self.comm)
        dist.broadcast(cmd, 0)
        return tuple(cmd.tolist())

    def unit(self, i: int) -> dict:
        if self.rank == 0:
            self._command(STEP, i)
        rec = super().unit(i)
        rec["work"] = self.ctx.traffic["batch"]
        return rec

    def describe(self, window) -> dict:
        t = self.ctx.traffic
        return {"first_losses": self.first["loss"], "ranks": self.world,
                "model_flops_per_step": model_flops.train_step(
                    self.ctx.cfg, t["batch"], t["captions"]["text_len"])}

    def release(self) -> None:
        if self.rank == 0:
            self._command(RELEASE)
        super().release()
        gc.collect()
        if self.ctx.device != "cpu":
            torch.cuda.empty_cache()

    def reference_readings(self, num: Numerics, half: bool = False) -> dict:
        if self.rank == 0:
            self._command(REFERENCE, MODES.index(num.mode), int(half))
        return self._reference(num, half)

    def check(self, window):
        try:
            return super().check(window)
        finally:
            self._end()

    def _end(self) -> None:
        """Every rank's last collective, then every rank leaves the group
        at once; rank 0 waits for the others to exit."""
        from lavila_tpu_torch.parallel import mesh
        if self.rank == 0:
            self._command(STOP)
        dist.all_reduce(torch.ones(1, device=self.comm))
        self.ctx.sync()
        mesh.destroy_process_group()
        if self.rank == 0:
            codes = [p.wait(timeout=EXIT_S) for p in self.ranks]
            if any(codes):
                raise RuntimeError(f"ranks 1-{self.world - 1} exited with "
                                   f"{codes}")

    # ---- the other ranks

    def serve(self) -> None:
        """Follow rank 0's commands until it ends the run."""
        while True:
            op, a, b = self._wait_command()
            if op == STEP:
                self.unit(a)
            elif op == RELEASE:
                self.release()
            elif op == REFERENCE:
                self.reference_readings(Numerics(MODES[a]), bool(b))
            elif op == STOP:
                self._end()
                return
            else:
                raise RuntimeError(f"unknown command {op}")

    # ---- the reference, split over the ranks

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` in rank order, this rank's own tensor (and
        its gradient) in its place."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.detach().contiguous())
        parts[self.rank] = x
        return torch.cat(parts)

    def _loss(self, p, b, num: Numerics, remat: bool, half: bool = False):
        """The global batch's symmetric InfoNCE (``R.clip_loss`` over the
        gathered embeddings; with ``half``, over the global batch's first
        half)."""
        cfg = self.ctx.cfg
        ie = R.encode_image(p, b["frames"], cfg, num, remat)
        te = R.encode_text(p, b["text"], b["mask"], cfg, num)
        if cfg["norm_embed"]:
            ie, te = R.l2_normalize(ie), R.l2_normalize(te)
        ie, te = self._gather(ie), self._gather(te)
        if half:
            ie, te = ie[:ie.shape[0] // 2], te[:te.shape[0] // 2]
        logits = p["logit_scale"].float().exp() * ie @ te.T
        labels = torch.arange(logits.shape[0], device=logits.device)
        ce = torch.nn.functional.cross_entropy
        return 0.5 * (ce(logits, labels) + ce(logits.T, labels))

    def _reference(self, num: Numerics, half: bool) -> dict:
        """``train.Driver.reference_readings`` over the global batches,
        each rank on its shard."""
        ctx, cfg = self.ctx, self.ctx.cfg
        strict_fp32()
        params = {k: v.clone().requires_grad_(True) for k, v in
                  reference_weights(ctx, self.spec, torch.float32).items()}
        if half:
            with torch.no_grad():
                loss = self._loss(params, self.batch(0), num, False, True)
            return {"loss": [float(loss)]}
        opt = cfg["optimizer"]
        adamw = R.AdamW(params, opt["lr"], opt["weight_decay"],
                        tuple(opt["betas"]), opt["eps"])
        losses, grad, change = [], None, None
        check = ctx.cell["check"]
        start = reference_weights(ctx, self.spec, torch.float32)
        for i in range(check["steps"] + check["window_steps"]):
            loss = self._loss(params, self.batch(i), num, cfg["remat"])
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = {n: g.contiguous() for n, g in zip(params, grads)}
            for g in grads.values():
                dist.all_reduce(g)
            # every rank's loss reaches the scale itself, not through its
            # rows: its gradient was summed once a rank
            grads["logit_scale"].div_(self.world)
            if i == 0:
                grad = C.leaf_norms(grads)
            adamw.step(params, grads)
            losses.append(float(loss.detach()))
            del grads, loss
            if i + 1 == check["steps"]:
                change = C.leaf_norms({n: p.detach() - start[n]
                                             for n, p in params.items()})
        return {"loss": losses, "grad": grad, "change": change}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One of the other ranks of "
                                "a data-parallel train cell.")
    p.add_argument("--root", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    args = p.parse_args(argv)
    root = Path(args.root)
    guard.set_env(root)
    bench = files.benchmark_json(root)
    cell = files.workload(args.workload, root)
    ctx = harness.Context(root, bench, cell,
                          files.config(cell["config"], bench, root),
                          files.traffic(cell["traffic"], root), args.seed,
                          args.device)
    Driver(ctx, rank=args.rank, port=args.port).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
