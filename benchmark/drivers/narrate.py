"""The narrator's pseudo-labelling: ``encode_image`` then
``VCLM.generate`` (bf16 weights, inference mode) on ``batch`` clips with
``num_return_sequences`` captions each, sampled as the traffic states
(temperature, top-k, top-p), one batch a unit, the ids and perplexities
copied to the host at its end.

Every unit, a few rows drawn from the seed (``check.rows_per_batch``)
have the logits of each decode step kept as ``decode_step`` returned
them (a slice of the step's output, on the device); the calls of
``decode_step`` count the unit's decode steps. After the window the
reference runs the tower, the pooler and GPT-2 over each kept row's
served ids (up to the first EOS), teacher forced, all positions at once,
no cache, and the check compares:

  * ``logit_err``: the widest, over the kept rows' positions, root mean
    square gap between the program's logits and the reference's, over
    the standard deviation of the reference's logits there;
  * ``nucleus_excess``: the largest, over the kept rows' served tokens,
    of the reference's tempered probability mass above the token less
    ``top_p`` (``reference/sampler.py``): above 0, the token lies outside
    the reference's nucleus;
  * ``draw_ks``: the Kolmogorov-Smirnov distance from the uniform law of
    the served tokens' places in the reference's sampling distribution
    (uniform where the draws follow it).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.drivers import DTYPES, build_program, reference_weights
from benchmark.portbench import compare as C
from benchmark.portbench import traffic as T
from benchmark.portbench.weights import sub_seed
from benchmark.reference import models as R
from benchmark.reference import sampler
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.roofline import model_flops


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        self.spec = R.narrator_spec(cfg)
        self.dtype = DTYPES[cfg["dtype"]]
        self.model = build_program(ctx, self.spec, self.dtype, train=False,
                                   num_frames=cfg["tower"]["num_frames"],
                                   gated_xattn=cfg["gated_xattn"])
        t0 = time.perf_counter()
        self.frames = T.clips(t, cfg["tower"], ctx.seed, ctx.device,
                              self.dtype)
        self.gen = T.generator(ctx.seed, "sampling", ctx.device)
        ctx.sync()
        t0 = ctx.timed("inputs", t0)
        self.kept = None  # the warm-up's rows are not kept
        self.unit(-1)
        ctx.timed("warmup", t0)
        # per unit: pool batch, kept rows, their ids, their logits
        self.kept = []

    def rows(self, i: int) -> list[int]:
        """The rows of unit ``i`` whose logits are kept."""
        t = self.ctx.traffic
        n = t["batch"] * t["sampling"]["num_return_sequences"]
        rng = random.Random(sub_seed(self.ctx.seed, f"rows{i}"))
        return sorted(rng.sample(range(n),
                                 self.ctx.cell["check"]["rows_per_batch"]))

    def unit(self, i: int) -> dict:
        s = self.ctx.traffic["sampling"]
        j = i % self.frames.shape[0]
        rows = torch.tensor(self.rows(i), device=self.ctx.device)
        kept, step = [], self.model.decode_step

        def decode_step(*args, **kwargs):
            logits = step(*args, **kwargs)
            kept.append(logits.index_select(0, rows))
            return logits

        self.model.decode_step = decode_step
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = self.model.encode_image(self.frames[j])
            t1 = time.perf_counter()
            ids, ppl = self.model.generate(
                tokens, generator=self.gen, bos_id=s["bos_id"],
                eos_id=s["eos_id"], pad_id=s["pad_id"],
                max_text_length=s["max_text_length"],
                temperature=s["temperature"], top_k=s["top_k"] or None,
                top_p=s["top_p"],
                num_return_sequences=s["num_return_sequences"])
        gen_s = time.perf_counter() - t1
        ids, ppl = ids.cpu(), ppl.cpu()
        del self.model.decode_step
        if not kept:
            raise RuntimeError("generate made no call of decode_step")
        if self.kept is not None:
            self.kept.append((j, rows.cpu(), ids[rows.cpu()],
                              torch.stack(kept, 1)))
        return {"work": ids.shape[0], "issue_s": t1 - t0, "generate_s": gen_s,
                "steps": len(kept)}

    def end_to_end(self, window) -> dict:
        return {"narrations_per_s": window.work / window.elapsed}

    def describe(self, window) -> dict:
        t = self.ctx.traffic
        s = t["sampling"]
        rows = t["batch"] * s["num_return_sequences"]
        return {"batches": len(window.units),
                "generate_s": [round(u["generate_s"], 4)
                               for u in window.units],
                "decode_steps": [u["steps"] for u in window.units],
                "model_flops_per_batch": model_flops.narrate(
                    self.ctx.cfg, t["batch"], rows,
                    s["max_text_length"] - 1)}

    def attempted(self, window) -> int:
        return int(window.work)

    def release(self) -> None:
        self.model = None

    def served(self, ids: torch.Tensor) -> int:
        """Tokens served after BOS, up to and including the first EOS."""
        eos = self.ctx.traffic["sampling"]["eos_id"]
        hits = (ids[1:] == eos).nonzero()
        return int(hits[0]) + 1 if len(hits) else ids.shape[0] - 1

    def reference_logits(self, p, num: Numerics):
        """The reference's float32 logits over each kept row's served ids
        (row → (served, V))."""
        nrs = self.ctx.traffic["sampling"]["num_return_sequences"]
        out = []
        for j, rows, ids, _ in self.kept:
            for r, row_ids in zip(rows.tolist(), ids):
                n = self.served(row_ids)
                clip = self.frames[j][r // nrs:r // nrs + 1]
                with torch.no_grad():
                    out.append(R.narrator_logits(
                        p, clip, row_ids[None, :n].to(self.ctx.device),
                        self.ctx.cfg, num)[0])
        return out

    @staticmethod
    def logit_err(got: torch.Tensor, ref: torch.Tensor) -> float:
        rms = (got.float() - ref).square().mean(-1).sqrt()
        return float((rms / ref.std(-1)).max())

    def placements(self, refs: list) -> tuple[torch.Tensor, torch.Tensor]:
        """``excess`` and ``u`` of every kept row's served tokens under
        the reference's sampling distribution at its logits."""
        s = self.ctx.traffic["sampling"]
        gen = torch.Generator().manual_seed(sub_seed(self.ctx.seed, "place"))
        excess, u, at = [], [], 0
        for _, _, ids, _ in self.kept:
            for row_ids in ids:
                ref = refs[at]
                served = row_ids[1:ref.shape[0] + 1].to(ref.device)
                e, p = sampler.placement(
                    ref, served, torch.rand(ref.shape[0], generator=gen).to(
                        ref.device), s["temperature"], s["top_k"] or None,
                    s["top_p"])
                excess.append(e.cpu())
                u.append(p.cpu())
                at += 1
        return torch.cat(excess), torch.cat(u)

    def check(self, window):
        strict_fp32()
        p = reference_weights(self.ctx, self.spec, self.dtype)
        refs = self.reference_logits(p, Numerics("fp32"))
        limits = self.ctx.cell["check"]["limits"]
        errs, at = [], 0
        for _, _, ids, logits in self.kept:
            for k in range(len(ids)):
                ref = refs[at]
                errs.append(self.logit_err(logits[k, :ref.shape[0]], ref))
                at += 1
        excess, u = self.placements(refs)
        readings = {"logit_err": max(errs, default=float("inf")),
                    "nucleus_excess": float(excess.max()) if len(excess)
                    else float("inf"),
                    "draw_ks": sampler.ks_uniform(u)}
        checks = [C.check(k, v, limits[k]) for k, v in readings.items()]
        extra = {"rows_checked": len(errs), "tokens_checked": len(u),
                 "outside_nucleus": int((excess >= 0).sum())}
        extra["control"] = {
            mode: {"logit_err": max(
                (self.logit_err(c, r) for c, r in zip(
                    self.reference_logits(p, Numerics(mode)), refs)),
                default=float("inf"))}
            for mode in self.ctx.controls}
        failed = (sum(e > limits["logit_err"] for e in errs)
                  + int((excess > limits["nucleus_excess"]).sum()))
        return checks, failed, extra
