"""The Moonlight narrator's pseudo-labelling: the ``narrate`` driver's
units (``encode_image`` then ``VCLM.generate``, bf16, every batch
sampled, one batch a unit), on the narrator whose decoder is
Moonlight-16B-A3B (``models/moonlight.py``), with the expert choices of
the kept rows recorded too.

Every unit, the kept rows (``check.rows_per_batch``, drawn from the
seed) keep the logits of each decode step, as the ``narrate`` driver
keeps them, and the experts the program chose for them at each step and
expert layer: a forward hook on each of the decoder's ``Router`` modules,
registered before the warm-up, copies the kept rows' choices into a
fixed device buffer at the step's place, so that the decoder's CUDA
graphs, which capture the hooks with the step, replay the copy too.
After the window the reference
(``reference/moonlight.py``) runs the tower, the pooler and the decoder
over each unit's kept rows, teacher forced, its weights held in bf16 and
upcast product by product, its expert layers routed as the program
routed those rows (filled up to the configuration's experts a token by
its own ranking), and the check compares:

  * ``logit_err``: as the ``narrate`` driver's, the widest root mean
    square gap of a kept row's logits over the reference's spread;
  * ``route_gap``: over the kept rows' positions and expert layers, the
    reference's best biased score outside the experts it used less its
    worst biased score among those the program chose; above 0 only
    where the program's choice departs from the reference's top set,
    which rounding may do at near-ties alone;
  * ``nucleus_excess`` and ``draw_ks``: as the ``narrate`` driver's, the
    served tokens against the reference's sampling distribution
    (``reference/sampler.py``).

The reference is computed a unit at a time and dropped, so the check
holds one unit's logits at once.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.drivers import DTYPES, build_program
from benchmark.drivers import narrate
from benchmark.portbench import compare as C
from benchmark.portbench import moe_faults
from benchmark.portbench import traffic as T
from benchmark.portbench import weights as W
from benchmark.portbench.weights import sub_seed
from benchmark.reference import moonlight as M
from benchmark.reference import sampler
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.roofline import moonlight_flops

moe_faults.register()


# the token embedding's factor over the weights rule's draw (2048^-1/2),
# on the program's and the reference's copies alike: at the rule's std
# the pooled visual tokens, near-equal across clips of random frames,
# swamp every token's own state, and the untrained router sends all the
# rows to the same 6-7 experts a layer (the configuration's
# ``assumed.embedding_scale``)
EMBED = "text_decoder.model.embed_tokens.weight"
EMBED_SCALE = 64.0


@torch.no_grad()
def scale(params: dict) -> None:
    params[EMBED].mul_(EMBED_SCALE)


class Driver(narrate.Driver):
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        self.spec = M.narrator_spec(cfg)
        self.dtype = DTYPES[cfg["dtype"]]
        self.model = build_program(ctx, self.spec, self.dtype, train=False,
                                   num_frames=cfg["tower"]["num_frames"],
                                   gated_xattn=cfg["gated_xattn"],
                                   param_dtype=self.dtype)
        scale(dict(self.model.named_parameters()))
        from lavila_tpu_torch.models import moonlight
        routers = [m for m in self.model.modules()
                   if isinstance(m, moonlight.Router)]
        # the kept rows of the unit, and their experts at each decode step
        # and expert layer, in buffers the hooks write in place
        self.kept_rows = torch.zeros(ctx.cell["check"]["rows_per_batch"],
                                     dtype=torch.long, device=ctx.device)
        self.chosen = torch.zeros(
            (t["sampling"]["max_text_length"] - 1, len(routers),
             len(self.kept_rows), cfg["num_experts_per_tok"]),
            dtype=torch.int32, device=ctx.device)
        self.step = self.width = 0
        for m, router in enumerate(routers):
            router.register_forward_hook(self._keeper(m))
        if ctx.device != "cpu":
            # the draw's one 33 GB buffer, free since the load: back to the
            # card whole, before smaller tensors split it (the check draws
            # it again)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.frames = T.clips(t, cfg["tower"], ctx.seed, ctx.device,
                              self.dtype)
        self.gen = T.generator(ctx.seed, "sampling", ctx.device)
        ctx.sync()
        t0 = ctx.timed("inputs", t0)
        self.kept = None  # the warm-up's rows are not kept
        self.routes = []
        self.unit(-1)
        ctx.timed("warmup", t0)
        self.kept = []

    def _keeper(self, m: int):
        def keep(router, args, out):
            # a fault may route to fewer experts than the configuration's
            self.width = out[1].shape[1]
            self.chosen[self.step, m, :, :self.width].copy_(
                out[1].index_select(0, self.kept_rows))
        return keep

    def unit(self, i: int) -> dict:
        self.kept_rows.copy_(torch.tensor(self.rows(i)))
        step = self.model.decode_step

        def decode_step(tokens, cross_kv, cache, cache_index):
            self.step = cache_index  # where the hooks write
            return step(tokens, cross_kv, cache, cache_index)

        self.model.decode_step = decode_step
        try:
            rec = super().unit(i)
        finally:
            self.model.__dict__.pop("decode_step", None)
        if self.kept is not None:
            # (steps, expert layers, kept rows, k)
            self.routes.append(
                self.chosen[:rec["steps"], ..., :self.width].clone())
        return rec

    def release(self) -> None:
        super().release()
        self.kept_rows = self.chosen = None

    def describe(self, window) -> dict:
        t = self.ctx.traffic
        s = t["sampling"]
        return {"batches": len(window.units),
                "generate_s": [round(u["generate_s"], 4)
                               for u in window.units],
                "decode_steps": [u["steps"] for u in window.units],
                "model_flops_per_batch": moonlight_flops.narrate(
                    self.ctx.cfg, t["batch"],
                    t["batch"] * s["num_return_sequences"],
                    s["max_text_length"] - 1)}

    def reference_unit(self, p, u: int, num: Numerics):
        """The reference's logits ``(R, L, V)`` over unit ``u``'s kept
        rows (L their longest served length), routed as the program
        routed them, and its route gap."""
        cfg = self.ctx.cfg
        nrs = self.ctx.traffic["sampling"]["num_return_sequences"]
        j, rows, ids, _ = self.kept[u]
        L = max(self.served(r) for r in ids)
        first = cfg["first_k_dense_replace"]
        chosen = self.routes[u][:L].to(self.ctx.device)
        routes = {first + m: chosen[:, m].transpose(0, 1)
                  for m in range(chosen.shape[1])}
        clips = self.frames[j][(rows // nrs).to(self.ctx.device)]
        with torch.no_grad():
            return M.narrator_logits(p, clips, ids[:, :L].to(
                self.ctx.device), cfg, num, routes)

    def check(self, window):
        try:
            return self._check()
        finally:
            # the reference's 33 GB in one segment: released, so that a
            # later run in this process (control.py) can draw its weights
            gc.collect()
            if self.ctx.device != "cpu":
                torch.cuda.empty_cache()

    def _check(self):
        strict_fp32()
        ctx, s = self.ctx, self.ctx.traffic["sampling"]
        # the decoder's weights stay bf16, each upcast as a product takes
        # it; the tower's and the pooler's are upcast once
        p = W.draw(self.spec, ctx.seed, ctx.device, self.dtype,
                   ctx.cfg["scalars"])
        scale(p)
        p = {k: v if k.startswith("text_decoder.") else v.float()
             for k, v in p.items()}
        limits = ctx.cell["check"]["limits"]
        gen = torch.Generator().manual_seed(sub_seed(ctx.seed, "place"))
        errs, gaps, excess, u = [], [], [], []
        control = {mode: {"logit_err": [], "route_gap": []}
                   for mode in ctx.controls}
        for at, (_, _, ids, logits) in enumerate(self.kept):
            ref, gap = self.reference_unit(p, at, Numerics("fp32"))
            gaps.append(gap)
            for k, row_ids in enumerate(ids):
                n = self.served(row_ids)
                errs.append(self.logit_err(logits[k, :n], ref[k, :n]))
                e, place = sampler.placement(
                    ref[k, :n], row_ids[1:n + 1].to(ref.device),
                    torch.rand(n, generator=gen).to(ref.device),
                    s["temperature"], s["top_k"] or None, s["top_p"])
                excess.append(e.cpu())
                u.append(place.cpu())
            for mode, got in control.items():
                low, low_gap = self.reference_unit(p, at, Numerics(mode))
                got["route_gap"].append(low_gap)
                got["logit_err"].append(max(
                    self.logit_err(low[k, :self.served(r)],
                                   ref[k, :self.served(r)])
                    for k, r in enumerate(ids)))
            del ref
        excess, u = torch.cat(excess), torch.cat(u)
        readings = {"logit_err": max(errs, default=float("inf")),
                    "route_gap": max(gaps, default=float("inf")),
                    "nucleus_excess": float(excess.max()) if len(excess)
                    else float("inf"),
                    "draw_ks": sampler.ks_uniform(u)}
        checks = [C.check(k, v, limits[k]) for k, v in readings.items()]
        extra = {"rows_checked": len(errs), "tokens_checked": len(u),
                 "outside_nucleus": int((excess >= 0).sum()),
                 "control": {mode: {k: max(v) for k, v in got.items()}
                             for mode, got in control.items()}}
        failed = (sum(e > limits["logit_err"] for e in errs)
                  + sum(g > limits["route_gap"] for g in gaps)
                  + int((excess > limits["nucleus_excess"]).sum()))
        return checks, failed, extra
