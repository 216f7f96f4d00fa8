"""A global train step's model FLOPs (3 × the dual encoder's forward at
the global batch; remat's recompute not counted) times the window's
steps, over the window, as a share of the bf16 dense peak of the
traffic's ranks, one card each."""

from benchmark.portbench.readings import mfu
from benchmark.roofline import model_flops

LAYER, UNIT, MOVES = "whole step", "%", "train_clips_per_s"


def read(run):
    t = run.traffic
    return mfu(run, model_flops.train_step(run.cfg, t["batch"],
                                           t["captions"]["text_len"])
               ) / t["ranks"]
