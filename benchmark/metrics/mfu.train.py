"""The train step's model FLOPs (3 × the dual encoder's forward at the
cell's batch; remat's recompute not counted) times the window's steps,
over the window, as a share of the card's bf16 dense peak."""

from benchmark.portbench.readings import mfu
from benchmark.roofline import model_flops

LAYER, UNIT, MOVES = "whole step", "%", "train_clips_per_s"


def read(run):
    t = run.traffic
    return mfu(run, model_flops.train_step(run.cfg, t["batch"],
                                           t["captions"]["text_len"]))
