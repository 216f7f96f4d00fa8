"""``encode_image``'s model FLOPs at the cell's batch times the window's
calls, over the window, as a share of the card's bf16 dense peak."""

from benchmark.portbench.readings import mfu
from benchmark.roofline import model_flops

LAYER, UNIT, MOVES = "whole step", "%", "encode_clips_per_s"


def read(run):
    return mfu(run, model_flops.encode(run.cfg, run.traffic["batch"]))
