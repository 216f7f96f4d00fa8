"""A narration batch's model FLOPs (encode, pool, the cross K/V once a
clip, the cached decode steps of every row) times the window's batches,
over the window, as a share of the card's bf16 dense peak."""

from benchmark.portbench.readings import mfu
from benchmark.roofline import model_flops

LAYER, UNIT, MOVES = "whole step", "%", "narrations_per_s"


def read(run):
    t = run.traffic
    s = t["sampling"]
    return mfu(run, model_flops.narrate(
        run.cfg, t["batch"], t["batch"] * s["num_return_sequences"],
        s["max_text_length"] - 1))
