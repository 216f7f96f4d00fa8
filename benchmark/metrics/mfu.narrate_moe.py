"""A Moonlight narration batch's model FLOPs over the active parameters
(``roofline/moonlight_flops.py``: encode, pool, the cross K/V once a clip,
the decode steps of every row with 6 routed and 2 shared experts a token)
times the window's batches, over the window, as a share of the card's
bf16 dense peak."""

from benchmark.portbench.readings import mfu
from benchmark.roofline import moonlight_flops

LAYER, UNIT, MOVES = "whole step", "%", "narrations_per_s"


def read(run):
    t = run.traffic
    s = t["sampling"]
    return mfu(run, moonlight_flops.narrate(
        run.cfg, t["batch"], t["batch"] * s["num_return_sequences"],
        s["max_text_length"] - 1))
