"""The expert layer's grouped products in the Moonlight narrator's decode
steps: Σ the least time of each decode step's grouped products ÷ Σ the
device time of the grouped kernels (``roofline/expert.py``)."""

from benchmark.portbench import spans
from benchmark.roofline import expert

LAYER, UNIT, MOVES = "kernels", "%", "narrations_per_s"
PROBES = expert.PROBES
TRACING = spans.start()


def read(run):
    return expert.roofline(run, TRACING)
