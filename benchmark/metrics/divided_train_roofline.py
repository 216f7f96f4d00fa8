"""K1/K2/K6 in the train step (forward, remat's recompute and backward):
Σ the least time of each call ÷ Σ the device time of the divided
kernels (``roofline/divided.py``)."""

from benchmark.roofline import divided

LAYER, UNIT, MOVES = "kernels", "%", "train_clips_per_s"
PROBES = divided.PROBES


def read(run):
    return divided.roofline(run)
