"""K3/K4/K5 forward and backward in the train step: Σ the least time of
each call ÷ Σ the device time of the LayerNorm kernels
(``roofline/layernorm.py``)."""

from benchmark.roofline import layernorm

LAYER, UNIT, MOVES = "kernels", "%", "train_clips_per_s"
PROBES = layernorm.PROBES


def read(run):
    return layernorm.roofline(run)
