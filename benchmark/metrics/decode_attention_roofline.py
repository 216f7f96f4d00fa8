"""K9 in the narrator's decode steps: Σ the least time of each call ÷ Σ
the device time of the decode kernel (``roofline/decode_attention.py``)."""

from benchmark.roofline import decode_attention

LAYER, UNIT, MOVES = "kernels", "%", "narrations_per_s"
PROBES = decode_attention.PROBES


def read(run):
    return decode_attention.roofline(run)
