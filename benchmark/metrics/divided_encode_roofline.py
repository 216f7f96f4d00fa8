"""K1/K2/K6 forward in ``encode_image``: Σ the least time of each call ÷
Σ the device time of the divided kernels (``roofline/divided.py``)."""

from benchmark.roofline import divided

LAYER, UNIT, MOVES = "kernels", "%", "encode_clips_per_s"
PROBES = divided.PROBES


def read(run):
    return divided.roofline(run)
