"""Device ms of the expert layers a decode step in the traced window: Σ
the device time of the expert layer's kernels (routing, sort, the two
grouped products, combine: ``kernels/moe.py``) ÷ the window's decode
steps, counted at the sampler (``roofline/expert.py``'s probe, one call
a step outside the decoder's CUDA graphs)."""

import re

from benchmark.roofline import expert

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"
PROBES = expert.PROBES
PATTERN = re.compile(r"\bmoe_(route|sort|gemm|combine)_kernel")


def read(run):
    if run.summary is None or run.summary["busy_s"] <= 0:
        return None
    steps = len(run.calls.get(expert.STEP, ()))
    if steps == 0:
        return None
    device = sum(s for name, s in run.summary["device_s"].items()
                 if PATTERN.search(name))
    return 1e3 * device / steps
