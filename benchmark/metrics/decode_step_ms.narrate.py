"""All of ``VCLM.generate``'s wall time over all its decode steps in the
untraced window (steps counted as its calls of ``decode_step``): the
decode loop's time a token, host issue and the per-step sync included."""

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"


def read(run):
    steps = sum(u["steps"] for u in run.window.units)
    if steps <= 0:
        return None
    return 1e3 * sum(u["generate_s"] for u in run.window.units) / steps
