"""The Moonlight narrator's ``VCLM.generate`` wall time over all its
decode steps in the untraced window, as ``decode_step_ms.narrate`` reads
the GPT-2 narrator's: the decode loop's time a token, host issue and the
per-step sync included."""

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"


def read(run):
    steps = sum(u["steps"] for u in run.window.units)
    if steps <= 0:
        return None
    return 1e3 * sum(u["generate_s"] for u in run.window.units) / steps
