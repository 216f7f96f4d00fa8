"""How unevenly the router spreads the decode rows: the rows routed to
the busiest (layer, expert) ÷ the mean over every (layer, expert), summed
over the run's batches (the port's ``moe.rows.<layer>`` counters, kept on
the device while recording is on: the warm-up batch and both windows).
1 is an even spread."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "models", "x", "narrations_per_s"
TRACING = spans.start()


def read(run):
    if TRACING is None or not hasattr(TRACING, "counters"):
        return None
    rows = [t.double() for name, t in sorted(TRACING.counters().items())
            if name.startswith("moe.rows.")]
    if not rows:
        return None
    total = sum(float(t.sum()) for t in rows)
    cells = sum(t.numel() for t in rows)
    if total <= 0:
        return None
    return max(float(t.max()) for t in rows) / (total / cells)
