"""Host time to issue a decode step's sampler (temperature, top-k, the
top-p bisection, the draw and the model group's broadcast: the port's
``narrate.sample`` span): Σ its host ms over the untraced window ÷ the
window's ``narrate.forward`` spans, one a decode step."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"
SPANS = ("narrate.generate", "narrate.sample", "narrate.forward")
TRACING = spans.start()


def read(run):
    if TRACING is None:
        return None
    got = spans.window(run, TRACING, "narrate.generate", SPANS)
    return (sum(s.host_ms for s in got["narrate.sample"])
            / len(got["narrate.forward"]))
