"""The Moonlight narrator's host time to issue a decode step's sampler
(the top-p bisection over 163,840 probabilities a row; the port's
``narrate.sample`` span), read as ``sampler_ms.narrate`` reads the GPT-2
narrator's: Σ its host ms over the untraced window ÷ the window's
``narrate.forward`` spans."""

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
