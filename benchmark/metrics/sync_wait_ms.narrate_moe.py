"""The Moonlight narrator's host time blocked in a decode step's one
sync (the port's ``narrate.sync`` span), read as
``sync_wait_ms.narrate`` reads the GPT-2 narrator's: Σ its host ms over
the untraced window ÷ the window's ``narrate.forward`` spans."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"
SPANS = ("narrate.generate", "narrate.sync", "narrate.forward")
TRACING = spans.start()


def read(run):
    if TRACING is None:
        return None
    got = spans.window(run, TRACING, "narrate.generate", SPANS)
    return (sum(s.host_ms for s in got["narrate.sync"])
            / len(got["narrate.forward"]))
