"""The Moonlight narrator's host time of a decode step less its wait on
the card, read as ``step_issue_ms.narrate`` reads the GPT-2 narrator's:
Σ, over the untraced window's ``narrate.step`` spans, each one's host ms
less its ``narrate.sync`` child's ÷ the window's ``narrate.forward``
spans, one a decode step."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "models", "ms", "narrations_per_s"
SPANS = ("narrate.generate", "narrate.step", "narrate.sync",
         "narrate.forward")
TRACING = spans.start()


def read(run):
    if TRACING is None:
        return None
    got = spans.window(run, TRACING, "narrate.generate", SPANS)
    sync = {s.parent: s.host_ms for s in got["narrate.sync"]}
    issue = sum(s.host_ms - sync.get(s.index, 0.0)
                for s in got["narrate.step"])
    return issue / len(got["narrate.forward"])
