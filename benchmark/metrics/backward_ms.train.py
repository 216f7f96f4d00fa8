"""Host time of a train step's backward (the port's ``train.backward``
span, the caller's thread blocked in ``loss.backward()``): Σ its host ms
over the untraced window ÷ the window's ``train.step`` spans."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"
SPANS = ("train.step", "train.backward")
TRACING = spans.start()


def read(run):
    return spans.per_root_ms(run, TRACING, *SPANS)
