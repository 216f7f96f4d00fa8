"""Host time of a train step's forward and loss (the port's
``train.forward`` span): Σ its host ms over the untraced window ÷ the
window's ``train.step`` spans, one a step."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"
SPANS = ("train.step", "train.forward")
TRACING = spans.start()


def read(run):
    return spans.per_root_ms(run, TRACING, *SPANS)
