"""Device time of a train step's update: Σ, over the untraced window's
``train.update`` spans, the time between the CUDA events the port
records on the stream at the span's entry and exit ÷ the window's
``train.step`` spans."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"
SPANS = ("train.step", "train.update")
TRACING = spans.start()


def read(run):
    return spans.per_root_ms(run, TRACING, *SPANS, device=True)
