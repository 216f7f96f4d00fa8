"""Host time of a train step's update (the port's ``train.update`` span:
the master gradients, the average over ranks, AdamW with the clamp, the
copy back into the working copy): Σ its host ms over the untraced window
÷ the window's ``train.step`` spans."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"
SPANS = ("train.step", "train.update")
TRACING = spans.start()


def read(run):
    return spans.per_root_ms(run, TRACING, *SPANS)
