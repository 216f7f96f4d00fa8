"""Device time of a data-parallel train step's gradient average on rank
0: Σ, over the untraced window's ``update.average`` spans (the port's
all-reduce of the fp32 gradients, ``mesh.average_grads``), the time
between the CUDA events the port records on the stream at the span's
entry and exit ÷ the window's ``train.step`` spans. It holds the wait
for the slowest rank as well as the transfer."""

from benchmark.portbench import spans

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"
SPANS = ("train.step", "update.average")
TRACING = spans.start()


def read(run):
    return spans.per_root_ms(run, TRACING, *SPANS, device=True)
