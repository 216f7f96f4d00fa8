"""Host time to issue one training step: the step call (forward, loss,
backward, the master gradients, AdamW, the copy back into the working
copy) from its start to its return, which does not synchronise; the mean
over the window. Near the step time, the host paces the card."""

from benchmark.portbench.readings import host_issue_ms

LAYER, UNIT, MOVES = "train step", "ms", "train_clips_per_s"


def read(run):
    return host_issue_ms(run)
