"""Host time to issue one ``encode_image`` call, from the call to its
return and before the copy of the embeddings to the host; the mean over
the window."""

from benchmark.portbench.readings import host_issue_ms

LAYER, UNIT, MOVES = "models", "ms", "encode_clips_per_s"


def read(run):
    return host_issue_ms(run)
