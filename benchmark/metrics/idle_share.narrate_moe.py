"""The device's idle share in the traced window: 1 - the union of the
device operations' intervals over the window's length."""

from benchmark.portbench.readings import idle_share

LAYER, UNIT, MOVES = "device", "%", "narrations_per_s"


def read(run):
    return idle_share(run)
