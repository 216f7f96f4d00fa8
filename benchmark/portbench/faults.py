"""Faults planted in the port underneath a run, for the readings that
set the upper end of a limit (``control.py --faults``, on the card at a
cell's own size) and for the tests that see ``correct`` come out false
(``tests/test_portbench_faults.py``, on the CPU).

Each fault is a function that patches one entry point of the port and
returns the patch's undo.
"""

from __future__ import annotations

import contextlib


def _patch(module, attr: str, value):
    orig = getattr(module, attr)
    setattr(module, attr, value)
    return lambda: setattr(module, attr, orig)


def top_p_ignored():
    """The sampler keeps the whole distribution: no nucleus."""
    from lavila_tpu_torch.models import sampling
    return _patch(sampling, "apply_top_p", lambda logits, p, m=1: logits)


def temperature_1():
    """The sampler leaves the logits at temperature 1."""
    from lavila_tpu_torch.models import sampling
    return _patch(sampling, "apply_temperature", lambda logits, t: logits)


def other_row():
    """Each row's token is drawn from another row's logits, the batch's
    rows in reverse order (another clip's row: a clip's samples are
    consecutive rows, whose distributions can all but agree)."""
    from lavila_tpu_torch.models import sampling
    orig = sampling.sample_token
    return _patch(sampling, "sample_token",
                  lambda g, logits: orig(g, logits.flip(0)))


FAULTS = {"top_p_ignored": top_p_ignored, "temperature_1": temperature_1,
          "other_row": other_row}


@contextlib.contextmanager
def planted(name: str):
    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()
