"""Faults of the expert layer, planted in the port underneath a run of
the Moonlight narrator cell, for the readings that set the upper end of
its limits (``control.py --faults``, on the card) and for the tests that
see ``correct`` come out false (``benchmark/tests/test_portbench_moe.py``,
on the CPU). Each patches the routing's dispatch site in the Moonlight decoder
(``models/moonlight.py:route``). :func:`register` adds them to
``portbench.faults.FAULTS``, where ``control.py`` finds a fault by name;
the cell's driver calls it when it is imported."""

from __future__ import annotations

from benchmark.portbench import faults


def _route(change):
    """Patch ``moonlight.route``, its arguments changed by ``change``."""
    from lavila_tpu_torch.models import moonlight
    orig = moonlight.route
    return faults._patch(
        moonlight, "route",
        lambda x, weight, bias, top_k, scale: orig(
            x, weight, *change(bias, top_k, scale)))


def bias_ignored():
    """The experts are chosen by the scores alone, without the
    correction bias."""
    return _route(lambda b, k, s: (b * 0, k, s))


def scale_dropped():
    """The routed weights lose the scaling factor (2.446)."""
    return _route(lambda b, k, s: (b, k, 1.0))


def one_expert_fewer():
    """Each token takes one routed expert fewer (5 of 64)."""
    return _route(lambda b, k, s: (b, k - 1, s))


FAULTS = {"bias_ignored": bias_ignored, "scale_dropped": scale_dropped,
          "one_expert_fewer": one_expert_fewer}


def register() -> None:
    faults.FAULTS.update(FAULTS)
