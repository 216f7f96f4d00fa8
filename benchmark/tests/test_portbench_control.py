"""The control, the reference in the program's place computed with fp8
products (one precision step below the configurations' bf16), comes out
as not correct. At the MINI sizes on the CPU here; at each cell's own
size on the card with ``python3 benchmark/control.py`` (the ``card``
test below), whose readings set the limits in PERF.md. The control of
the attention alone (``fp8attn``) is read beside it."""

import pytest

from benchmark.portbench import harness
from benchmark.tests.mini import SECONDS


@pytest.mark.parametrize("cell,number", [
    ("mini-train", "grad_gap"), ("mini-encode", "embed_err"),
    ("mini-narrate", "logit_err")])
def test_control_fails_a_limit(mini_root, cell, number):
    result, extra = harness.run_cell(cell, 12345, SECONDS[cell], False,
                                     "cpu", mini_root, control=True)
    assert result["correct"]
    limit = result["checks"][number]["limit"]
    assert set(extra["control"]) == set(harness.CONTROLS)
    assert extra["control"]["fp8"][number] > limit
    assert extra["control"]["fp8"][number] > result["checks"][number][
        "value"]
    # fp8 in the attention alone departs from the reference too
    assert extra["control"]["fp8attn"][number] > result["checks"][number][
        "value"]


@pytest.mark.cuda
def test_control_on_the_card(card):
    """One seed of each cell's control at its own size (the full sweep is
    ``benchmark/control.py``)."""
    from benchmark.portbench import files
    for w in files.benchmark_json()["workloads"]:
        result, extra = harness.run_cell(w["name"], 99, 5, False, card,
                                         control=True)
        assert result["correct"]
        ctl = extra["control"]["fp8"]
        assert any(ctl[k] > c["limit"] for k, c in result["checks"].items()
                   if k in ctl)
