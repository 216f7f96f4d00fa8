"""The arithmetic the per-layer readers share (``metrics/*.py``). What
the host's clock times is read from the run's untraced window, what the
device ran from the profiler's summary of the traced one."""

from __future__ import annotations

from benchmark.portbench.peaks import PEAK_FLOPS


def host_issue_ms(run) -> float:
    """The mean host time from a unit's call into the program to its
    return, before the unit's synchronise or copy."""
    units = run.window.units
    return 1e3 * sum(u["issue_s"] for u in units) / len(units)


def idle_share(run) -> float | None:
    """100 × (1 - device busy ÷ traced window)."""
    s = run.summary
    if s is None or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(run, flops_per_unit: float, dtype: str = "bfloat16") -> float:
    """100 × model FLOPs of the window's units ÷ its length ÷ the dense
    peak of ``dtype``."""
    w = run.window
    return 100.0 * flops_per_unit * len(w.units) / w.elapsed / PEAK_FLOPS[
        dtype]
