"""Operations and bytes of the port's kernels from the shapes of their
calls, and the model FLOPs of a step, frozen with the benchmark.

A kernel's roofline share is the sum over its calls in the traced window
of the least time the card could take (``portbench.peaks.bound_s``:
each input read once, each output written once) over the device time of
the kernels whose names match its pattern. The calls are recorded by
probes around the port's entry points (``portbench.trace.Probes``). A
window with neither calls nor kernels reads nothing (the kernel is off
the path); calls without kernels of the pattern, or kernels without
calls, fail the run: a name or an entry point has moved."""

from __future__ import annotations

import re

from benchmark.portbench.peaks import bound_s
from benchmark.portbench.trace import ReaderFault


def share(run, pattern: str, probes: dict, cost) -> float | None:
    """100 × Σ bound ÷ Σ device time, or None where the window shows no
    such call and no such kernel. ``cost(target, record)`` gives a call's
    (bytes, operations, dtype of the peak)."""
    if run.summary is None or run.summary["busy_s"] <= 0:
        return None  # untraced, or a profiler that saw no device
    rx = re.compile(pattern)
    device = sum(s for name, s in run.summary["device_s"].items()
                 if rx.search(name))
    calls = [(t, r) for t in probes for r in run.calls.get(t, ())]
    if device <= 0 and not calls:
        return None
    if device <= 0:
        raise ReaderFault(f"{len(calls)} calls of {sorted(probes)} and no "
                          f"device kernel matching {pattern!r}")
    if not calls:
        raise ReaderFault(f"{device:.4f} s of kernels matching {pattern!r} "
                          f"and no call of {sorted(probes)} probed")
    return 100.0 * sum(bound_s(*cost(t, r)) for t, r in calls) / device
