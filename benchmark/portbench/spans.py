"""What the span readers (``metrics/*.py`` with ``SPANS``) share: the
port's spans (``lavila_tpu_torch/utils/tracing.py``), switched on when a
reader is loaded and read from the untraced window.

The harness loads the readers only for a ``--trace 1`` run, and before
set-up, so a reader's :func:`start` records spans through set-up and
both windows, and the runs that give the end-to-end metrics
(``--trace 0``) run with recording off. The spans are stamped on
``time.perf_counter``'s clock, which the window's ``t0`` and the units'
``end`` use too: a reader takes the spans that lie inside
``[t0, last unit's end]`` of the untraced window, which the profiler's
own cost does not slow.

A reader fails the run (``ReaderFault``) where a span it reads is
missing from the window, or where the window's count of the cell's root
span (one a unit) is not its count of units. Against a program that has
no ``utils/tracing.py`` (a checkout from before the spans), :func:`start`
gives None and the readers give no reading.
"""

from __future__ import annotations

from benchmark.portbench.trace import ReaderFault


def start():
    """The port's tracing module, recording; None where the program has
    none."""
    try:
        from lavila_tpu_torch.utils import tracing
    except ImportError:
        return None
    tracing.enable()
    return tracing


def window(run, tracing, root: str, names) -> dict[str, list]:
    """Name → the closed spans of ``names`` (``root`` among them) inside
    the untraced window, in the order they were opened."""
    t0 = run.window.t0 * 1e9
    t1 = run.window.units[-1]["end"] * 1e9
    got = {name: [] for name in names}
    for s in tracing.spans():
        if (s.name in got and s.end_ns is not None and t0 <= s.start_ns
                and s.end_ns <= t1):
            got[s.name].append(s)
    missing = sorted(name for name, found in got.items() if not found)
    if missing:
        raise ReaderFault(f"no {', '.join(missing)} span in the untraced "
                          f"window ({tracing.dropped()} dropped)")
    roots = sum(s.parent is None for s in got[root])
    if roots != len(run.window.units):
        raise ReaderFault(f"{roots} {root} root spans in a window of "
                          f"{len(run.window.units)} units")
    return got


def per_root_ms(run, tracing, root: str, name: str,
                device: bool = False) -> float | None:
    """Σ the host (or, with ``device``, the CUDA events') ms of the
    ``name`` spans in the untraced window ÷ its ``root`` spans, one a
    unit. None without the program's spans, and for ``device`` on a run
    without a card, where the port records no device time."""
    if tracing is None:
        return None
    got = window(run, tracing, root, (root, name))
    units = len(run.window.units)
    if not device:
        return sum(s.host_ms for s in got[name]) / units
    times = [s.device_ms for s in got[name]]
    if all(t is None for t in times):
        return None
    if None in times:
        raise ReaderFault(f"{times.count(None)} of {len(times)} {name} "
                          "spans have no device time")
    return sum(times) / units
