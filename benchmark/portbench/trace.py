"""The traced run's readings: ``torch.profiler`` over the whole window,
and call probes around the port's kernel entry points.

From the profiler's events (CUPTI on the card):

  * ``busy_s``: the union of the intervals in which a device operation
    (kernel, copy or fill) ran; ``window_s``: the window's length on the
    host's clock. The idle share is ``1 - busy_s / window_s``.
  * ``device_s``: seconds of device time by operation name, which the
    kernel readers sum over their name patterns.
  * the breakdown: the device operations that took most time, and the
    idle gaps between device operations summed by the innermost host
    operation that was running at each gap's middle.

A probe wraps a module-level function of the port for the window and
records a summary of each call's arguments (shapes, never tensors); a
roofline reader turns those into operations and bytes. A probe whose
target is gone fails the run (``ReaderFault``): the entry points a
reader probes, and the kernel names it matches, are what the benchmark
reads of the port, and a reader that silently read nothing would drop
its metric from the result.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import numpy as np

TOP = 10
GAP_CANDIDATES = 400  # the longest gaps attributed to a host operation


class ReaderFault(RuntimeError):
    """A per-layer reader cannot read what it measures."""


class Probes:
    def __init__(self, targets: dict):
        """``targets``: ``"module.attr"`` → ``summarise(*args, **kw)``."""
        self.targets = targets
        self.calls = defaultdict(list)
        self._saved = []

    def __enter__(self):
        for target, summarise in self.targets.items():
            mod_name, attr = target.rsplit(".", 1)
            try:
                module = importlib.import_module(mod_name)
            except ImportError as e:
                raise ReaderFault(f"probe target {target}: {e}") from e
            orig = getattr(module, attr, None)
            if not callable(orig):
                raise ReaderFault(f"probe target {target} is gone")
            calls = self.calls[target]

            def wrapper(*args, _orig=orig, _calls=calls, _s=summarise,
                        **kwargs):
                _calls.append(_s(*args, **kwargs))
                return _orig(*args, **kwargs)

            setattr(module, attr, wrapper)
            self._saved.append((module, attr, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()
        return False


class Tracer:
    """A context around the window: the profiler and the probes when
    ``enabled``, nothing otherwise."""

    def __init__(self, enabled: bool, probes: dict):
        self.enabled = enabled
        self.probes = Probes(probes if enabled else {})
        self.summary: dict | None = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self.probes.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        if self.enabled:
            self.probes.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarise(
                    self._prof.profiler.kineto_results.events(),
                    self.window_s)
        return False


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends), sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_s = s[idx]
    m_e = np.append(run_end[idx[1:] - 1], run_end[-1])
    return m_s, m_e


def summarise(events, window_s: float) -> dict:
    dev_name, dev_s, dev_e = [], [], []
    cpu_name, cpu_s, cpu_e, cpu_tid = [], [], [], []
    for ev in events:
        kind = str(ev.device_type())
        name = ev.name()
        if kind.endswith("CUDA"):
            if ev.is_user_annotation() or name.startswith("Command Buffer"):
                continue
            dev_name.append(name)
            dev_s.append(ev.start_ns())
            dev_e.append(ev.end_ns())
        elif kind.endswith("CPU") and not ev.is_user_annotation():
            cpu_name.append(name)
            cpu_s.append(ev.start_ns())
            cpu_e.append(ev.end_ns())
            cpu_tid.append(ev.start_thread_id())
    if not dev_name:
        return {"busy_s": 0.0, "window_s": window_s, "device_s": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    ds, de = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
    by_name = defaultdict(int)
    for name, a, b in zip(dev_name, dev_s, dev_e):
        by_name[name] += b - a
    device_s = {k: v / 1e9 for k, v in by_name.items()}
    m_s, m_e = _union(ds, de)
    busy_s = float((m_e - m_s).sum()) / 1e9
    gaps = []
    if len(m_s) > 1:
        g_len = m_s[1:] - m_e[:-1]
        g_mid = (m_s[1:] + m_e[:-1]) // 2
        top = np.argsort(-g_len)[:GAP_CANDIDATES]
        gaps = [(int(g_len[i]), int(g_mid[i])) for i in top if g_len[i] > 0]
    idle = defaultdict(float)
    if gaps and cpu_name:
        tids = np.array(cpu_tid)
        values, counts = np.unique(tids, return_counts=True)
        main = tids == values[np.argmax(counts)]
        cs = np.array(cpu_s, np.int64)[main]
        ce = np.array(cpu_e, np.int64)[main]
        names = [n for n, m in zip(cpu_name, main) if m]
        dur = ce - cs
        for length, mid in gaps:
            inside = np.flatnonzero((cs <= mid) & (ce >= mid))
            host = (names[inside[np.argmin(dur[inside])]] if len(inside)
                    else "(no host operation)")
            idle[host] += length / 1e9
    top_ops = sorted(device_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s, "device_s": device_s,
            "breakdown": {
                "device_ops": [[k[:160], v] for k, v in top_ops],
                "idle_gaps": [[k[:160], v] for k, v in top_idle]}}
