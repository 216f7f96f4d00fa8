"""Spans: named intervals of the host's work at the boundaries of the
port's layers, kept in memory for whoever reads them.

The spans the port opens:

  * the train steps (``train/step.py``): ``train.step``, and inside it
    ``train.forward`` (forward and loss), ``train.backward`` and
    ``train.update``, which holds ``update.grads`` (the master
    gradients), ``update.average`` (over the ranks), ``update.optimizer``
    (with the clamp) and ``update.copy`` (the masters into the working
    copy);
  * the towers' encode call: ``encode.image`` (a root where it is called
    alone, under ``train.forward`` in a step);
  * the narrator's ``VCLM.generate``: ``narrate.generate``, and inside it
    ``narrate.prepare`` (the repeat, the cross K/V, the cache) and one
    ``narrate.step`` a loop iteration, which holds ``narrate.sync`` (the
    host's wait on the EOS test), ``narrate.forward`` (one
    ``decode_step``) and ``narrate.sample`` (warp, draw, broadcast).

Recording is off by default. Then :func:`span` returns one shared null
context after a single read of a module-level bool: nothing recorded, no
CUDA event, no profiler call. After :func:`enable` each span records

  * ``name``;
  * ``start_ns`` and ``end_ns``: ``time.perf_counter_ns()`` at entry and
    at exit (``time.perf_counter``'s clock), its own recording inside;
  * ``index``, a number counting every span the process opened, and
    ``parent``, the ``index`` of the span open around it on the same
    thread (None for a root);
  * ``unit``: its root's ``index``, shared by every span of one step, one
    ``generate`` call or one encode call;
  * ``device_ms``: where CUDA is in use, the time between two CUDA events
    (from a reused pool) recorded on the current stream at entry and at
    exit, filled in by :func:`spans`, which synchronises; None on the
    CPU.

Counters: :func:`count` adds a tensor of counts into a named counter kept
on the counts' device (one in-place add, no copy to the host) while
recording is on, and does nothing otherwise; :func:`counters` copies them
to the host. The expert layers of the Moonlight narrator
(``models/moonlight.py``) count the rows routed to each expert under
``moe.rows.<layer>``.

While ``torch.profiler`` runs, each span is also a
``torch.profiler.record_function`` range of its name, so that it appears
in the trace among the device's operations, on the profiler's clock.

The buffer keeps the last :data:`CAP` spans: older ones are dropped and
counted by :func:`dropped`. Spans are opened on the caller's thread only,
never inside an autograd Function, whose backward runs on autograd's own
threads.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

CAP = 1 << 16

_on = False
_lock = threading.Lock()
_buffer: collections.deque = collections.deque()
_free_events: list = []
_dropped = 0
_count = itertools.count()
_counters: dict[str, torch.Tensor] = {}


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_stack = _Stack()


class _Null:
    """The context :func:`span` returns with recording off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Span:
    """One recorded span, and the context that records it."""
    __slots__ = ("name", "index", "parent", "unit", "start_ns", "end_ns",
                 "device_ms", "_events", "_range")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = self.device_ms = self._events = self._range = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Span":
        self.start_ns = time.perf_counter_ns()
        stack = _stack.open
        self.index = next(_count)
        if stack:
            self.parent, self.unit = stack[-1].index, stack[-1].unit
        else:
            self.parent, self.unit = None, self.index
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if torch.cuda.is_initialized():
            self._events = _take_events()
            self._events[0].record()
        _add(self)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack.open.pop()
        self.end_ns = time.perf_counter_ns()
        return False


def span(name: str):
    """A context manager that records a span named ``name`` while
    recording is on, and does nothing otherwise."""
    if not _on:
        return _NULL
    return Span(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _take_events() -> list:
    with _lock:
        if len(_free_events) >= 2:
            return [_free_events.pop(), _free_events.pop()]
    return [torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)]


def _release(s: Span) -> None:
    """Return a closed span's events to the pool (under ``_lock``)."""
    if s._events is not None and s.end_ns is not None:
        _free_events.extend(s._events)
        s._events = None


def _add(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) >= CAP:
            _release(_buffer.popleft())
            _dropped += 1
        _buffer.append(s)


def spans() -> list[Span]:
    """The recorded spans in the order they were opened, the closed ones'
    ``device_ms`` filled in (synchronising the card first where any is
    pending)."""
    with _lock:
        out = list(_buffer)
        pending = [(s, s._events) for s in out
                   if s._events is not None and s.end_ns is not None]
        for s, _ in pending:
            s._events = None
    if pending:
        torch.cuda.synchronize()
        for s, (start, end) in pending:
            s.device_ms = start.elapsed_time(end)
        with _lock:
            for _, events in pending:
                _free_events.extend(events)
    return out


def count(name: str, values: torch.Tensor) -> None:
    """Add ``values`` into the counter ``name`` (on their device, without
    a sync) while recording is on."""
    if not _on:
        return
    held = _counters.get(name)
    if held is None:
        _counters[name] = values.detach().clone()
    else:
        held += values


def counters() -> dict[str, torch.Tensor]:
    """The counters, copied to the host."""
    return {name: t.cpu() for name, t in _counters.items()}


def dropped() -> int:
    """How many spans the buffer's cap has dropped since the last
    :func:`reset`."""
    return _dropped


def reset() -> None:
    """Forget the recorded spans, the count of dropped ones and the
    counters."""
    global _dropped
    _counters.clear()
    with _lock:
        for s in _buffer:
            _release(s)
        _buffer.clear()
        _dropped = 0
