"""The span readers (``metrics/*.py`` with ``SPANS``, through
``portbench/spans.py``) on a made-up window and made-up spans: each
gives the hand-computed value from the spans inside the untraced window
alone, and fails the run (``ReaderFault``) where a span it reads is
missing or the root spans and the units disagree."""

from types import SimpleNamespace

import pytest

from benchmark.portbench import files, spans
from benchmark.portbench.harness import RunView, Window
from benchmark.portbench.trace import ReaderFault

T0 = 1000.0  # the untraced window's start, perf_counter seconds
TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train",
         "update_device_ms.train")
NARRATE = ("step_issue_ms.narrate", "sync_wait_ms.narrate",
           "sampler_ms.narrate")


class Recorder:
    """Made-up spans, as the port's ``tracing.spans()`` gives them."""

    def __init__(self):
        self.list = []
        self.stack = []

    def add(self, name, start_ms, end_ms, device_ms=None):
        """A span from ``start_ms`` to ``end_ms`` after ``T0``, opened
        inside the last span :meth:`open` left open."""
        parent = self.stack[-1] if self.stack else None
        s = SimpleNamespace(
            name=name, index=len(self.list),
            parent=None if parent is None else parent.index,
            unit=len(self.list) if parent is None else parent.unit,
            start_ns=round((T0 + start_ms / 1e3) * 1e9),
            end_ns=round((T0 + end_ms / 1e3) * 1e9), device_ms=device_ms,
            host_ms=end_ms - start_ms)
        self.list.append(s)
        return s

    def open(self, *args, **kwargs):
        s = self.add(*args, **kwargs)
        self.stack.append(s)
        return s

    def close(self):
        self.stack.pop()

    def spans(self):
        return list(self.list)

    def dropped(self):
        return 0


def _view(units_ms):
    """A window from ``T0`` whose units end at ``units_ms`` after it."""
    ends = [T0 + e / 1e3 for e in units_ms]
    starts = [T0] + ends[:-1]
    return RunView({}, {}, Window(T0, [{"start": a, "end": b}
                                       for a, b in zip(starts, ends)]),
                   None, {})


@pytest.fixture
def reader(monkeypatch):
    """``name`` → its reader, reading ``rec``'s spans."""
    from lavila_tpu_torch.utils import tracing
    was = tracing.enabled()

    def load(name, rec):
        r = files.reader(name)
        monkeypatch.setattr(r, "TRACING", rec)
        return r

    yield load
    if not was:
        tracing.disable()


def _train(rec, at_ms, forward, backward, update, device):
    rec.open("train.step", at_ms, at_ms + 900)
    rec.open("train.forward", at_ms + 1, at_ms + 1 + forward)
    rec.add("encode.image", at_ms + 2, at_ms + 100)
    rec.close()
    t = at_ms + 1 + forward
    rec.add("train.backward", t, t + backward)
    rec.open("train.update", t + backward, t + backward + update,
             device_ms=device)
    rec.add("update.grads", t + backward + 1, t + backward + 2)
    rec.close()
    rec.close()


def _train_spans():
    """Two steps in a window of two units; one step before it (in
    set-up) and one after it (in the traced window)."""
    rec = Recorder()
    _train(rec, -1000, 5000, 5000, 5000, 5000)
    _train(rec, 0, 300, 400, 150, 40)
    _train(rec, 1000, 200, 500, 170, 60)
    _train(rec, 2500, 7000, 7000, 7000, 7000)
    return rec


@pytest.mark.parametrize("name,value", [
    ("forward_ms.train", 250), ("backward_ms.train", 450),
    ("update_ms.train", 160), ("update_device_ms.train", 50)])
def test_train_readers(reader, name, value):
    r = reader(name, _train_spans())
    assert r.read(_view([1000, 2000])) == pytest.approx(value)


def _generate(rec, at_ms, steps, sync=True):
    """A ``generate`` call: a prepare, then ``steps`` (step ms, sync ms,
    sample ms) decode steps; the first has no sync."""
    rec.open("narrate.generate", at_ms, at_ms + 1000)
    rec.add("narrate.prepare", at_ms + 1, at_ms + 5)
    t = at_ms + 5
    for i, (step, wait, sample) in enumerate(steps):
        rec.open("narrate.step", t, t + step)
        if i and sync:
            rec.add("narrate.sync", t, t + wait)
        rec.add("narrate.forward", t + wait, t + wait + 1)
        rec.add("narrate.sample", t + step - sample, t + step)
        rec.close()
        t += step
    rec.close()


def _narrate_spans(sync=True):
    """One ``generate`` in a window of one unit, the encode before it a
    root of its own; one ``generate`` before the window."""
    rec = Recorder()
    _generate(rec, -2000, [(100, 50, 10)] * 4, sync)
    rec.add("encode.image", 0, 50)
    _generate(rec, 60, [(10, 0, 4), (12, 2, 3), (15, 5, 5)], sync)
    return rec


@pytest.mark.parametrize("name,value", [
    # (10 + 12 - 2 + 15 - 5) / 3 forwards
    ("step_issue_ms.narrate", 10), ("sync_wait_ms.narrate", 7 / 3),
    ("sampler_ms.narrate", 4)])
def test_narrate_readers(reader, name, value):
    r = reader(name, _narrate_spans())
    assert r.read(_view([1100])) == pytest.approx(value)


@pytest.mark.parametrize("name", TRAIN + NARRATE)
def test_missing_spans_fail(reader, name):
    rec = Recorder()
    rec.add("narrate.generate" if "narrate" in name else "train.step",
            0, 10)
    with pytest.raises(ReaderFault, match="span in the untraced window"):
        reader(name, rec).read(_view([20]))


def test_missing_sync_fails(reader):
    with pytest.raises(ReaderFault, match="narrate.sync"):
        reader("sync_wait_ms.narrate", _narrate_spans(sync=False)).read(
            _view([1100]))


@pytest.mark.parametrize("name", TRAIN + NARRATE)
def test_roots_and_units_disagree(reader, name):
    rec = _narrate_spans() if "narrate" in name else _train_spans()
    view = _view([1100] if "narrate" in name else [1000, 2000])
    view.window.units.insert(0, {"start": T0, "end": T0})
    with pytest.raises(ReaderFault, match="root spans in a window"):
        reader(name, rec).read(view)


def test_device_time_none_without_a_card(reader):
    """No span with device time (a run on the CPU): no reading; some
    with and some without: a fault."""
    rec = _train_spans()
    for s in rec.list:
        s.device_ms = None
    r = reader("update_device_ms.train", rec)
    assert r.read(_view([1000, 2000])) is None
    next(s for s in rec.list if s.name == "train.update"
         and T0 * 1e9 < s.start_ns < (T0 + 1) * 1e9).device_ms = 3.0
    with pytest.raises(ReaderFault, match="no device time"):
        r.read(_view([1000, 2000]))


@pytest.mark.parametrize("name", TRAIN + NARRATE)
def test_no_reading_from_a_program_without_spans(reader, name):
    """Against a checkout whose port has no ``utils/tracing.py`` the
    reader gives no reading and does not fail."""
    assert reader(name, None).read(_view([1000])) is None


def test_start_switches_recording_on():
    from lavila_tpu_torch.utils import tracing
    was = tracing.enabled()
    try:
        tracing.disable()
        assert spans.start() is tracing and tracing.enabled()
    finally:
        if not was:
            tracing.disable()
