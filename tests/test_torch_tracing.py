"""The port's spans (``lavila_tpu_torch/utils/tracing.py``) on the CPU,
at the MINI sizes: off by default and then inert, their places and
parents in a train step and in ``VCLM.generate``, results unchanged by
recording, the spans in a ``torch.profiler`` trace, the buffer's cap and
the CUDA events' pool; and the benchmark's per-layer readers
(``benchmark/metrics/*.py``) against the port: every entry point a
reader probes resolves, and every span a reader reads is recorded."""

import importlib
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_clip_train_step
from lavila_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]
DUAL = "CLIP_OPENAI_TIMESFORMER_MINI"
NARRATOR = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
STEP = ("train.forward", "train.backward", "train.update")
UPDATE = ("update.grads", "update.average", "update.optimizer",
          "update.copy")
PREFIXES = ("train.", "update.", "encode.", "narrate.")


@pytest.fixture(autouse=True)
def recording_off():
    """Each test starts and ends with recording off and no spans."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _state() -> TrainState:
    model = build_model(DUAL, device="cpu", train=True)
    return TrainState.create(model, lambda p: O.make_optimizer(p, 1e-3),
                             dtype=torch.bfloat16)


def _batch(seed: int = 0, B: int = 2) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"frames": torch.randn(B, 4, 64, 64, 3, generator=g),
            "text": torch.randint(1, 49407, (B, 77), generator=g)}


def _steps(n: int = 2):
    """``n`` bf16 MINI steps from the seeded model: losses, masters."""
    state, step, losses = _state(), make_clip_train_step(), []
    for i in range(n):
        state, m = step(state, _batch(i))
        losses.append(m["loss"])
    return losses, state.params


def _narrator():
    return build_model(NARRATOR, device="cpu", gated_xattn=True)


def _generate(model, L: int):
    """Two clips × 2 samples of ``L`` tokens, EOS never sampled."""
    frames = torch.randn(2, 4, 64, 64, 3,
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tokens = model.encode_image(frames)
    return model.generate(tokens, generator=torch.Generator().manual_seed(3),
                          bos_id=50256, eos_id=-1, max_text_length=L,
                          temperature=0.7, top_p=0.95,
                          num_return_sequences=2)


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(child, parent) -> bool:
    return (parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


def test_off_is_inert(monkeypatch):
    """Off (the default), ``span`` returns one shared null context and
    records nothing; no profiler range and no CUDA event is made, even
    under the profiler and with CUDA in use."""
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")

    def fail(*args, **kwargs):
        raise RuntimeError("made while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.cuda, "Event", fail)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(1)
        _generate(_narrator(), 4)
    assert tracing.spans() == [] and tracing.dropped() == 0
    # the same patches fail a span with recording on
    tracing.enable()
    with pytest.raises(RuntimeError, match="while recording is off"):
        with tracing.span("x"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        with pytest.raises(RuntimeError, match="while recording is off"):
            with tracing.span("y"):
                pass


def test_train_step_spans():
    """One ``train.step`` root a step, its forward, backward and update
    as children in that order, the update's four stages under
    ``train.update``, the encode under the forward, one ``unit``; each
    child's host interval inside its parent's; no device time on the
    CPU."""
    tracing.enable()
    _steps(1)
    spans = tracing.spans()
    named = _by_name(spans)
    (root,) = named["train.step"]
    assert root.parent is None and root.unit == root.index
    assert all(s.unit == root.index for s in spans)
    children = [s for s in spans if s.parent == root.index]
    assert [s.name for s in children] == list(STEP)
    (update,) = named["train.update"]
    assert [s.name for s in spans if s.parent == update.index] == list(
        UPDATE)
    (forward,) = named["train.forward"]
    (encode,) = named["encode.image"]
    assert encode.parent == forward.index
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.device_ms is None
        if s.parent is not None:
            assert _inside(s, by_index[s.parent]), s
    assert sum(s.host_ms for s in children) <= root.host_ms


def test_generate_spans():
    """A ``generate`` of L tokens that never samples EOS: one
    ``narrate.generate`` root with one ``narrate.prepare`` and L - 1
    ``narrate.step`` children; each step holds one ``narrate.forward``
    and one ``narrate.sample``, and every step but the first one
    ``narrate.sync``: L - 1 forwards and samples, L - 2 syncs. The encode
    before it is a root of its own."""
    L = 6
    model = _narrator()
    tracing.enable()
    _generate(model, L)
    spans = tracing.spans()
    named = _by_name(spans)
    (encode,) = named["encode.image"]
    (root,) = named["narrate.generate"]
    assert encode.parent is None and root.parent is None
    assert encode.unit != root.unit
    assert [s.name for s in spans if s.parent == root.index] == [
        "narrate.prepare"] + ["narrate.step"] * (L - 1)
    assert len(named["narrate.forward"]) == L - 1
    assert len(named["narrate.sample"]) == L - 1
    assert len(named["narrate.sync"]) == L - 2
    for i, step in enumerate(named["narrate.step"]):
        inner = [s.name for s in spans if s.parent == step.index]
        assert inner == (["narrate.sync"] if i else []) + [
            "narrate.forward", "narrate.sample"]
    by_index = {s.index: s for s in spans}
    for s in spans:
        if s.parent is not None:
            assert _inside(s, by_index[s.parent]), s
            assert s.unit == root.unit


def test_recording_changes_no_result():
    """A train step's losses and masters, and ``generate``'s ids and
    perplexities from the same generator, are bit-identical with
    recording on and off."""
    off_losses, off_params = _steps(2)
    model = _narrator()
    off_ids, off_ppl = _generate(model, 6)
    tracing.enable()
    on_losses, on_params = _steps(2)
    on_ids, on_ppl = _generate(model, 6)
    assert tracing.spans()
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    assert off_params.keys() == on_params.keys()
    assert all(torch.equal(off_params[k], on_params[k]) for k in off_params)
    assert torch.equal(off_ids, on_ids) and torch.equal(off_ppl, on_ppl)


def test_spans_in_the_profiler_trace():
    """Under ``torch.profiler`` every recorded span is a user annotation
    of its name, in the same order, nested as recorded."""
    model = _narrator()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(1)
        _generate(model, 4)
    spans = tracing.spans()
    marks = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith(PREFIXES)),
                   key=lambda e: e.start_ns())
    assert [e.name() for e in marks] == [s.name for s in spans]
    mark = {s.index: e for s, e in zip(spans, marks)}
    for s in spans:
        if s.parent is not None:
            outer = mark[s.parent]
            assert (outer.start_ns() <= mark[s.index].start_ns()
                    and mark[s.index].end_ns() <= outer.end_ns()), s


def test_cap_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 4)
    tracing.enable()
    for i in range(10):
        with tracing.span(f"s{i}"):
            pass
    assert [s.name for s in tracing.spans()] == ["s6", "s7", "s8", "s9"]
    assert tracing.dropped() == 6
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped() == 0


class _Event:
    """A stand-in for ``torch.cuda.Event``: a record stamps a count."""
    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.at = None

    def record(self):
        _Event.clock += 1
        self.at = _Event.clock

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_device_time_from_pooled_events(monkeypatch):
    """With CUDA in use each span records an event at entry and at exit;
    ``spans()`` synchronises, fills ``device_ms`` from the pair and
    returns the events to the pool, which the next spans take."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: synced.append(1))
    monkeypatch.setattr(_Event, "made", 0)
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    outer, inner = tracing.spans()
    assert (outer.device_ms, inner.device_ms) == (3.0, 1.0)
    assert synced == [1] and _Event.made == 4
    with tracing.span("next"):
        pass
    with tracing.span("then"):
        pass
    assert _Event.made == 4  # both pairs from the pool
    assert [s.device_ms for s in tracing.spans()] == [3.0, 1.0, 1.0, 1.0]
    assert synced == [1, 1]


# ------------------------------------------- the benchmark's readers

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def recorded() -> set:
    """The names of the spans a MINI train step, encode call and
    ``generate`` record."""
    was = tracing.enabled()
    tracing.enable()
    try:
        _steps(1)
        _generate(_narrator(), 4)
        return {s.name for s in tracing.spans()}
    finally:
        if not was:
            tracing.disable()
        tracing.reset()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_benchmark_reader_reads_the_port(metric, recorded):
    """Each per-layer reader of ``BENCHMARK.json`` loads; the entry
    points its ``PROBES`` wrap are callables of the port, and the spans
    its ``SPANS`` name are recorded by the port, so that a rename fails
    here and not as a reader's fault on the card."""
    from benchmark.portbench import files
    reader = files.reader(metric)
    for target in getattr(reader, "PROBES", {}):
        module, attr = target.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(module), attr,
                                None)), target
    if hasattr(reader, "SPANS"):
        assert reader.TRACING is tracing and tracing.enabled()
        assert set(reader.SPANS) <= recorded, set(reader.SPANS) - recorded


def test_cls_row_kernels_outside_the_roofline_readers():
    """No kernel of ``csrc/cls_row.cu`` matches a roofline reader's
    ``PATTERN`` (``benchmark/roofline/*.py``): a reader counts the device
    time of the kernels its pattern matches against the calls it probes,
    so a CLS row kernel it took would fail the run as kernels with no
    probed call."""
    import re
    src = (REPO / "lavila_tpu_torch" / "csrc" / "cls_row.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert set(names) >= {"cls_row_fwd_kernel", "cls_row_bwd_kernel"}
    patterns = {}
    for path in sorted((REPO / "benchmark" / "roofline").glob("*.py")):
        module = importlib.import_module(f"benchmark.roofline.{path.stem}")
        if hasattr(module, "PATTERN"):
            patterns[path.stem] = module.PATTERN
    assert patterns
    for name in names:
        # as the profiler names a launch: the namespace, the template
        # arguments and the parameter list around the kernel's name
        shown = f"void (anonymous namespace)::{name}<__nv_bfloat16, true>" \
                f"(__nv_bfloat16 const*, float*, int)"
        for reader, pattern in patterns.items():
            assert not re.search(pattern, shown), (name, reader)
