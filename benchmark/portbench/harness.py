"""One run of one cell: set-up, the closed-loop window, the readings and
the comparison with the reference, and the result line.

A run is ``Driver(ctx)`` (set-up: the program built through its entry
points, the weights and the input pool drawn from the seed on the
device, the cell's shapes warmed), then the window: one caller, each
unit (a step, a call, a batch) started when the previous one has
returned and ended at a synchronise or a copy to the host, whole units
until ``seconds`` have passed. With ``trace`` a second window of
``seconds`` follows under the profiler and the probes: the per-layer
readers take what the device ran from the traced window, and what the
host's clock times from the untraced one, which the profiler's own cost
does not slow. Then the program is freed and the driver compares what
both windows produced with the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.portbench import files, guard
from benchmark.portbench.trace import Tracer

# the reference's lower precisions that a control run reads
CONTROLS = ("fp8", "fp8attn")

# the port's launch counters, by module
COUNTERS = ("divided", "layernorm", "decode", "flash")


@dataclasses.dataclass
class Context:
    root: Path
    bench: dict
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    device: str
    controls: tuple = ()
    split: dict = dataclasses.field(default_factory=dict)

    def timed(self, name: str, t0: float) -> float:
        """Record a set-up stage that started at ``t0``; return now."""
        now = time.perf_counter()
        self.split[name] = self.split.get(name, 0.0) + now - t0
        return now

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    t0: float
    units: list  # dicts: start, end, work, issue_s, and the driver's keys

    @property
    def elapsed(self) -> float:
        return self.units[-1]["end"] - self.t0

    @property
    def work(self) -> float:
        return sum(u["work"] for u in self.units)


@dataclasses.dataclass
class RunView:
    """What a per-layer reader reads: the untraced window (host-clock
    readings), the profiler's summary of the traced one and the probes'
    calls in it."""
    cfg: dict
    traffic: dict
    window: Window
    summary: dict | None
    calls: dict


def launch_counts() -> dict:
    out = {}
    for mod in COUNTERS:
        m = sys.modules.get(f"lavila_tpu_torch.kernels.{mod}")
        for k, v in getattr(m, "launches", {}).items():
            out[f"{mod}.{k}"] = v
    return out


def run_window(unit, seconds: float, first: int = 0,
               min_units: int = 1) -> Window:
    """Whole units until ``seconds`` have passed, and ``min_units`` at
    least."""
    units = []
    t0 = time.perf_counter()
    i = first
    while True:
        start = time.perf_counter()
        rec = unit(i)
        rec.update(start=start, end=time.perf_counter())
        units.append(rec)
        i += 1
        if rec["end"] - t0 >= seconds and len(units) >= min_units:
            return Window(t0, units)


def info(**fields) -> None:
    """An earlier line of the run's output."""
    print("bench-info " + json.dumps(fields), flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = files.ROOT,
             t_start: float | None = None, control: bool = False
             ) -> tuple[dict, dict]:
    """Run the cell once; returns the result line and the driver's
    further readings (with ``control``, the lower-precision controls')."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = files.benchmark_json(root)
    files.entry(bench, name)
    cell = files.workload(name, root)
    ctx = Context(root, bench, cell, files.config(cell["config"], bench, root),
                  files.traffic(cell["traffic"], root), seed, device,
                  CONTROLS if control else ())
    readers = {m["name"]: files.reader(m["name"], root)
               for m in files.per_layer(bench, name)} if trace else {}
    probes = {}
    for r in readers.values():
        probes.update(getattr(r, "PROBES", {}))
    drv = files.driver(cell["driver"]).Driver(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    before = launch_counts()
    window = run_window(drv.unit, seconds,
                        min_units=getattr(drv, "min_units", 1))
    ctx.sync()
    whole = window
    with Tracer(trace, probes) as tracer:
        if trace:
            traced = run_window(drv.unit, seconds, len(window.units))
            ctx.sync()
            whole = Window(window.t0, window.units + traced.units)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    after = launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}  # over both windows
    found = guard.forbidden_loaded()
    if found:
        raise guard.ForbiddenImport(found)
    metrics = {}
    if trace:
        view = RunView(ctx.cfg, ctx.traffic, window, tracer.summary,
                       dict(tracer.probes.calls))
        for m in files.per_layer(bench, name):
            value = readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = drv.end_to_end(window)
        for m in files.end_to_end(bench, name):
            value = setup_s if m["name"] == "setup_s" else values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info(cell=name, seed=seed, seconds=seconds, trace=trace,
         units=len(window.units), window_s=window.elapsed,
         unit_s=[round(u["end"] - u["start"], 4) for u in window.units],
         work=window.work, setup_s=setup_s, setup_split=ctx.split,
         traced_units=len(whole.units) - len(window.units),
         launches_per_unit={k: v / len(whole.units)
                            for k, v in sorted(launches.items())},
         **drv.describe(window))
    drv.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    checks, failed, extra = drv.check(whole)
    found = guard.forbidden_loaded()
    if found:
        raise guard.ForbiddenImport(found)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": drv.attempted(whole), "failed": failed,
              "metrics": metrics,
              "device": guard.describe(device, cell["chips"], peak)}
    if trace and tracer.summary is not None:
        result["device"].update(busy_s=tracer.summary["busy_s"],
                                window_s=tracer.summary["window_s"])
        result["breakdown"] = tracer.summary["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result, extra
