"""Everything a run reads, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. The rest sits in files of its own under
``benchmark/``:

  * a configuration: the file its ``BENCHMARK.json`` entry names;
  * a cell: ``workloads/<cell>.json`` (its configuration, traffic,
    chips, driver, why and the limits of its check);
  * a traffic mix: ``traffic/<traffic>.json``, parameters that
    ``portbench.traffic`` reads;
  * a driver: the module ``benchmark.drivers.<driver>``;
  * a per-layer metric: ``metrics/<metric>.py``, a reader with ``read``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def bench_dir(root: Path = ROOT) -> Path:
    return root / "benchmark"


def workload(name: str, root: Path = ROOT) -> dict:
    cell = load_json(bench_dir(root) / "workloads" / f"{name}.json")
    return {"name": name, **cell}


def config(name: str, bench: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return {"name": name, **load_json(root / entry["file"])}


def traffic(name: str, root: Path = ROOT) -> dict:
    return {"name": name,
            **load_json(bench_dir(root) / "traffic" / f"{name}.json")}


def entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those with no list that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str, root: Path = ROOT):
    """The module of ``metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")
