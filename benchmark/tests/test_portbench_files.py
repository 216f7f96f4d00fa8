"""Every file of the benchmark parses, meets the benchmark's contract on
names, units and keys, and agrees with ``BENCHMARK.json``; each
configuration's sizes are the port's model's at full size."""

import json
import re

import pytest
import torch

from benchmark.portbench import files, weights
from benchmark.reference import models as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
BENCH = files.benchmark_json()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert (files.ROOT / BENCH["command"][1]).is_file()


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)


def test_metrics_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"]
                                  for x in files.end_to_end(BENCH, cell)}
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in BENCH["workloads"]:
        names = {m["name"] for m in files.end_to_end(BENCH, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert files.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_workload_file(cell):
    w = files.workload(cell)
    entry = files.entry(BENCH, cell)
    for k in ("config", "traffic", "chips", "why"):
        assert w[k] == entry[k]
    files.config(w["config"], BENCH)
    files.traffic(w["traffic"])
    assert files.driver(w["driver"]).Driver
    assert w["check"]["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_file(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    r = files.reader(metric)
    assert (r.LAYER, r.UNIT, r.MOVES) == (entry["layer"], entry["unit"],
                                          entry["moves"])
    assert callable(r.read)


def test_one_layer_name_a_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


SPECS = {"tsfl336-distilbert": R.dual_encoder_spec,
         "narrator-tsfl336-gpt2xl": R.narrator_spec}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_config_is_the_ports_model(name):
    """The reference's parameters (from the configuration's sizes) are
    the port's zoo model's, by name and shape, on the meta device."""
    from lavila_tpu_torch.models import zoo
    cfg = files.config(name, BENCH)
    kwargs = {"gated_xattn": True} if "gpt2" in cfg else {}
    with torch.device("meta"):
        model = zoo._REGISTRY[cfg["model"]](
            num_frames=cfg["tower"]["num_frames"], **kwargs)
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert port == {n: tuple(s) for n, s in SPECS[name](cfg)}
    for n, s in SPECS[name](cfg):
        weights.rule(n, s, cfg["scalars"])  # every leaf has a rule
