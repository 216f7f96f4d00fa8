"""A later change adds a cell and a per-layer metric as new files and
entries of ``BENCHMARK.json``, editing no file of the benchmark, and the
harness finds and runs them by name."""

import hashlib
import json

from benchmark.portbench import files, harness

METRIC = '''"""Window units a second."""
LAYER, UNIT, MOVES = "models", "1/s", "encode_clips_per_s"


def read(run):
    return len(run.window.units) / run.window.elapsed
'''


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_files(mini_root):
    before = _hashes(mini_root)
    b = mini_root / "benchmark"
    (b / "traffic" / "new-traffic.json").write_text(json.dumps(
        {"batch": 2, "frames": 2, "pool": 3, "warmup": 1}))
    (b / "workloads" / "new-cell.json").write_text(json.dumps({
        "config": "mini-dual", "traffic": "new-traffic", "chips": 1,
        "driver": "encode", "why": "test",
        "check": {"limits": {"embed_err": 0.05}}}))
    (b / "metrics" / "units_per_s.new.py").write_text(METRIC)
    bench = files.benchmark_json(mini_root)
    bench["workloads"].append({"name": "new-cell", "config": "mini-dual",
                               "traffic": "new-traffic", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("encode_clips_per_s", "encode_ms_p95"):
            m["workloads"].append("new-cell")
    bench["per_layer"].append({
        "name": "units_per_s.new", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "models",
        "moves": "encode_clips_per_s", "workloads": ["new-cell"]})
    (mini_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run_cell("new-cell", 3, 0.5, True, "cpu",
                                 mini_root)
    assert result["correct"]
    assert result["metrics"]["units_per_s.new"]["value"] > 0
    result, _ = harness.run_cell("new-cell", 3, 0.5, False, "cpu",
                                 mini_root)
    assert set(result["metrics"]) == {"encode_clips_per_s", "encode_ms_p95",
                                      "setup_s"}
    after = _hashes(mini_root)
    assert all(after[p] == h for p, h in before.items())
    assert len(after) == len(before) + 3
