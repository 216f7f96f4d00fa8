"""Nothing that ``benchmark/run.py`` loads imports JAX or the JAX
package (top-level names compared whole), and the reference imports
nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.portbench import files, guard

BENCH_DIR = files.bench_dir()
LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark.portbench import files, harness, readings
for d in ("train", "encode", "narrate"):
    files.driver(d)
for m in files.benchmark_json()["per_layer"]:
    files.reader(m["name"])
import lavila_tpu_torch.models, lavila_tpu_torch.train.step
import lavila_tpu_torch.train.optim, lavila_tpu_torch.kernels.build
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH_DIR.parent)
    return set(__import__("json").loads(out.stdout.splitlines()[-1]))


def test_run_loads_no_jax():
    tops = _loaded(LOAD_ALL.format(root=str(files.ROOT)))
    assert "benchmark" in tops and "lavila_tpu_torch" in tops
    assert not tops & set(guard.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "lavila_tpu_torch", *guard.FORBIDDEN), (path, n)
    tops = _loaded(
        f"import json, sys; sys.path.insert(0, {str(files.ROOT)!r}); "
        "import benchmark.reference.models; "
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert "lavila_tpu_torch" not in tops
    assert not tops & set(guard.FORBIDDEN)


def test_guard_compares_whole_names():
    assert guard.forbidden_loaded(["lavila_tpu_torch.models", "jaxlibx",
                                   "flaxen.core", "numpy"]) == []
    assert guard.forbidden_loaded(["lavila_tpu.models", "jax.numpy",
                                   "optax"]) == ["jax", "lavila_tpu",
                                                 "optax"]


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "tsfl336-encode-b16", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_only_the_benchmark_no_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark the
    run cannot import the program: it exits non-zero, no result."""
    import shutil
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark")
    shutil.copy(files.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tsfl336-encode-b16", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and not out.stdout.strip()
