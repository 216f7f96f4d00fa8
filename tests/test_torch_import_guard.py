"""The PyTorch port imports no JAX and no module of ``lavila_tpu``: it
keeps its own copies of the framework-free modules it needs.

The import runs in a subprocess because this test process already holds
jax and ``lavila_tpu`` (tests/conftest.py imports them)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "lavila_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import lavila_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lavila_tpu_torch.__path__,
                                                "lavila_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for entry in ("cli.eval_zeroshot", "cli.main_pretrain",
              "cli.main_finetune_retrieval",
              "cli.main_finetune_classification", "utils.tracking",
              "cli.main_infer_narrator", "cli.demo_narrator",
              "utils.meters", "config", "data.loader", "utils.random",
              "eval.metrics", "kernels.decode", "models.narrator",
              "models.distilbert", "eval.nlg", "models.beam",
              "cli.eval_narrator", "cli.demo_narrator_3rd_person",
              "models.openai_weights", "models.resnet_clip",
              "parallel.mesh", "utils.logging", "cli.launch",
              "parallel.sharding", "parallel.tensor", "ops.ring_attention"):
    assert f"lavila_tpu_torch.{entry}" in names, entry
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "lavila_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
            + sorted(PORT.rglob("*.cuh"))
            + [REPO / "chip_smoke.py", REPO / "scripts/profile_torch_encode.py",
               REPO / "scripts/time_spatial_phase.py",
               REPO / "tests/torch_dist_worker.py",
               REPO / "tests/torch_tp_worker.py"])


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b",
    r"^\s*(import|from)\s+lavila_tpu(\.|\s|$)",
    r"scaled_dot_product_attention\(",
    r"(\bF|functional)\.layer_norm\(",
    r"torch\.compile\(",
    r"cpp_extension",
])
def test_port_sources_avoid(pattern):
    """No port source imports JAX or any module of ``lavila_tpu``, calls
    a library attention or LayerNorm, compiles through torch.compile, or
    builds through PyTorch's C++ extension loader. (The library calls
    that ``chip_smoke.py`` times as yardsticks live in
    ``scripts/time_library_calls.py``, outside this list.)"""
    rx = re.compile(pattern, re.MULTILINE)
    hits = [f"{p.relative_to(REPO)}:{s.count(chr(10), 0, m.start()) + 1}"
            for p in _port_sources()
            for s in [p.read_text()] for m in rx.finditer(s)]
    assert not hits, hits
