"""What every run checks about its process and its card.

  * No module of JAX or of the JAX package may be loaded in the process
    that prints the result: the top-level name of each loaded module is
    compared whole (``lavila_tpu_torch`` begins with ``lavila_tpu``).
  * The run finds the cards the cell asks for, or fails: there is no
    fallback to the CPU.
  * Every cache a run may write (the CUDA JIT's, Triton's, PyTorch's
    extension and kernel caches) is a fixed directory inside the
    checkout; the port builds its kernel library there too
    (``build/kernels``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lavila_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"loaded in the measuring process: {found}")


class NoDevice(RuntimeError):
    pass


def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the loaded
    modules' when None)."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


def set_env(root: Path) -> None:
    """The run's caches inside the checkout; no library loads JAX."""
    for var, sub in CACHES.items():
        path = root / "build" / "bench-cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def require_device(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the card "
                       "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} found")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def describe(device: str, chips: int, peak: int) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
