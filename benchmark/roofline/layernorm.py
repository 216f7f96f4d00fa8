"""K3/K4/K5, the LayerNorm kernels (forward and backward).

Per call over R rows of D values (``it`` bytes each; γ and β of ``wit``
bytes each):

  * forward: reads x (and the residual), γ, β; writes y (and the sum
    under K4); ~8 fp32 operations an element (9 with the add);
  * backward: reads x (or the pair, or the sum with its gradient), dy,
    γ; writes dx, dγ, dβ; ~12 fp32 operations an element (13 with the
    residual).

These are ``chip_smoke.py``'s counts, frozen here (γ/β at their own
width).
"""

from __future__ import annotations

from benchmark.roofline import share

PATTERN = r"\bln_(fwd|bwd)_kernel"
FWD = "lavila_tpu_torch.kernels.layernorm._fwd"
BWD = "lavila_tpu_torch.kernels.layernorm._bwd"


def _fwd(x, residual, weight, bias, eps, emit_sum, counter):
    return (x.numel(), x.shape[-1], x.element_size(),
            weight.element_size(), residual is not None, bool(emit_sum))


def _bwd(x, residual, weight, dy, dsum, eps, counter):
    return (x.numel(), x.shape[-1], x.element_size(),
            weight.element_size(), residual is not None, dsum is not None)


PROBES = {FWD: _fwd, BWD: _bwd}


def cost(target: str, rec) -> tuple[float, float, str]:
    n, D, it, wit, residual, extra = rec
    if target == FWD:
        rows_io = 2 + residual + extra          # x, y, residual, sum
        return (rows_io * n * it + 2 * D * wit, (9 if residual else 8) * n,
                "float32")
    rows_io = 3 + (residual or extra)           # x, dy, dx, residual/dsum
    return (rows_io * n * it + 3 * D * wit,
            (13 if residual or extra else 12) * n, "float32")


def roofline(run) -> float | None:
    return share(run, PATTERN, PROBES, cost)
