"""The numbers that decide ``correct``, and their limits.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the reference's norm of that leaf or of
the median leaf, whichever is larger (some gradients are all but zero),
and the worst leaf is the number. A packed projection (``qkv``) is three
leaves, its query, key and value thirds, so that the key bias, whose
gradient is nought to rounding under the softmax, is a leaf of its own.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the parameters' change: AdamW moves them by the
sign of their round-off alone.
"""

from __future__ import annotations

import statistics

import torch

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm


def leaves(name: str, t: torch.Tensor) -> list[tuple[str, torch.Tensor]]:
    """The comparison's leaves of one parameter."""
    if ".qkv." in name:
        return [(f"{name}[{part}]", c)
                for part, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    out = {}
    for name, t in tensors.items():
        for leaf, c in leaves(name, t):
            out[leaf] = float(torch.linalg.vector_norm(c.float()))
    return out


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                   keep=None) -> tuple[float, str]:
    """The largest ``|prog - ref| / max(ref, median ref)`` over the leaves
    in ``keep`` (all when None), and its leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap >= worst:
            worst, where = gap, n
    return worst, where


def moved_leaves(ref_grad: dict[str, float]) -> set[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return {n for n, v in ref_grad.items() if v >= SMALL_GRAD * med}


def check(name: str, value: float, limit: float, **extra) -> dict:
    return {"name": name, "value": value, "limit": limit, **extra}
