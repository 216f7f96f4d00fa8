"""The sampler's distribution, plainly: temperature, then top-k, then the
nucleus (the smallest set, by descending probability, whose mass reaches
``top_p``), from the reference's float32 logits at one position.

A served token is judged by where it lies in that distribution:

  * its preceding mass: the tempered probability of every token more
    probable than it. The token lies in the nucleus when that is under
    ``top_p``; ``excess`` is the preceding mass less ``top_p`` (below 0
    inside);
  * its place ``u``: (preceding mass + a uniform draw × its own
    probability) over the nucleus's mass, capped at 1. Tokens drawn from
    the distribution have ``u`` uniform on [0, 1] (the probability
    integral transform, randomised for a discrete law), so the
    Kolmogorov-Smirnov distance of the ``u`` of many tokens from the
    uniform law measures how far the draws stray from it (a temperature
    not applied, another row's logits).
"""

from __future__ import annotations

import torch


def tempered(logits: torch.Tensor, temperature: float,
             top_k: int | None) -> torch.Tensor:
    """Probabilities ``(n, V)`` after temperature and top-k."""
    z = logits.float()
    if temperature and temperature != 1.0:
        z = z / temperature
    if top_k:
        kth = torch.topk(z, min(top_k, z.shape[-1]), dim=-1).values[..., -1:]
        z = torch.where(z < kth, float("-inf"), z)
    return torch.softmax(z, dim=-1)


def placement(logits: torch.Tensor, served: torch.Tensor, uniform:
              torch.Tensor, temperature: float, top_k: int | None,
              top_p: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(excess, u)`` of the served tokens ``(n,)`` at logits ``(n, V)``;
    ``uniform`` ``(n,)`` holds the draws in [0, 1)."""
    probs = tempered(logits, temperature, top_k)
    own = probs.gather(-1, served[:, None])[:, 0]
    before = torch.where(probs > own[:, None], probs, 0.0).sum(-1)
    desc = torch.sort(probs, dim=-1, descending=True).values
    keep = (desc.cumsum(-1) - desc) < top_p
    mass = torch.where(keep, desc, 0.0).sum(-1)
    u = ((before + uniform * own) / mass).clamp(max=1.0)
    return before - top_p, u


def ks_uniform(u: torch.Tensor) -> float:
    """The Kolmogorov-Smirnov distance of the values ``u`` from the
    uniform law on [0, 1]."""
    if u.numel() == 0:
        return float("inf")
    s = torch.sort(u.double().flatten()).values
    n = s.numel()
    i = torch.arange(1, n + 1, dtype=torch.float64, device=s.device)
    return float(torch.maximum(i / n - s, s - (i - 1) / n).max())
