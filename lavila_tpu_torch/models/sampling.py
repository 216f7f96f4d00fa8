"""Logits warpers and sampling helpers.

Counterpart of ``lavila_tpu/models/sampling.py`` (the HF logits
processors the reference chains): temperature, then top-k, then top-p,
then a categorical draw. Each works on ``(B, V)`` fp32 logits and keeps
the shape, masking with the most negative fp32 value instead of -inf.

Top-p keeps the JAX package's sort-free bisection (40 halvings of a
probability threshold on ``[0, max_prob]``), so the kept set is the same
as JAX's (its caveat on near-ties deep in a long tail included); the
sort path is kept for ``min_tokens_to_keep > 1``. The draw takes an
explicit ``torch.Generator``; torch's random stream is not jax's, so
sampled tokens agree with the JAX package only in distribution.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def apply_temperature(logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / temperature


def apply_top_k(logits: torch.Tensor, k: int,
                min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if k <= 0:
        return logits
    k = min(max(k, min_tokens_to_keep), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float,
                min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set, by descending
    probability, whose mass reaches ``p`` (see the module docstring for
    the bisection)."""
    if p >= 1.0:
        return logits
    if min_tokens_to_keep <= 1:
        probs = torch.softmax(logits.float(), dim=-1)
        hi = probs.amax(dim=-1, keepdim=True)  # mass(hi) may be < p
        lo = torch.zeros_like(hi)              # mass(0) = 1 >= p
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
            ok = mass >= p  # mid still keeps enough mass
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return torch.where(probs >= lo, logits, NEG_INF)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the entries whose preceding mass is < p (the crossing one too)
    keep = (cum - probs) < p
    keep[..., :min_tokens_to_keep] = True
    num_keep = keep.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, num_keep - 1)
    return torch.where(logits < thresh, NEG_INF, logits)


def warp_logits(logits: torch.Tensor, temperature: float = 1.0,
                top_k: int | None = None, top_p: float | None = None,
                min_tokens_to_keep: int = 1) -> torch.Tensor:
    """The reference's warper order: temperature, top-k, top-p."""
    logits = logits.float()
    if temperature and temperature != 1.0:
        logits = apply_temperature(logits, temperature)
    if top_k:
        logits = apply_top_k(logits, top_k, min_tokens_to_keep)
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p, min_tokens_to_keep)
    return logits


def sample_token(generator: torch.Generator | None,
                 logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row from ``softmax(logits)`` → ``(B,)``
    int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of ``softmax(logits)`` per row, in nats (the
    reference's perplexity proxy for free-running generation)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = logp.exp()
    return -torch.where(p > 0, p * logp, 0.0).sum(-1)
