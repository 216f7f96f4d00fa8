"""K9, the cached decode step's self-attention: per call, B rows of one
query over ``num_valid`` cached keys plus the new one, D = heads × 64.
Reads q, the valid rows of the K and V caches, the new k and v; writes
the output; 2 products of 2 operations per term (``chip_smoke.py``'s
counts, frozen here)."""

from __future__ import annotations

from benchmark.roofline import share

PATTERN = r"\bdecode_kernel"
# the decode step's dispatch site in GPT-2
CALL = "lavila_tpu_torch.models.gpt2.decode_attention"


def _record(q, k_cache, v_cache, k_new, v_new, num_valid, heads):
    return (q.shape[0], q.shape[-1], int(num_valid), q.element_size(),
            str(q.dtype).split(".")[-1])


PROBES = {CALL: _record}


def cost(target: str, rec) -> tuple[float, float, str]:
    B, D, nv, it, dtype = rec
    return ((2 * B * nv * D + 4 * B * D) * it, 4 * B * (nv + 1) * D, dtype)


def roofline(run) -> float | None:
    return share(run, PATTERN, PROBES, cost)
