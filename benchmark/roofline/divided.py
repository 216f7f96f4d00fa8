"""K1/K2/K6, the divided attention's patch phases (forward and backward).

Per call over (B, F, N, D) patches with ``heads`` heads and K keys per
query (N + 1 in the space phase, F + 1 in the time phase):

  * forward: reads q, k, v and the CLS key and value, writes the output
    and the fp32 log-sum-exp; 2 products of 2 operations per term;
  * backward: reads q, k, v, dO, the CLS key and value and the lse,
    writes dq, dk, dv and the CLS key's and value's gradients; 5
    products (S, dP, dV, dQ, dK).

These are ``chip_smoke.py``'s counts, frozen here.
"""

from __future__ import annotations

from benchmark.roofline import share

PATTERN = (r"\b(space|time|big)_(fwd|bwd)\w*kernel|\bdelta_kernel"
           r"|\bsum_groups_kernel")
FWD = "lavila_tpu_torch.kernels.divided._phase_fwd"
BWD = "lavila_tpu_torch.kernels.divided.divided_phase_bwd"


def _record(qp, kp, vp, ck, cv, *rest):
    axis, heads = (rest[0], rest[1]) if len(rest) < 6 else (rest[3],
                                                            rest[4])
    B, F, N, D = qp.shape
    return (B, F, N, D, heads, axis, qp.element_size(),
            str(qp.dtype).split(".")[-1])


PROBES = {FWD: _record, BWD: _record}


def cost(target: str, rec) -> tuple[float, float, str]:
    B, F, N, D, H, axis, it, dtype = rec
    rows = B * F * N
    keys = N + 1 if axis == "space" else F + 1
    if target == FWD:
        return ((4 * rows * D + 2 * B * D) * it + rows * H * 4,
                4 * rows * keys * D, dtype)
    return ((7 * rows * D + 4 * B * D) * it + rows * H * 4,
            10 * rows * keys * D, dtype)


def roofline(run) -> float | None:
    return share(run, PATTERN, PROBES, cost)
