"""K6's plain version (the port's spatial phase over frames of more than
256 patches) against the JAX package's ``spatial_phase_big`` and its VJP,
the Pallas kernels in interpret mode, at the 336px geometry (N = 576
patches, 577 keys with the CLS one); and the port's
``divided_attention_split(axis="space")`` at N = 576 against JAX's with
the Pallas backend, which routes there. fp32: forward atol 1e-4,
gradients 5e-4 (the same formulas summed in another order; JAX's
backward takes delta as Σ P·dP over the keys, the port's as rowsum(dO·O))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.ops import attention as JA
from lavila_tpu.ops.pallas import divided as JD
from lavila_tpu_torch.kernels import divided as K
from lavila_tpu_torch.ops.attention import divided_attention_split

torch.set_num_threads(1)

GRADS = ("dq", "dk", "dv", "dck", "dcv")


def _inputs(B, F, N, H, d, seed):
    rng = np.random.default_rng(seed)
    D = H * d
    tok = [rng.normal(size=(B, F, N, D)).astype(np.float32)
           for _ in range(4)]  # q, k, v, dO
    cls = [rng.normal(size=(B, D)).astype(np.float32) for _ in range(2)]
    return tok[:3] + cls, tok[3]


@pytest.fixture()
def pallas_backend():
    old = JA.get_attention_backend()
    JA.set_attention_backend("pallas")
    yield
    JA.set_attention_backend(old)


@pytest.mark.parametrize("B,F,N,H,d", [(1, 2, 576, 2, 64),
                                       (1, 2, 300, 4, 16),
                                       # ragged: 21 x 21 patches, and one
                                       # query past 9 full tiles
                                       (1, 1, 441, 2, 64),
                                       (1, 1, 577, 2, 64)])
def test_space_big_reference_matches_pallas(B, F, N, H, d):
    ins, do = _inputs(B, F, N, H, d, seed=N + H)
    scale = d ** -0.5
    jins = [jnp.asarray(a) for a in ins]
    jout, jlse = JD._space_big_fwd(*jins, H, scale, True)
    assert N > K._MAX_SPACE_TOKENS  # the phase's K6 route
    out, lse = K.divided_phase(*map(torch.from_numpy, ins), "space", H,
                               scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    # JAX lays the lse out (B, H, F, N); the port's contract is (B, F, N, H)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).transpose(0, 2, 3, 1),
                               atol=1e-4, rtol=0)
    want = JD._space_big_bwd(*jins, jnp.asarray(do), jlse, H, scale, True)
    got = K.divided_phase_bwd(*map(torch.from_numpy, ins),
                              torch.from_numpy(do), out, lse, "space", H,
                              scale)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=0, err_msg=name)


def test_space_big_public_vjp_matches(pallas_backend):
    """Through the public entry points: JAX's custom VJP of
    ``spatial_phase_big`` against autograd of the port's phase (its
    operator, plain versions on the CPU)."""
    B, F, N, H, d = 1, 2, 576, 2, 64
    ins, do = _inputs(B, F, N, H, d, seed=3)
    scale = d ** -0.5
    out, vjp = jax.vjp(
        lambda *a: JD.spatial_phase_big(*a, H, scale, True),
        *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    got_out, _ = K.divided_phase(*leaves, "space", H, scale)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=1e-4, rtol=0)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=0, err_msg=name)


def test_divided_attention_split_n576_matches_jax(pallas_backend):
    """The CLS row and the patches of the spatial phase at N = 576, and
    their gradients, against JAX's split attention on its default
    N > 256 route (``spatial_phase_big``)."""
    rng = np.random.default_rng(5)
    B, F, N, H, d = 1, 2, 576, 2, 64
    cls = [rng.normal(size=(B, 1, H, d)).astype(np.float32)
           for _ in range(3)]
    pat = [rng.normal(size=(B, F, N, H, d)).astype(np.float32)
           for _ in range(3)]
    cot = [rng.normal(size=a.shape).astype(np.float32)
           for a in (cls[0], pat[0])]

    def jloss(*a):
        c, p = JA.divided_attention_split(*a, "space")
        return jnp.sum(c * cot[0]) + jnp.sum(p * cot[1]), (c, p)

    (_, (jc, jp)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, cls + pat))
    leaves = [torch.from_numpy(a).requires_grad_() for a in cls + pat]
    tc, tp = divided_attention_split(*leaves, "space")
    loss = (tc * torch.from_numpy(cot[0])).sum() + \
        (tp * torch.from_numpy(cot[1])).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-4, rtol=0)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=0, err_msg=f"input {i}")
