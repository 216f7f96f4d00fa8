"""The plain versions of the backward kernels (K1/K2 bwd, K3 bwd) against
the JAX package's Pallas backward in interpret mode and against torch
autograd of the port's own plain forward, on the same numpy inputs; and
the autograd Functions the wrappers route through. fp32, atol 1e-5 (the
same fp32 formulas, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.ops.pallas import divided as JD
from lavila_tpu.ops.pallas import layernorm as JL
from lavila_tpu_torch.kernels import divided as K
from lavila_tpu_torch.kernels import layernorm as KL

torch.set_num_threads(1)

PHASES = [("space", 2, 4, 24, 3, 16), ("time", 2, 4, 24, 3, 16),
          ("space", 1, 16, 8, 2, 16), ("time", 1, 16, 8, 2, 16),
          ("space", 1, 2, 256, 2, 64),  # TSF-L@224's frame
          ("time", 1, 8, 13, 2, 16),    # 8 frames
          ("time", 1, 16, 11, 2, 16)]   # 16, N off the Pallas row tile
GRADS = ("dq", "dk", "dv", "dck", "dcv")


def _phase_inputs(B, F, N, H, d, seed):
    rng = np.random.default_rng(seed)
    D = H * d
    tok = [rng.normal(size=(B, F, N, D)).astype(np.float32)
           for _ in range(4)]  # q, k, v, dO
    cls = [rng.normal(size=(B, D)).astype(np.float32) for _ in range(2)]
    return tok[:3] + cls, tok[3]


@pytest.mark.parametrize("axis,B,F,N,H,d", PHASES)
def test_phase_bwd_reference_matches_pallas(axis, B, F, N, H, d):
    ins, do = _phase_inputs(B, F, N, H, d, seed=F * N + H)
    scale = d ** -0.5
    jins = [jnp.asarray(a) for a in ins]
    jout, jlse = JD._phase_fwd(*jins, axis, H, scale, True)
    want = JD._phase_bwd(*jins, jnp.asarray(do), jlse, jout, axis, H, scale,
                         True)
    # the Pallas lse pads heads to a lane multiple; the first H are real
    got = K.divided_phase_bwd_reference(
        *map(torch.from_numpy, ins), torch.from_numpy(do),
        torch.from_numpy(np.array(jout)),
        torch.from_numpy(np.asarray(jlse)[..., :H].copy()), axis, H, scale)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("axis,B,F,N,H,d", PHASES)
def test_phase_bwd_reference_matches_autograd(axis, B, F, N, H, d):
    ins, do = _phase_inputs(B, F, N, H, d, seed=7)
    scale = d ** -0.5
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    out, lse = K.divided_phase_reference(*leaves, axis, H, scale)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = K.divided_phase_bwd_reference(
        *(t.detach() for t in leaves), torch.from_numpy(do), out.detach(),
        lse, axis, H, scale)
    for name, g, w in zip(GRADS, got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)


@pytest.mark.parametrize("axis", ["space", "time"])
def test_divided_phase_grad_through_function_on_strided_views(axis):
    """``divided_phase`` on row views of one qkv output (row stride 3D),
    as the attention block calls it, differentiates through the
    operator: the same gradients as autograd of the plain forward."""
    B, F, N, H, d = 2, 3, 5, 2, 8
    D = H * d
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, requires_grad=True)
    cls = torch.randn(B, 3 * D, generator=gen, requires_grad=True)
    do = torch.randn(B, F, N, D, generator=gen)

    def grads(fn):
        q, k, v = qkv.chunk(3, dim=-1)
        _, ck, cv = cls.chunk(3, dim=-1)
        out, _ = fn(q, k, v, ck, cv, axis, H, d ** -0.5)
        return torch.autograd.grad(out, (qkv, cls), do)

    for g, w in zip(grads(K.divided_phase),
                    grads(K.divided_phase_reference)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_phase_bwd_rejects_bad_input():
    B, F, N, H, d = 1, 2, 3, 2, 4
    D = H * d
    q = torch.zeros(B, F, N, D)
    ck = torch.zeros(B, D)
    lse = torch.zeros(B, F, N, H)
    with pytest.raises(ValueError, match="do/out must be"):
        K.divided_phase_bwd(q, q, q, ck, ck, q[:, :1], q, lse, "space", H,
                            1.0)
    with pytest.raises(TypeError, match="lse float32"):
        K.divided_phase_bwd(q, q, q, ck, ck, q, q, lse.double(), "time", H,
                            1.0)


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    w = (rng.normal(size=(D,)) * 0.3 + 1.0).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
# ragged row counts too: one row, 8 (CLS rows), 2 captions of 77 + 3
@pytest.mark.parametrize("shape", [(2, 77, 512), (3, 40, 768), (1, 1, 768),
                                   (1, 8, 1024), (1, 2 * 77 + 3, 512)])
def test_layernorm_bwd_reference_matches_pallas(shape, eps):
    x, w, dy = _ln_inputs(shape, 0)
    want = JL._bwd_call((jnp.asarray(x),), jnp.asarray(w), jnp.asarray(dy),
                        None, eps, True)
    got = KL.layer_norm_bwd_reference(*map(torch.from_numpy, (x, w, dy)),
                                      eps)
    for name, g, v in zip(("dx", "dweight", "dbias"), got, want):
        # dγ/dβ sum 80-154 rows of unit-scale values: atol scaled by 10
        tol = 1e-5 if name == "dx" else 1e-4
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=tol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 4, 16, 64), (5, 512)])
def test_layernorm_bwd_reference_and_function_match_autograd(shape):
    x, w, dy = _ln_inputs(shape, 1)
    b = torch.zeros(shape[-1], requires_grad=True)
    leaves = [torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(w).requires_grad_(), b]
    y = KL.layer_norm_reference(*leaves, 1e-6)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = KL.layer_norm_bwd_reference(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(dy), 1e-6)
    via_fn = torch.autograd.grad(KL.layer_norm(*leaves, 1e-6), leaves,
                                 torch.from_numpy(dy))
    for g, f, v in zip(got, via_fn, want):
        torch.testing.assert_close(g, v, atol=1e-4, rtol=0)
        torch.testing.assert_close(f, v, atol=1e-4, rtol=0)


def test_layernorm_bwd_dtypes():
    """bf16 rows with fp32 γ/β, as the bf16 train step's working copy
    has them: dx bf16, dγ/dβ fp32."""
    x = torch.randn(3, 64).bfloat16().requires_grad_()
    w = torch.ones(64, requires_grad=True)
    b = torch.zeros(64, requires_grad=True)
    y = KL.layer_norm(x, w, b, 1e-5)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == b.grad.dtype == torch.float32
