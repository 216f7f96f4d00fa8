"""K4/K5's plain versions (the port's fused add + LayerNorm) against the
JAX package's ``fused_add_layernorm`` and ``fused_add_layernorm_nosum``
and their VJPs (the Pallas kernels in interpret mode), fp32 and bf16, and
the port's ``LayerNorm(x, residual, return_sum)`` against the JAX
module's at both of the TimeSformer block's sites. fp32: dx atol 1e-5,
dγ/dβ (sums over rows) 1e-4; bf16: one bf16 rounding of unit-scale values
(2e-2), dγ/dβ relative 1e-3 (sums of bf16 rounded products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.ops.basic import LayerNorm as JaxLayerNorm
from lavila_tpu.ops.pallas.layernorm import (fused_add_layernorm,
                                             fused_add_layernorm_nosum)
from lavila_tpu_torch.kernels import layernorm as K
from lavila_tpu_torch.ops.basic import LayerNorm

torch.set_num_threads(1)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    a, b, dy, ds = (rng.normal(size=shape).astype(np.float32)
                    for _ in range(4))
    w = (rng.normal(size=(D,)) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return a, b, w, bias, dy, ds


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, rtol=0.0, rel=False, name=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    if rel:
        tol = tol * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_sum", [True, False])
# ragged row counts too: one row, 8, 2 x 77 + 3
@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 24, 768), (1, 1, 768),
                                   (1, 8, 1024), (1, 2 * 77 + 3, 128)])
def test_add_layernorm_matches_pallas(shape, return_sum, dtype):
    a, b, w, bias, dy, ds = _inputs(shape, seed=shape[-1])
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ja, jb = jnp.asarray(a, jd), jnp.asarray(b, jd)
    fn = fused_add_layernorm if return_sum else fused_add_layernorm_nosum
    want, vjp = jax.vjp(lambda a_, b_, w_, c_: fn(a_, b_, w_, c_, 1e-6, True),
                        ja, jb, jnp.asarray(w), jnp.asarray(bias))
    cot = ((jnp.asarray(dy, jd), jnp.asarray(ds, jd)) if return_sum
           else jnp.asarray(dy, jd))
    wgrads = vjp(cot)

    ta, tb = (torch.from_numpy(_np(x)).to(td).requires_grad_()
              for x in (ja, jb))
    tw, tbias = (torch.from_numpy(x).requires_grad_() for x in (w, bias))
    got = K.add_layer_norm(ta, tb, tw, tbias, 1e-6, return_sum)
    outs = got if return_sum else (got,)
    cots = [torch.from_numpy(_np(c)).to(td)
            for c in (cot if return_sum else (cot,))]
    grads = torch.autograd.grad(outs, (ta, tb, tw, tbias), cots)
    fp32 = dtype == "float32"
    # bf16: where the fp32 values straddle a rounding boundary, one ulp
    # (2^-8 relative) of values beyond 2
    tol, rtol = (1e-5, 0.0) if fp32 else (2e-2, 1e-2)
    for o, x, name in zip(outs, want if return_sum else (want,),
                          ("y", "sum")):
        assert o.dtype == td
        _close(o.detach(), x, tol, rtol, name=name)
    for g, x, name in zip(grads, wgrads, ("da", "db", "dscale", "dbias")):
        if name in ("da", "db"):
            _close(g, x, tol, rtol, name=name)
        else:
            _close(g, x, 1e-4 if fp32 else 1e-3, rel=not fp32, name=name)


def test_bwd_reference_folds_dsum_and_readds_the_pair():
    """The backward's two forms: K4 reads the saved sum and adds d(sum)
    into dx; K5 re-adds the pair in fp32. In fp32 both equal autograd of
    the plain forward."""
    a, b, w, bias, dy, ds = map(torch.from_numpy,
                                _inputs((4, 6, 64), seed=1))
    leaves = [t.clone().requires_grad_() for t in (a, b, w, bias)]
    y, s = K.add_layer_norm_reference(*leaves, 1e-6)
    want = torch.autograd.grad((y, s), leaves, (dy, ds))
    k4 = K.add_layer_norm_bwd(s.detach(), None, w, dy, ds, 1e-6)
    y5 = K.add_layer_norm_reference(*leaves, 1e-6, return_sum=False)
    want5 = torch.autograd.grad(y5, leaves, dy)
    k5 = K.add_layer_norm_bwd(a, b, w, dy, None, 1e-6)
    for got, ref in ((k4, want), (k5, want5)):
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[0], ref[1], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], ref[2], atol=1e-4, rtol=0)
        torch.testing.assert_close(got[2], ref[3], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="saved sum with dsum"):
        K.add_layer_norm_bwd(a, b, w, dy, ds, 1e-6)


@pytest.mark.parametrize("return_sum", [True, False])
def test_layernorm_module_residual_sites_match_jax(return_sum):
    """``norm2(s_pat, residual=patches)`` (K4) and ``norm1(t_pat,
    residual=patches, return_sum=False)`` (K5) on the tower's 4-D patch
    tensors, against the JAX module (its XLA path: fp32, where rounding
    the sum first changes nothing)."""
    a, b, w, bias, _, _ = _inputs((2, 4, 9, 64), seed=2)
    ln = LayerNorm(64, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(bias))
    got = ln(torch.from_numpy(a), residual=torch.from_numpy(b),
             return_sum=return_sum)
    want = JaxLayerNorm(epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(bias)}},
        jnp.asarray(a), jnp.asarray(b), return_sum)
    if return_sum:
        for g, x in zip(got, want):
            _close(g.detach(), x, 1e-5)
    else:
        _close(got.detach(), want, 1e-5)
