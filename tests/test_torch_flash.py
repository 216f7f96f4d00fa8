"""K7/K8's plain versions (``lavila_tpu_torch.kernels.flash``) against
the Pallas kernels ``flash_attention`` and ``fused_attention`` run in
interpret mode on the same numpy inputs, forward and gradients, and the
dispatch choosing K7 under no_grad and K8 under grad. The port's layout
is token-major (B, L, H, d), the JAX functions' head-major (B, H, L, d).
fp32 at atol 2e-5 / rtol 1e-4 and gradients at 5e-4 / 1e-3 (the JAX
package's own limits for these kernels); bf16 at 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.ops.pallas.flash_attention import (flash_attention,
                                                   fused_attention)
from lavila_tpu_torch.kernels import flash as KF
from lavila_tpu_torch.ops.attention import causal_attention

torch.set_num_threads(1)


def _inputs(seed, B, H, Lq, Lk, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, L, d)).astype(np.float32)
            for L in (Lq, Lk, Lk)]


def _port(x, dtype=torch.float32):
    """(B, H, L, d) numpy → the port's (B, L, H, d) tensor."""
    return torch.from_numpy(x).transpose(1, 2).to(dtype)


def _jax_layout(t):
    return t.float().transpose(1, 2).numpy()


@pytest.mark.parametrize("lq,lk,causal", [
    (197, 197, False),   # a TimeSformer space-attention group
    (64, 197, False),    # uneven q/kv
    (77, 77, True),      # the CLIP text tower
    (130, 260, False),   # several blocks on both axes
])
def test_forward_matches_pallas_interpret(lq, lk, causal):
    """K7's plain version and K8's forward (out and lse) against
    ``flash_attention`` in interpret mode; on the causal text-tower case
    also K8's forward against ``fused_attention``, and bf16 (the
    unnormalised probabilities rounded to bf16 before P·V, as the Pallas
    kernel does)."""
    q, k, v = _inputs(0, 2, 3, lq, lk, 64)
    want = np.asarray(flash_attention(q, k, v, causal=causal,
                                      interpret=True))
    got = KF.flash_attention_reference(*map(_port, (q, k, v)), causal)
    np.testing.assert_allclose(_jax_layout(got), want, atol=2e-5, rtol=1e-4)
    out, lse = KF.flash_fwd_reference(*map(_port, (q, k, v)), causal)
    np.testing.assert_allclose(_jax_layout(out), want, atol=2e-5, rtol=1e-4)
    assert lse.shape == (2, lq, 3) and lse.dtype == torch.float32
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    if causal:
        s = np.where(np.tril(np.ones((lq, lk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.transpose(1, 2).numpy(), want_lse,
                               atol=2e-5, rtol=1e-4)
    if not causal:
        return
    fused = np.asarray(fused_attention(q, k, v, True, None, 256, 256, 8,
                                       True))
    np.testing.assert_allclose(_jax_layout(out), fused, atol=2e-5, rtol=1e-4)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention(qb, kb, vb, causal=True,
                                      interpret=True), np.float32)
    got = KF.flash_attention_reference(
        *(_port(x, torch.bfloat16) for x in (q, k, v)), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_jax_layout(got), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("B,H,Lq,Lk,d,causal", [
    (1, 2, 67, 70, 32, False),
    (1, 1, 40, 40, 16, True),
])
def test_gradients_match_fused_attention_vjp(B, H, Lq, Lk, d, causal):
    """The gradient through K8 (its Function: plain forward, plain
    backward on the CPU) against ``jax.grad`` through ``fused_attention``
    in interpret mode, for the same cotangent."""
    q, k, v = _inputs(2, B, H, Lq, Lk, d)
    w = np.random.default_rng(3).normal(size=(B, H, Lq, d)).astype(
        np.float32)

    def loss(q, k, v):
        o = fused_attention(q, k, v, causal, None, 32, 32, 1, True)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [_port(x).requires_grad_() for x in (q, k, v)]
    out = KF.flash_attention(*ts, causal=causal)
    (out * _port(w)).sum().backward()
    for t, g, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(_jax_layout(t.grad), np.asarray(g),
                                   atol=5e-4, rtol=1e-3, err_msg=f"d{name}")


def test_bwd_reference_matches_autograd():
    """The plain backward (the kernel's signature: saved out and lse)
    equals autograd through the plain forward, causal and bf16-free."""
    q, k, v = (_port(x).double().float() for x in _inputs(4, 2, 3, 77, 77,
                                                           16))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = KF.flash_fwd_reference(*ts, True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, ts, do)
    got = KF.flash_bwd(q, k, v, do, out.detach(), lse.detach(), True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_dispatch_k7_under_no_grad_k8_under_grad(monkeypatch):
    """Counted through the plain functions: no_grad/inference_mode take
    K7's (forward only), an input that requires grad takes K8's forward
    and, in the backward, K8's backward."""
    calls = {"k7": 0, "k8": 0, "k8_bwd": 0}
    for name, key in (("flash_attention_reference", "k7"),
                      ("flash_fwd_reference", "k8"),
                      ("flash_bwd_reference", "k8_bwd")):
        fn = getattr(KF, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(KF, name, counted)
    qkv = torch.randn(2, 77, 3 * 64, requires_grad=True)
    q, k, v = (t.reshape(2, 77, 4, 16) for t in qkv.chunk(3, dim=-1))
    with torch.no_grad():
        causal_attention(q, k, v)
    with torch.inference_mode():
        causal_attention(q.detach(), k.detach(), v.detach())
    assert calls == {"k7": 2, "k8": 0, "k8_bwd": 0}
    causal_attention(q, k, v).square().sum().backward()
    assert calls == {"k7": 2, "k8": 1, "k8_bwd": 1}
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
    # nothing launched here: the kernels run only on CUDA tensors
    assert not any(KF.launches.values())


def test_rejects_bad_input():
    q = torch.zeros(1, 9, 2, 16)
    with pytest.raises(ValueError, match="B, Lq, H, d"):
        KF.flash_attention(q, q[:, :, :1], q)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        KF.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="lse"):
        KF.flash_bwd(q, q, q, q, q, torch.zeros(1, 9, 3))
