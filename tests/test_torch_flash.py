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
    """The plain backward (the kernel's signature: the saved lse) equals
    autograd through the plain forward, causal and bf16-free."""
    q, k, v = (_port(x).double().float() for x in _inputs(4, 2, 3, 77, 77,
                                                           16))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = KF.flash_fwd_reference(*ts, True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, ts, do)
    got = KF.flash_bwd(q, k, v, do, lse.detach(), True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def _attention_grads_fp64(q, k, v, do):
    ins = [t.double().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", *ins[:2]) * q.shape[-1] ** -0.5
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), ins[2])
    return torch.autograd.grad(o, ins, do.double())


def test_bwd_delta_holds_near_copy_keys_bf16():
    """bf16 keys and values that share a large common part (as GPT-2's
    cross-attention sees the narrator's pooled image tokens at
    initialisation) make dq = dS·K cancel. The plain backward, delta =
    rowsum(P·dP), keeps dq within 10% of fp64 (nearer than autograd
    through the plain forward), where the Pallas kernels' delta,
    rowsum(dO·O) from the rounded O, misses it by more than dq's norm."""
    g = torch.Generator().manual_seed(0)
    B, Lq, Lk, H, d = 2, 76, 256, 4, 64

    def near_copies(L):
        return (torch.randn(B, 1, H, d, generator=g)
                + 0.05 * torch.randn(B, L, H, d, generator=g))
    q = torch.randn(B, Lq, H, d, generator=g).to(torch.bfloat16)
    k, v = (near_copies(Lk).to(torch.bfloat16) for _ in range(2))
    do = torch.randn(B, Lq, H, d, generator=g).to(torch.bfloat16)
    want = _attention_grads_fp64(q, k, v, do)[0]

    def rel(x):
        return ((x.double() - want).norm() / want.norm()).item()
    out, lse = KF.flash_fwd_reference(q, k, v)
    port = rel(KF.flash_bwd(q, k, v, do, lse)[0])
    qg = q.clone().requires_grad_()
    plain = rel(torch.autograd.grad(KF.flash_attention_reference(qg, k, v),
                                    qg, do)[0])
    # the Pallas kernels' dq: delta from the output rounded to bf16
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    pallas = rel(torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * d ** -0.5)
    assert port <= 0.1 and port < plain and pallas > 1.0, (port, plain,
                                                           pallas)


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
        KF.flash_bwd(q, q, q, q, torch.zeros(1, 9, 3))


def _in_proj_views(B, Lq, Lk, H, d, dtype=torch.bfloat16, pad=0):
    """q/k/v as head views of packed projections, as the text tower hands
    them over: one (B, L, 3·H·d + pad) in_proj output when Lq == Lk, else
    (B, Lq, H·d + pad) and (B, Lk, 2·H·d + pad)."""
    D = H * d
    if Lq == Lk:
        q, k, v = torch.zeros(B, Lq, 3 * D + pad, dtype=dtype)[
            ..., :3 * D].chunk(3, dim=-1)
    else:
        q = torch.zeros(B, Lq, D + pad, dtype=dtype)[..., :D]
        k, v = torch.zeros(B, Lk, 2 * D + pad, dtype=dtype)[
            ..., :2 * D].chunk(2, dim=-1)
    return tuple(t.reshape(B, t.shape[1], H, d) for t in (q, k, v))


@pytest.mark.parametrize("Lq,Lk,H,d,dtype,pad,fwd,bwd", [
    (77, 77, 8, 64, torch.bfloat16, 0, "tc", "fused"),    # TSF-B's tower
    (77, 77, 12, 64, torch.bfloat16, 0, "tc", "fused"),   # TSF-L's tower
    (1, 1, 8, 64, torch.bfloat16, 0, "tc", "fused"),
    (128, 128, 8, 64, torch.bfloat16, 0, "tc", "fused"),
    (129, 129, 8, 64, torch.bfloat16, 0, "tc", "split"),
    (130, 260, 3, 64, torch.bfloat16, 0, "tc", "split"),
    (64, 197, 2, 64, torch.bfloat16, 0, "tc", "split"),
    (77, 77, 8, 64, torch.bfloat16, 8, "tc", "fused"),    # whole chunks
    (77, 77, 8, 64, torch.bfloat16, 2, "simt", "simt"),   # off 16 bytes
    (77, 77, 8, 64, torch.float32, 0, "simt", "simt"),
    (77, 77, 8, 32, torch.bfloat16, 0, "simt", "simt"),
    (40, 40, 2, 128, torch.bfloat16, 0, "simt", "simt"),
])
def test_flash_branch(Lq, Lk, H, d, dtype, pad, fwd, bwd):
    """The kernels a call takes, the rule the C entry points enforce: the
    tensor cores for bf16 at head_dim 64 on rows TMA can copy (16-byte
    boundaries, row strides of whole 16-byte chunks), the backward fused
    up to 128 queries and keys and split past it; the SIMT kernels
    otherwise."""
    q, k, v = _in_proj_views(2, Lq, Lk, H, d, dtype, pad)
    assert KF.flash_branch(q, k, v) == fwd
    do = torch.zeros(q.shape, dtype=dtype)
    assert KF.flash_branch(q, k, v, do) == bwd


def test_flash_branch_backward_needs_aligned_do_and_out():
    """The fused backward also reads dO by TMA: a dO off a 16-byte
    boundary takes the SIMT kernels. O is no longer an input of the
    backward (delta comes from P·dP), so its alignment cannot matter."""
    q, k, v = _in_proj_views(2, 77, 77, 8, 64)
    off = torch.zeros(2 * 77 * 512 + 1, dtype=torch.bfloat16)[1:].reshape(
        2, 77, 8, 64)
    ok = torch.zeros(2, 77, 8, 64, dtype=torch.bfloat16)
    assert KF.flash_branch(q, k, v, ok) == "fused"
    assert KF.flash_branch(q, k, v, off) == "simt"


def test_flash_row_strides():
    """The row stride the kernels get: that of the token rows of a view
    whose heads are adjacent; a layout the kernels cannot walk raises."""
    q, k, v = _in_proj_views(2, 77, 77, 8, 64)
    assert KF._strides(q, k, v) == [3 * 512] * 3
    one = torch.zeros(3, 1, 8, 64)
    assert KF._row_stride(one, "q") == 512
    with pytest.raises(ValueError, match="heads of a token"):
        KF._row_stride(torch.zeros(2, 77, 64, 8).transpose(2, 3), "q")
    with pytest.raises(ValueError, match="evenly strided"):
        KF._row_stride(torch.zeros(77, 2, 8, 64).transpose(0, 1), "q")
