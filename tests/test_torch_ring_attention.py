"""The port's ring attention on the CPU: gloo ranks in processes of their
own (``tests/torch_tp_worker.py``), each holding a shard of the
sequence, against the JAX package's dense attention
(``tests/test_ring_attention.py``'s five cases) on the same seeded
inputs, fp32:

  * non-causal and causal ring attention over 8 ranks (8 tokens a rank)
    against full attention, atol 2e-5, rtol 1e-4;
  * the gradient of sum(out²) with respect to q over 4 ranks, atol 5e-4,
    rtol 1e-3;
  * ``divided_time_ring`` (F = 8 frames over 4 ranks) against JAX's
    ``divided_attention(axis="time")``, CLS semantics included, atol
    2e-5, rtol 1e-4, and its gradients with respect to every input
    against JAX's, atol 5e-4, rtol 1e-3;
  * the ring group wired into a SpaceTimeTransformer forward (8 frames
    over 4 ranks; its time attention given seeded weights) against the
    JAX model, atol 5e-5, rtol 1e-4.

Each set of ranks runs once per module, under a timeout that fails the
tests rather than the suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models.timesformer import SpaceTimeTransformer as JaxTSF
from lavila_tpu.ops.attention import attention, causal_mask
from lavila_tpu.ops.attention import divided_attention
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.ops import ring_attention as R
from torch_tp_worker import run_ranks

torch.set_num_threads(1)

TSF = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4,
           num_frames=8, ln_pre=True, act="quick_gelu")
B_T, F, N, H_T, D_T = 2, 8, 5, 3, 16   # the time phase: F over 4 ranks


def full_ref(q, k, v, causal):
    qt, kt, vt = (jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v))
    mask = causal_mask(q.shape[2]) if causal else None
    return attention(qt, kt, vt, mask=mask).transpose(0, 2, 1, 3)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _ring_inputs():
    rng = np.random.default_rng(0)
    out = {x: _normal(rng, (2, 3, 64, 16)) for x in ("q", "k", "v")}
    rng = np.random.default_rng(1)
    out.update({x: _normal(rng, (1, 2, 32, 8)) for x in ("gq", "gk", "gv")})
    return out


def _time_inputs():
    """CLS-separate q/k/v of the time phase and the weights of the
    scalar whose gradients are compared."""
    rng = np.random.default_rng(2)
    L = 1 + F * N
    q, k, v = (_normal(rng, (B_T, L, H_T, D_T)) for _ in range(3))
    out = {"q": q, "k": k, "v": v,
           "wc": _normal(rng, (B_T, 1, H_T, D_T)),
           "wp": _normal(rng, (B_T, F, N, H_T, D_T))}
    for name, t in (("q", q), ("k", k), ("v", v)):
        out["c" + name] = np.ascontiguousarray(t[:, :1])
        out[name + "p"] = np.ascontiguousarray(
            t[:, 1:].reshape(B_T, F, N, H_T, D_T))
    return out


def _jax_tsf():
    """The JAX tower on key(0), its zero-init time attention given seeded
    weights (else the time phase would be a uniform average)."""
    jm = JaxTSF(**TSF)
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 8, 32, 32, 3))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0),
                                              jnp.asarray(x))["params"])
    for name, blk in params.items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for key, val in lin.items():
                    lin[key] = _normal(rng, val.shape) * 0.3
    return jm, params, x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ring")
    _, params, x = _jax_tsf()
    sd = {k.removeprefix("visual."): v for k, v in
          state_dict_from_jax({"vision_model": params}).items()}
    inputs = {**_ring_inputs(), "time": _time_inputs(),
              "tsf": {"kw": TSF, "state_dict": sd, "x": x}}
    eight = run_ranks(base / "ranks8", 8, ["ring:full", "ring:causal"],
                      inputs)
    four = run_ranks(base / "ranks4", 4,
                     ["ring_grad:q", "time_ring:all", "spacetime:tsf"],
                     inputs)
    return {"eight": eight, "four": four}


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(runs, causal):
    """8 ranks, 8 tokens each: their output shards in rank order are the
    full attention's output."""
    inp = _ring_inputs()
    want = np.asarray(full_ref(inp["q"], inp["k"], inp["v"], causal))
    case = "ring:causal" if causal else "ring:full"
    got = np.concatenate([out[case]["out"] for out in runs["eight"]], 2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_ring_attention_grads_flow(runs):
    """The gradient crosses the ring backwards: each rank's dq shard of
    sum(out²), in rank order, is the full attention's dq."""
    inp = _ring_inputs()
    q, k, v = (jnp.asarray(inp[x]) for x in ("gq", "gk", "gv"))
    want = jax.grad(lambda q: jnp.sum(full_ref(q, k, v, False) ** 2))(q)
    got = np.concatenate([out["ring_grad:q"]["grad"]
                          for out in runs["four"]], 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-3)


def _jax_time(inp):
    return lambda q, k, v: divided_attention(q, k, v, num_frames=F,
                                             axis="time")


def test_divided_time_ring_matches_dense(runs):
    """Frames over 4 ranks: every rank returns the whole time phase,
    equal to JAX's dense one (CLS row over every token, each patch over
    its position's frames and the CLS key)."""
    inp = _time_inputs()
    want = np.asarray(_jax_time(inp)(*(jnp.asarray(inp[x])
                                       for x in "qkv")))
    for out in runs["four"]:
        got = out["time_ring:all"]
        whole = np.concatenate(
            [got["cls"], got["patches"].reshape(B_T, F * N, H_T, D_T)], 1)
        np.testing.assert_allclose(whole, want, atol=2e-5, rtol=1e-4)


def test_divided_time_ring_gradients_match_dense(runs):
    """The gradients of a weighted sum of the output with respect to
    q, k and v (CLS rows and patches), whole and alike on every rank,
    against JAX's through the dense phase."""
    inp = _time_inputs()
    weights = np.concatenate(
        [inp["wc"], inp["wp"].reshape(B_T, F * N, H_T, D_T)], 1)

    def scalar(q, k, v):
        return jnp.sum(_jax_time(inp)(q, k, v) * weights)
    want = jax.grad(scalar, argnums=(0, 1, 2))(
        *(jnp.asarray(inp[x]) for x in "qkv"))
    for out in runs["four"]:
        cq, ck, cv, qp, kp, vp = out["time_ring:all"]["grads"]
        for cls, pat, w in ((cq, qp, want[0]), (ck, kp, want[1]),
                            (cv, vp, want[2])):
            whole = np.concatenate(
                [cls, pat.reshape(B_T, F * N, H_T, D_T)], 1)
            np.testing.assert_allclose(whole, np.asarray(w), atol=5e-4,
                                       rtol=1e-3)
    for a, b in zip(runs["four"][0]["time_ring:all"]["grads"],
                    runs["four"][3]["time_ring:all"]["grads"]):
        np.testing.assert_array_equal(a, b)


def test_ring_group_wires_into_spacetime_transformer(runs):
    """With the ring group set every time phase of a SpaceTimeTransformer
    forward takes the ring: the CLS feature equals the JAX model's."""
    jm, params, x = _jax_tsf()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    for out in runs["four"]:
        np.testing.assert_allclose(out["spacetime:tsf"]["out"], want,
                                   atol=5e-5, rtol=1e-4)


def test_ring_group_is_off_by_default():
    assert R.get_ring_group() is None
    R.set_ring_group("sentinel")
    try:
        assert R.get_ring_group() == "sentinel"
    finally:
        R.set_ring_group(None)
    assert R.get_ring_group() is None
