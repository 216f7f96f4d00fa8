"""The port's narrator against ``lavila_tpu`` on the same weights and numpy
inputs, on the CPU: K9's plain version, the gated GPT-2 (full forward,
cached decode), the pooler, VCLM, the warpers, ``generate`` and the
weight bridge. fp32 unless stated; tolerances per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models import sampling as JS
from lavila_tpu.models.coca import AttentionPooler as JaxPooler
from lavila_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from lavila_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from lavila_tpu.models.gpt2 import _segmented_decode_attention
from lavila_tpu.models.gpt2 import augment_config as jax_augment
from lavila_tpu.models.gpt2 import init_cache as jax_init_cache
from lavila_tpu.ops.pallas.decode_attention import decode_attention_fused
from lavila_tpu_torch.kernels import decode as KDec
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models import sampling as S
from lavila_tpu_torch.models.coca import AttentionPooler
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                          augment_config, init_cache)

torch.set_num_threads(1)

MINI = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ------------------------------------------------------------------ K9

@pytest.mark.parametrize("num_valid", [0, 1, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_reference_matches_jax(num_valid, dtype):
    """The plain version of K9 against the Pallas kernel (interpret mode)
    and the segmented XLA form, on the same values. fp32 2e-5 (summation
    order); bf16 2e-2 (the JAX forms round the new-token term and the
    output to bf16 separately)."""
    rng = np.random.default_rng(7)
    B, K, H, d = 16, 12, 4, 16
    D = H * d
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, D), (B, K, D), (B, K, D), (B, D), (B, D))]
    jd = jnp.dtype(dtype)
    q, kc, vc, kn, vn = (jnp.asarray(a, jd) for a in arrs)
    seg = _segmented_decode_attention(q[:, None], kc, vc, kn[:, None],
                                      vn[:, None], num_valid, H, d)
    fused = decode_attention_fused(q[:, None], kc, vc, kn[:, None],
                                   vn[:, None], num_valid, H, d,
                                   block_b=8, interpret=True)
    td = getattr(torch, dtype)
    got = KDec.decode_attention(*(torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(td) for a in (q, kc, vc, kn, vn)),
        num_valid, H)
    assert got.dtype == td and got.shape == (B, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (seg, fused):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want[:, 0], np.float32),
                                   atol=tol, rtol=tol)


def test_decode_attention_empty_cache_returns_v_new():
    rng = np.random.default_rng(1)
    B, K, D = 3, 5, 128
    q, kn, vn = (torch.from_numpy(rng.normal(size=(B, D)).astype(
        np.float32)).bfloat16() for _ in range(3))
    kc, vc = (torch.from_numpy(rng.normal(size=(B, K, D)).astype(
        np.float32)).bfloat16() for _ in range(2))
    out = KDec.decode_attention(q, kc, vc, kn, vn, 0, 2)
    assert torch.equal(out, vn)


def test_decode_attention_reads_only_valid_rows():
    """Garbage (even non-finite) cache rows at or past ``num_valid`` do
    not reach the output."""
    rng = np.random.default_rng(2)
    B, K, D, nv = 2, 8, 64, 3
    q, kn, vn = (torch.from_numpy(rng.normal(size=(B, D)).astype(
        np.float32)) for _ in range(3))
    kc, vc = (torch.from_numpy(rng.normal(size=(B, K, D)).astype(
        np.float32)) for _ in range(2))
    want = KDec.decode_attention(q, kc, vc, kn, vn, nv, 4)
    kc[:, nv:], vc[:, nv:] = float("nan"), float("inf")
    torch.testing.assert_close(KDec.decode_attention(q, kc, vc, kn, vn, nv,
                                                     4), want)


@pytest.mark.parametrize("bad", ["num_valid", "shape", "dtype"])
def test_decode_attention_rejects_bad_inputs(bad):
    B, K, D = 2, 4, 64
    q, kn, vn = torch.zeros(B, D), torch.zeros(B, D), torch.zeros(B, D)
    kc, vc = torch.zeros(B, K, D), torch.zeros(B, K, D)
    nv = 2
    if bad == "num_valid":
        nv = K + 1
    elif bad == "shape":
        kc = torch.zeros(B, K, D + 1)
    else:
        q = q.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        KDec.decode_attention(q, kc, vc, kn, vn, nv, 4)


# ------------------------------------------------------- activations

@pytest.mark.parametrize("name", ["gelu_new", "squared_relu"])
def test_activations_match_jax(name):
    from lavila_tpu.ops import basic as JB
    from lavila_tpu_torch.ops import basic as PB
    x = np.random.default_rng(0).normal(size=(4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(getattr(PB, name)(_t(x)).numpy(),
                               np.asarray(getattr(JB, name)(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_bias_free_layer_norm_matches_jax():
    """CoCa's LayerNorm without a bias, through the single LN site."""
    from lavila_tpu.ops.basic import LayerNorm as JaxLN
    from lavila_tpu_torch.ops.basic import BiasFreeLayerNorm
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 2 + 1
    g = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    want = JaxLN(use_bias=False).apply({"params": {"scale": g}},
                                       jnp.asarray(x))
    ln = BiasFreeLayerNorm(48)
    ln.load_state_dict({"gamma": _t(g)}, strict=True)
    with torch.no_grad():
        got = ln(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------- GPT-2

def _gpt2_pair(cross_attn_freq, gates=(0.0, 0.0), seed=0):
    """A JAX tiny GPT-2 and the port's, on the JAX init (gates set)."""
    jcfg = JaxGPT2Config(**TINY)
    pcfg = GPT2Config(**TINY)
    if cross_attn_freq:
        jcfg = jax_augment(jcfg, cross_attn_freq, gated_xattn=True)
        pcfg = augment_config(pcfg, cross_attn_freq, gated_xattn=True)
    jm = JaxGPT2(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    enc = jnp.zeros((1, 5, 32))
    params = _np(jm.init(jax.random.key(seed), ids,
                         enc if cross_attn_freq else None)["params"])
    for name, blk in params.items():
        if "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(gates[0])
            blk["alpha_dense"] = np.float32(gates[1])
    pm = GPT2LMHead(pcfg)
    sd = {k.removeprefix("text_decoder."): v for k, v in state_dict_from_jax(
        {"text_decoder": params}).items()}
    pm.load_state_dict(sd, strict=True)
    return jm, params, pm.eval()


def _ids_enc(B=2, L=6, S_=5, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, size=(B, L)).astype(np.int32),
            rng.normal(size=(B, S_, 32)).astype(np.float32))


@pytest.mark.parametrize("cross", [0, 2, 1])
def test_gpt2_logits_match_jax(cross):
    """Teacher-forced logits, stock and with gated cross-attention
    (gates non-zero, so the cross branch counts). atol 1e-4."""
    jm, params, pm = _gpt2_pair(cross, gates=(0.7, -0.4))
    ids, enc = _ids_enc()
    je = jnp.asarray(enc) if cross else None
    want, _ = jm.apply({"params": params}, jnp.asarray(ids), je)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), _t(enc) if cross else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_gpt2_zero_gates_equal_stock():
    """tanh(0) = 0 gates: the augmented decoder equals stock GPT-2."""
    _, _, pm = _gpt2_pair(2)
    ids, enc = _ids_enc()
    with torch.no_grad():
        a = pm(torch.from_numpy(ids).long(), _t(enc))
        b = pm(torch.from_numpy(ids).long())
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_kv_cache_decode_matches_full_forward():
    """One token at a time through the cache (K9's plain version) equals
    the full forward, in the port and against JAX's cached decode.
    atol 2e-4 as the JAX test."""
    jm, params, pm = _gpt2_pair(2, gates=(0.5, 0.3))
    ids, enc = _ids_enc(B=2, L=6)
    tid = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = pm(tid, _t(enc))
        cross_kv = pm.precompute_cross_kv(_t(enc))
        cache = init_cache(pm.cfg, 2, 8)
        steps = [pm(tid[:, i:i + 1], cross_kv=cross_kv, cache=cache,
                    cache_index=i)[:, 0] for i in range(6)]
    cached = torch.stack(steps, 1)
    torch.testing.assert_close(cached, full, atol=2e-4, rtol=1e-4)
    v = {"params": params}
    jkv = jm.apply(v, jnp.asarray(enc), method="precompute_cross_kv")
    jcache = jax_init_cache(jm.cfg, 2, 8)
    jsteps = []
    for i in range(6):
        lg, jcache = jm.apply(v, jnp.asarray(ids[:, i:i + 1]), cross_kv=jkv,
                              cache=jcache, cache_index=i)
        jsteps.append(np.asarray(lg[:, 0]))
    np.testing.assert_allclose(cached.numpy(), np.stack(jsteps, 1),
                               atol=2e-4, rtol=1e-4)


def test_prefill_then_decode_matches_full_forward():
    """A multi-token prefill into the cache, then one-token steps."""
    _, _, pm = _gpt2_pair(1, gates=(0.5, 0.3))
    ids, enc = _ids_enc(B=2, L=6)
    tid = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = pm(tid, _t(enc))
        kv = pm.precompute_cross_kv(_t(enc))
        cache = init_cache(pm.cfg, 2, 8)
        pre = pm(tid[:, :4], cross_kv=kv, cache=cache, cache_index=0)
        rest = [pm(tid[:, i:i + 1], cross_kv=kv, cache=cache,
                   cache_index=i)[:, 0] for i in (4, 5)]
    torch.testing.assert_close(torch.cat([pre, torch.stack(rest, 1)], 1),
                               full, atol=2e-4, rtol=1e-4)


# ------------------------------------------------------------ pooler

def test_attention_pooler_matches_jax():
    rng = np.random.default_rng(4)
    B, Nq, S_, dim, cdim, H, d = 2, 6, 11, 32, 24, 4, 8
    qs = rng.normal(size=(B, Nq, dim)).astype(np.float32)
    ctx = rng.normal(size=(B, S_, cdim)).astype(np.float32)
    jm = JaxPooler(dim=dim, context_dim=cdim, dim_head=d, heads=H,
                   norm_context=True)
    params = _np(jm.init(jax.random.key(1), jnp.asarray(qs),
                         jnp.asarray(ctx))["params"])
    params["norm"]["scale"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(qs), jnp.asarray(ctx))
    pm = AttentionPooler(dim, cdim, dim_head=d, heads=H, norm_context=True)
    sd = {k.removeprefix("img_attn_pool."): v for k, v in
          state_dict_from_jax({"img_attn_pool": params}).items()}
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(_t(qs), _t(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# -------------------------------------------------------------- VCLM

def _gated(params, seed=5):
    """Seeded non-zero gates and time attention: with their zero init the
    cross-attention and the temporal phase would not count."""
    rng = np.random.default_rng(seed)
    for name, blk in params["text_decoder"].items():
        if "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return params


@pytest.fixture(scope="module")
def mini():
    """The JAX MINI narrator (gated, as the CLIs build it) on key(0) with
    gates and time attention set, and the port's on the same weights."""
    jm = jax_build_model(MINI, num_frames=4, gated_xattn=True)
    params = _gated(_np(jm.init(jax.random.key(0),
                                jnp.zeros((1, 4, 64, 64, 3)),
                                jnp.zeros((1, 8), jnp.int32))["params"]))
    pm = build_model(MINI, device="cpu", gated_xattn=True)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    frames = np.random.default_rng(6).normal(
        size=(2, 4, 64, 64, 3)).astype(np.float32)
    return jm, params, pm, frames


def test_vclm_encode_image_and_teacher_forced_logits(mini):
    jm, params, pm, frames = mini
    v = {"params": params}
    text = np.random.default_rng(8).integers(1, 50257, (2, 7)).astype(
        np.int32)
    want_tok = jm.apply(v, jnp.asarray(frames), method="encode_image")
    want = jm.apply(v, jnp.asarray(frames), jnp.asarray(text))
    with torch.no_grad():
        tok = pm.encode_image(_t(frames))
        got = pm(_t(frames), torch.from_numpy(text).long())
    assert tok.shape == (2, 16, 64)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["labels"].numpy(), text[:, 1:])


@pytest.mark.parametrize("name", ["VCLM_OPENAI_TIMESFORMER_BASE_GPT2",
                                  "VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL"])
def test_zoo_narrators_have_the_jax_parameters(name):
    """The full-size zoo entries hold exactly the JAX package's
    parameters, shape for shape (the JAX tree abstractly, the port's on
    the meta device: nothing is allocated)."""
    from lavila_tpu_torch.models import zoo
    from lavila_tpu_torch.models.convert import torch_key
    jm = jax_build_model(name, num_frames=4, gated_xattn=True)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 224, 224, 3)),
        jnp.zeros((1, 8), jnp.int32)))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, layout = torch_key(tuple(k.key for k in path))
        shape = leaf.shape
        if layout == "dense":
            shape = shape[::-1]
        elif layout == "conv":  # (kh, kw, I, O) → (O, I, kh, kw)
            shape = (shape[3], shape[2], *shape[:2])
        want[key] = shape
    with torch.device("meta"):
        pm = zoo._REGISTRY[name](gated_xattn=True)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == {k: tuple(v) for k, v in want.items()}
    n = sum(v.numel() for v in pm.parameters())
    assert n == sum(int(np.prod(v)) for v in want.values())


def _generate_pair(mini, eos, L, target=None, frames=None):
    jm, params, pm, clips = mini
    frames = clips if frames is None else frames
    v = {"params": params}
    toks = jm.apply(v, jnp.asarray(frames), method="encode_image")
    kw = dict(bos_id=50256, eos_id=eos, pad_id=0, max_text_length=L,
              top_k=1, num_return_sequences=2)
    jids, jppl = jm.apply(v, toks, rng=jax.random.key(3), method="generate",
                          target=None if target is None else
                          jnp.asarray(target), **kw)
    with torch.no_grad():
        pids, pppl = pm.generate(
            pm.encode_image(_t(frames)), generator=torch.Generator(),
            target=None if target is None else torch.from_numpy(target),
            **kw)
    return np.asarray(jids), np.asarray(jppl), pids.numpy(), pppl.numpy()


def test_generate_top_k_1_matches_jax(mini):
    """top_k = 1 makes sampling argmax in both frameworks: the same ids,
    the entropy perplexity within 1e-4 relative."""
    jids, jppl, pids, pppl = _generate_pair(mini, eos=-1, L=12)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(pppl, jppl, rtol=1e-4)


def test_generate_early_exit_matches_jax(mini):
    """With an EOS that two clips reach at different steps, both
    frameworks stop at the batch-max EOS, agree on every id and
    perplexity, and pad after the exit. The pair is found from the
    port's greedy chains over 8 seeded clips."""
    _, _, pm, _ = mini
    clips = np.random.default_rng(11).normal(
        size=(8, 4, 64, 64, 3)).astype(np.float32)
    L = 16
    with torch.no_grad():
        chains, _ = pm.generate(pm.encode_image(_t(clips)),
                                generator=torch.Generator(), bos_id=50256,
                                eos_id=-1, max_text_length=L, top_k=1)
    first = {}  # token -> {clip: first step}
    for c, row in enumerate(chains.numpy()):
        for step in range(1, L):
            first.setdefault(int(row[step]), {}).setdefault(c, step)
    tok, (a, sa), (b, sb) = max(
        ((t, *sorted(at.items(), key=lambda x: x[1])[:: len(at) - 1])
         for t, at in first.items() if len(set(at.values())) > 1),
        key=lambda x: x[2][1] - x[1][1])
    assert sa < sb < L - 1
    jids, jppl, pids, pppl = _generate_pair(mini, eos=tok, L=L,
                                            frames=clips[[a, b]])
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(pppl, jppl, rtol=1e-4)
    # rows (a, a, b, b): a stops at sa, the batch at b's EOS, step sb
    assert (pids[:, sb + 1:] == 0).all() and (pids[2:, sb] == tok).all()
    assert (pids[:2, sa] == tok).all()
    np.testing.assert_array_equal(pids[:, :sb + 1],
                                  chains.numpy()[[a, a, b, b], :sb + 1])


def test_generate_teacher_ppl_matches_jax(mini):
    target = np.array([[50256, 11, 12, 13, 50256, 0, 0, 0]] * 4, np.int64)
    jids, jppl, pids, pppl = _generate_pair(mini, eos=50256, L=8,
                                            target=target)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(pppl, jppl, rtol=1e-4)


def test_generate_sampling_statistics(mini):
    """top_k > 1: torch's random stream is not jax's, so the draws are
    checked by their statistics. With temperature 1 and top-k 3, every
    first token is among the 3 most likely and their frequencies over
    4,000 draws match the renormalised probabilities (within 5σ)."""
    _, _, pm, frames = mini
    with torch.no_grad():
        tok = pm.encode_image(_t(frames[:1]))
        kv = pm.prepare_decode(tok)
        cache = init_cache(pm.text_decoder.cfg, 1, 4)
        logits = pm.decode_step(torch.tensor([[50256]]), kv, cache, 0)
        top = torch.topk(logits[0], 3)
        p = torch.softmax(top.values, 0).numpy()
        n = 4000
        ids, _ = pm.generate(tok, generator=torch.Generator().manual_seed(1),
                             bos_id=50256, eos_id=-1, max_text_length=2,
                             top_k=3, num_return_sequences=n)
    first = ids[:, 1].numpy()
    assert np.isin(first, top.indices.numpy()).all()
    freq = np.array([(first == t).mean() for t in top.indices.numpy()])
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9).all()


# ----------------------------------------------------------- warpers

def test_warpers_match_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(8, 1000)) * 4).astype(np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for p in (0.5, 0.9, 0.95, 0.999):
        for keep in (1, 2):  # bisection, then the sort path
            want = np.asarray(JS.apply_top_p(jl, p, keep)) > JS.NEG_INF / 2
            got = S.apply_top_p(tl, p, keep).numpy() > S.NEG_INF / 2
            np.testing.assert_array_equal(got, want, err_msg=f"{p} {keep}")
    for k in (1, 5, 50):
        np.testing.assert_array_equal(S.apply_top_k(tl, k).numpy(),
                                      np.asarray(JS.apply_top_k(jl, k)))
    np.testing.assert_allclose(
        S.warp_logits(tl, 0.7, 40, 0.95).numpy(),
        np.asarray(JS.warp_logits(jl, 0.7, 40, 0.95)), rtol=1e-6)
    np.testing.assert_allclose(S.entropy(tl).numpy(),
                               np.asarray(JS.entropy(jl)), rtol=1e-5)


def test_top_p_bisection_long_tail_matches_jax():
    """The long-tailed case of the JAX package's bisection caveat: the
    same kept set as JAX's, near-ties deep in the tail included."""
    rng = np.random.default_rng(9)
    logits = np.concatenate([
        rng.normal(size=(4, 16)) * 0.5,
        np.linspace(-5, -20, 984)[None].repeat(4, 0)
        + rng.normal(size=(4, 984)) * 1e-7], axis=1).astype(np.float32)
    for p in (0.9, 0.999):
        want = np.asarray(JS.apply_top_p(jnp.asarray(logits), p))
        got = S.apply_top_p(torch.from_numpy(logits), p).numpy()
        np.testing.assert_array_equal(got > S.NEG_INF / 2,
                                      want > JS.NEG_INF / 2)
