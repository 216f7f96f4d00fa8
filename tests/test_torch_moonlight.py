"""The Moonlight-16B-A3B narrator (``models/moonlight.py``) and its expert
layer (``kernels/moe.py``) against the benchmark's plain reference
(``benchmark/reference/moonlight.py``, plain float32 torch that imports
nothing of the port), at the MINI sizes in fp32 on the CPU; the
published zoo entry on the meta device; the expert kernels on the card.

The card's tests are marked ``cuda`` and skip without a CUDA device; on a
machine with an H100 (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_moonlight.py -q
"""

import pytest
import torch

from benchmark.portbench import weights as W
from benchmark.reference import moonlight as M
from benchmark.reference.numerics import Numerics
from lavila_tpu_torch.kernels import moe
from lavila_tpu_torch.models import build_model, moonlight, zoo

MINI = "VCLM_OPENAI_TIMESFORMER_MINI_MOONLIGHT_MINI"
FULL = "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_MOONLIGHT_16B_A3B"
# the MINI narrator's sizes, as the reference reads them
CFG = {"vocab_size": 1024, "hidden_size": 256, "intermediate_size": 512,
       "moe_intermediate_size": 128, "num_hidden_layers": 3,
       "num_attention_heads": 4, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
       "qk_rope_head_dim": 16, "v_head_dim": 32, "n_routed_experts": 8,
       "n_shared_experts": 2, "num_experts_per_tok": 3,
       "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
       "rms_norm_eps": 1e-05, "kv_norm_eps": 1e-06, "rope_theta": 50000,
       "tower": {"img_size": 64, "patch_size": 16, "embed_dim": 64,
                 "depth": 2, "num_heads": 4, "num_frames": 2,
                 "ln_pre": True},
       "pooler": {"num_queries": 16, "heads": 4, "dim_head": 16},
       "cross": {"freq": 2, "heads": 4, "eps": 1e-05}}
SCALARS = {"alpha_cattn": 0.5, "alpha_dense": 0.5}
FP32 = Numerics("fp32")


def _mini(seed=0, device="cpu", dtype=torch.float32):
    """The MINI narrator holding weights drawn from ``seed`` (the
    benchmark's rule: every weight random, the router bias and gates
    included), and those weights as the reference's dict."""
    model = build_model(MINI, device=device, dtype=dtype, gated_xattn=True,
                        num_frames=CFG["tower"]["num_frames"])
    p = W.draw(M.narrator_spec(CFG), seed, device, dtype, SCALARS)
    W.load(model, p)
    return model, {k: v.clone() for k, v in p.items()}


def _inputs(seed=0, B=3, L=9):
    g = torch.Generator().manual_seed(seed)
    frames = torch.randn(B, 2, 64, 64, 3, generator=g)
    ids = torch.randint(0, 1024, (B, L), generator=g)
    return frames, ids


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_logits_match_the_reference(seed):
    """``VCLM.forward`` against the reference's teacher-forced logits in
    fp32. 2e-4: the same products summed in another order over 3 layers
    and the tower (the logits' spread is ~1)."""
    model, p = _mini(seed)
    frames, ids = _inputs(seed)
    with torch.no_grad():
        got = model(frames, torch.cat([ids, ids[:, :1]], 1))["logits"]
    ref, gap = M.narrator_logits(p, frames, ids, CFG, FP32)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    assert gap < 0  # the program's experts are the reference's top set


def test_cached_decode_matches_the_full_forward():
    """Step by step through the latent cache (absorbed ``W_kvb``) against
    the full forward (decompressed k and v), fp32: 1e-4, the absorbed
    products regrouped."""
    model, _ = _mini(2)
    frames, ids = _inputs(2, B=2, L=8)
    with torch.no_grad():
        full = model(frames, torch.cat([ids, ids[:, :1]], 1))["logits"]
        tokens = model.encode_image(frames)
        kv = model.prepare_decode(tokens)
        cache = model.text_decoder.init_cache(2, 8)
        assert len(cache) == 3 and cache[0].shape == (2, 8, 64 + 16)
        steps = [model.decode_step(ids[:, i:i + 1], kv, cache, i)
                 for i in range(8)]
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_generate_runs_through_the_latent_cache():
    model, _ = _mini(3)
    frames, _ = _inputs(3, B=2)
    with torch.no_grad():
        ids, ppl = model.generate(
            model.encode_image(frames),
            generator=torch.Generator().manual_seed(0), bos_id=1000,
            eos_id=1001, max_text_length=6, temperature=0.7, top_p=0.95,
            num_return_sequences=3)
    assert ids.shape == (6, 6) and (ids[:, 0] == 1000).all()
    assert torch.isfinite(ppl).all()


def test_beam_search_names_what_is_missing():
    from lavila_tpu_torch.models.beam import BeamDecoder
    model, _ = _mini(4)
    frames, _ = _inputs(4, B=1)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="MoonlightLM"):
        BeamDecoder(model, 1000, 1001, max_text_length=4).beam_search(
            model.encode_image(frames), num_beams=2)


def _layer(E=8, S=2, D=256, I=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(E, D, generator=g) * D ** -0.5,
            torch.randn(E, generator=g) * 0.02,
            torch.randn(E, 2 * I, D, generator=g) * D ** -0.5,
            torch.randn(E, D, I, generator=g) * I ** -0.5,
            torch.randn(S, 2 * I, D, generator=g) * D ** -0.5,
            torch.randn(S, D, I, generator=g) * I ** -0.5)


def _ref_layer(x, router, bias, w1, w2, w1s, w2s, k, chosen=None):
    """The reference's expert layer over the same weights."""
    p = {"gate.weight": router, "gate.e_score_correction_bias": bias,
         "experts.gate_up": w1, "experts.down": w2,
         "shared_experts.gate_up": w1s, "shared_experts.down": w2s}
    cfg = dict(CFG, num_experts_per_tok=k, n_routed_experts=w1.shape[0],
               moe_intermediate_size=w2.shape[2])
    return M.expert_layer(p, "", x, cfg, FP32, chosen)


def test_expert_layer_plain_path_matches_the_loop():
    """``route`` then ``experts`` on the CPU against the reference's loop
    over the experts, with near-ties the bias decides: token 0's 4th
    expert by score is lifted 1e-4 above its 3rd by the bias (and takes
    its place), token 1's 4th to 1e-4 below its 3rd (and does not).
    fp32: 1e-5."""
    router, _, w1, w2, w1s, w2s = _layer()
    x = torch.randn(12, 256, generator=torch.Generator().manual_seed(1))
    s = torch.sigmoid(x @ router.T)
    order = torch.argsort(s, dim=-1, descending=True)
    bias = torch.zeros(8)
    a0, b0 = order[0, 2], order[0, 3]
    bias[b0] = s[0, a0] - s[0, b0] + 1e-4
    a1, b1 = order[1, 2], order[1, 3]
    if b1 != b0 and a1 != b0:
        bias[b1] = s[1, a1] + bias[a1] - s[1, b1] - 1e-4
    weights, idx = moe.route(x, router, bias, 3, 2.446)
    assert b0.item() in idx[0].tolist() and a0.item() not in idx[0].tolist()
    top = torch.topk(s + bias, 3, dim=-1).indices
    assert torch.equal(torch.sort(idx.long(), -1).values,
                       torch.sort(top, -1).values)
    got = moe.experts(x, weights, idx, w1, w2, w1s, w2s)
    ref, gap = _ref_layer(x, router, bias, w1, w2, w1s, w2s, 3)
    assert gap <= 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # routed as the program routed, the reference agrees to the bit of
    # its own choice
    forced, forced_gap = _ref_layer(x, router, bias, w1, w2, w1s, w2s, 3,
                                    idx)
    torch.testing.assert_close(forced, ref)
    assert forced_gap == gap


def test_expert_layer_weights_and_shared_experts():
    """The routed weights are the chosen scores over their sum × scale;
    with every routed weight zeroed the layer is the shared experts
    alone, which are the SwiGLU of 2 × I the checkpoint holds."""
    router, bias, w1, w2, w1s, w2s = _layer(seed=2)
    x = torch.randn(5, 256)
    weights, idx = moe.route(x, router, bias, 3, 2.446)
    s = torch.sigmoid(x @ router.T).gather(-1, idx.long())
    torch.testing.assert_close(weights, s / s.sum(-1, keepdim=True) * 2.446)
    only_shared = moe.experts(x, torch.zeros_like(weights), idx, w1, w2,
                              w1s, w2s)
    I = w2.shape[2]
    gate = torch.cat([w[:I] for w in w1s])
    up = torch.cat([w[I:] for w in w1s])
    down = torch.cat(list(w2s), dim=1)
    want = (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T
    torch.testing.assert_close(only_shared, want, rtol=1e-5, atol=1e-5)


def test_sort_groups_rows_by_expert():
    idx = torch.tensor([[2, 0], [0, 1], [2, 1]], dtype=torch.int32)
    src, pos, offsets = moe.sort_reference(idx, 3, 2)
    assert offsets.tolist() == [0, 2, 4, 6, 9, 12]
    assert src.tolist() == [0, 1, 1, 2, 0, 2, 0, 1, 2, 0, 1, 2]
    # each routed slot's sorted place holds its token
    for t in range(3):
        for j in range(2):
            assert src[pos[t, j]] == t
            assert offsets[idx[t, j]] <= pos[t, j] < offsets[idx[t, j] + 1]


def test_tracing_counts_routed_rows():
    from lavila_tpu_torch.utils import tracing
    model, _ = _mini(5)
    frames, ids = _inputs(5, B=2, L=4)
    was = tracing.enabled()
    tracing.reset()
    tracing.enable()
    try:
        with torch.no_grad():
            model(frames, ids)
        counts = tracing.counters()
    finally:
        if not was:
            tracing.disable()
        tracing.reset()
    assert sorted(counts) == ["moe.rows.1", "moe.rows.2", "moe.used.1",
                              "moe.used.2"]
    for layer in (1, 2):
        rows, used = counts[f"moe.rows.{layer}"], counts[f"moe.used.{layer}"]
        assert rows.shape == (8,) and int(rows.sum()) == 2 * 3 * 3
        # one call a layer: the experts that got a row in it
        assert int(used) == int((rows > 0).sum())


def test_published_entry_on_the_meta_device():
    """27 layers 2048 wide, 64 experts each from layer 1 on, MLA at
    Moonlight's widths: the language model counts 15.96 B parameters."""
    with torch.device("meta"):
        model = zoo._REGISTRY[FULL](gated_xattn=True)
    dec = model.text_decoder
    cfg = dec.cfg
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.n_routed_experts,
            cfg.num_experts_per_tok) == (27, 2048, 64, 6)
    layers = dec.model.layers
    assert isinstance(layers[0].mlp, moonlight.DenseMlp)
    assert all(layer.mlp.experts.gate_up.shape == (64, 2816, 2048)
               for layer in layers[1:])
    assert [i for i, layer in enumerate(layers) if layer.has_cross] == \
        list(range(0, 27, 3))
    lm = sum(p.numel() for n, p in dec.named_parameters()
             if "cross" not in n and "alpha" not in n)
    assert round(lm / 1e9, 2) == 15.96
    with torch.device("meta"):
        model = zoo._REGISTRY[FULL](param_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16
               for p in model.text_decoder.parameters())


def test_param_dtype_makes_the_decoder_in_place():
    """The published entry's ``param_dtype`` (``zoo._moonlight_lm``) makes
    the decoder's parameters in that dtype from the start and leaves the
    default dtype alone; ``init_weights`` then draws every one of them
    (none left as the meta build's empty memory): each large tensor's
    spread within 10 % of a float32 decoder's (bf16 draws its own
    numbers), each small one (norms, biases, gates) equal."""
    mini = build_model(MINI, device="cpu", num_frames=2).text_decoder
    lm = zoo._moonlight_lm(mini.cfg, torch.bfloat16)
    lm.init_weights(torch.Generator().manual_seed(0))
    assert torch.get_default_dtype() == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())
    for (n, p), (m, q) in zip(lm.named_parameters(),
                              mini.named_parameters()):
        assert n == m and p.shape == q.shape
        if p.numel() >= 1024:
            assert float(p.float().std()) == pytest.approx(
                float(q.float().std()), rel=0.1), n
        else:
            assert torch.equal(p.float(), q.float()), n


# ---- on the card

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,k,E,S,D,I", [
    (16, 3, 8, 2, 256, 128),        # the MINI narrator's layer
    (160, 6, 64, 2, 2048, 1408),    # Moonlight's decode step
    (7, 2, 64, 0, 256, 64),         # no shared experts, ragged rows
])
def test_expert_kernels_match_the_plain_path(cuda, T, k, E, S, D, I):
    """bf16: the routing's choice exact and its weights to 1e-5 (fp32
    sums in another order); the layer within 2e-2 of the plain path's
    norm (each expert row and h rounded to bf16 on both sides, their
    fp32 sums in another order), bit-identical twice."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=cuda, generator=g)
                * scale).bfloat16()

    x = rnd(T, D)
    router, bias = rnd(E, D, scale=D ** -0.5), rnd(E, scale=0.02)
    w1, w2 = rnd(E, 2 * I, D, scale=D ** -0.5), rnd(E, D, I, scale=I ** -0.5)
    w1s, w2s = rnd(S, 2 * I, D, scale=D ** -0.5), rnd(S, D, I,
                                                       scale=I ** -0.5)
    weights, idx = moe.route(x, router, bias, k, 2.446)
    rw, ridx = moe.route_reference(x, router, bias, k, 2.446)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(weights, rw, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        out = moe.experts(x, weights, idx, w1, w2, w1s, w2s)
        again = moe.experts(x, weights, idx, w1, w2, w1s, w2s)
        ref = moe.experts_reference(x, weights, idx, w1, w2, w1s, w2s)
    assert torch.equal(out, again)
    err = (out.float() - ref.float()).norm() / ref.float().norm()
    assert err < 2e-2


@pytest.mark.cuda
def test_decode_step_makes_no_host_sync(cuda):
    """A decode step of the MINI narrator (whose widths the kernels take)
    in bf16 with no host sync anywhere: the expert layer's offsets stay
    on the device."""
    model, _ = _mini(6, device="cuda", dtype=torch.bfloat16)
    model.text_decoder.cuda_graphs = False  # the eager step; graphs below
    frames, ids = _inputs(6, B=2)
    with torch.no_grad():
        tokens = model.encode_image(frames.to(cuda, torch.bfloat16))
        kv = model.prepare_decode(tokens)
        cache = model.text_decoder.init_cache(2, 4, dtype=torch.bfloat16,
                                              device=cuda)
        ids = ids.to(cuda)  # the copy to the card syncs: before the check
        model.decode_step(ids[:, :1], kv, cache, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(ids[:, 1:2], kv, cache, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_step_graphs_replay_the_eager_step(cuda):
    """Two decodes of 4 steps through the step graphs (the first runs
    each index eagerly and captures it, the second replays) against the
    eager steps on a cache of their own, in bf16; the replays make no
    host sync. 1e-2 of the logits' largest: the same kernels in the same
    order, where cuBLAS may pick another algorithm under capture."""
    model, _ = _mini(7, device="cuda", dtype=torch.bfloat16)
    lm = model.text_decoder
    frames, ids = _inputs(7, B=2)
    ids = ids.to(cuda)
    with torch.no_grad():
        tokens = model.encode_image(frames.to(cuda, torch.bfloat16))
        lm.cuda_graphs = False
        kv = model.prepare_decode(tokens)
        cache = lm.init_cache(2, 4, dtype=torch.bfloat16, device=cuda)
        eager = [model.decode_step(ids[:, i:i + 1], kv, cache, i)
                 for i in range(4)]
        lm.cuda_graphs = True
        runs = []
        for _ in range(2):
            kv = model.prepare_decode(tokens)
            cache = lm.init_cache(2, 4, dtype=torch.bfloat16, device=cuda)
            assert cache is lm._steps.cache and kv is lm._steps.cross_kv
            torch.cuda.synchronize()
            if runs:
                torch.cuda.set_sync_debug_mode("error")
            try:
                runs.append([model.decode_step(ids[:, i:i + 1], kv, cache, i)
                             for i in range(4)])
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert len(lm._steps.graphs) == 4
    for run in runs:
        for got, want in zip(run, eager):
            err = (got.float() - want.float()).abs().max()
            assert err <= 1e-2 * want.float().abs().max()


def test_step_graphs_keep_their_buffers():
    """The step graphs' cache is zeroed and handed out again for the same
    shape, the cross K/V copied into the held buffers; a new shape makes
    new buffers and drops the graphs."""
    model, _ = _mini(8)
    steps = moonlight.StepGraphs()
    lm = model.text_decoder
    cache = steps.static_cache(lm, (2, 4, 80), torch.float32,
                               torch.device("cpu"))
    cache[0].fill_(1.0)
    steps.graphs[(0, False)] = "a graph"
    assert steps.static_cache(lm, (2, 4, 80), torch.float32,
                              torch.device("cpu")) is cache
    assert not cache[0].any() and steps.graphs
    assert steps.ids.shape == (2, 1) and steps.out.shape == (2, 1, 1024)
    kv = [None, (torch.ones(2, 3), torch.zeros(2, 3))]
    held = steps.static_cross_kv(kv)
    assert held[0] is None and held[1][0] is not kv[1][0]
    steps.graphs[(0, False)] = "a graph"
    again = steps.static_cross_kv([None, (torch.full((2, 3), 2.0),
                                          torch.ones(2, 3))])
    assert again is held and float(held[1][0][0, 0]) == 2.0
    assert steps.graphs
    steps.static_cross_kv([None, (torch.ones(3, 3), torch.ones(3, 3))])
    assert not steps.graphs
    steps.graphs[(0, False)] = "a graph"
    steps.static_cache(lm, (3, 4, 80), torch.float32, torch.device("cpu"))
    assert not steps.graphs and steps.ids.shape == (3, 1)


def test_cpu_decode_keeps_the_callers_buffers():
    """Off the card the decoder hands out fresh buffers and steps
    eagerly: no step graphs."""
    model, _ = _mini(9)
    frames, ids = _inputs(9, B=2, L=3)
    with torch.no_grad():
        kv = model.prepare_decode(model.encode_image(frames))
        cache = model.text_decoder.init_cache(2, 3)
        model.decode_step(ids[:, :1], kv, cache, 0)
    assert model.text_decoder._steps is None
    assert cache[0][:, 0].any() and not cache[0][:, 1:].any()
