"""Moonlight-16B-A3B (DeepSeek-V3's architecture) as the narrator's text
decoder, with LaViLa's gated cross-attention, a latent KV cache and the
expert layers on grouped kernels.

The layer equations are DeepSeek-V3's (``model_type`` ``deepseek_v3``,
its modeling code) at Moonlight's published configuration
(moonshotai/Moonlight-16B-A3B ``config.json``): 27 layers 2048 wide,
vocabulary 163,840, the LM head not tied. Layer ``l``:
``h = x + MLA(RMSNorm(x))``, ``out = h + FFN_l(RMSNorm(h))``; then the
final RMSNorm and ``lm_head``. RMSNorm (eps ``rms_norm_eps`` 1e-5)
normalises in fp32 and scales the result cast back to the input dtype.

  * MLA without query compression (``q_lora_rank`` null): ``q = W_q x``,
    16 heads of 128 ``nope`` + 64 ``rope`` dims; ``[c; k_rope] = W_kva
    x`` (512 + 64), ``c = RMSNorm(c)`` (``kv_a_layernorm``, eps 1e-6, the
    modeling code's default); ``[k_nope; v] = W_kvb c`` (16 × (128 +
    128)). RoPE (θ 50,000, no scaling) on ``q_rope`` and on ``k_rope``,
    which all heads share, as DeepSeek-V3's code rotates: the 64 dims'
    interleaved pairs permuted to halves, then rotate-half with the
    angles repeated over both halves (computed as each pair times
    ``e^{i·angle}``; q and k stay in the permuted order, which leaves
    their products unchanged). Scores
    ``(q_nope·k_nope + q_rope·k_rope) / sqrt(192)``, causal softmax in
    fp32, ``W_o`` over 16 × 128.
  * The cache is one ``(B, L, 512 + 64)`` tensor a layer: the normed
    latent ``c`` and the rotated ``k_rope`` of each position
    (:meth:`MoonlightLM.init_cache`). A cached step writes its rows,
    then attends over the valid ones with the key half of ``W_kvb``
    absorbed into the query (``q_nope W_uk``, 512 wide, beside q's rope
    part: one product with the cache's rows gives both score terms) and
    the value half into the output (``(p · c) W_uv``): plain bmm/einsum
    over the cache read in place, no decompressed K or V. Without a cache
    (the teacher-forced forward) k and v are decompressed.
  * FFN: layer 0 (``first_k_dense_replace`` 1) a dense SwiGLU of 11,264,
    ``down(silu(gate x) ⊙ up x)``; layers 1-26 the expert layer:
    ``s = sigmoid(W_router x)`` in fp32 over 64 experts, the top 6 of
    ``s + e_score_correction_bias`` (``n_group`` = ``topk_group`` = 1),
    weights ``s`` of the chosen over their sum × 2.446, ``y = Σ w_i
    E_i(x) + S(x)`` with SwiGLU experts of 1,408 and the shared SwiGLU of
    2 × 1,408 (:mod:`kernels.moe`: :func:`route` and :func:`experts`,
    the kernels on a CUDA tensor, the plain versions on a CPU one).
  * LaViLa's gated cross-attention (:class:`gpt2.CrossBlock`, GPT-2's
    code and names) before the layers with ``i % cross_attn_freq == 0``:
    16 heads of 128 over the pooled visual tokens, LayerNorms of eps
    1e-5, a squared-ReLU MLP of 4 × 2048, tanh gates.

Departures from the published model, none of them in the arithmetic:

  * the routed experts' weights are stacked, ``experts.gate_up (64,
    2·1408, 2048)`` (each expert's gate rows, then its up rows) and
    ``experts.down (64, 2048, 1408)``, where the checkpoint holds
    ``experts.{j}.{gate,up,down}_proj``; the shared SwiGLU of 2,816 is
    held as the two experts it is the sum of (its intermediate's two
    halves), ``shared_experts.gate_up (2, 2·1408, 2048)`` and
    ``shared_experts.down (2, 2048, 1408)``;
  * ``e_score_correction_bias`` is a parameter in the model's dtype;
  * the cross-attention blocks, the pooler and their place are
    LaViLa's, not Moonlight's (the zoo entry says which layers);
  * no multi-token-prediction layer (``num_nextn_predict_layers`` 0) and
    no auxiliary loss: this decoder serves.

On the card the cached one-token step runs as CUDA graphs, one a cache
index (:class:`StepGraphs`): the step's launches cost the host one
``replay``, so that the card and not Python paces the decode loop. The
graphs read and write the decoder's own buffers, which
:meth:`MoonlightLM.init_cache` and :meth:`MoonlightLM.precompute_cross_kv`
hand out there; a step on other buffers, or with ``cuda_graphs`` off,
runs eagerly.

The expert kernels have no backward: training the expert layers on the
card raises (``kernels/moe.py``), and the beam decoders, which reorder a
GPT-2 cache, do not take this decoder (``models/beam.py`` says so).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from lavila_tpu_torch.kernels.moe import experts, route
from lavila_tpu_torch.models.gpt2 import CrossBlock
from lavila_tpu_torch.ops.basic import LayerNorm, init_linear_
from lavila_tpu_torch.utils import tracing

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6
    rope_theta: float = 50000.0
    # LaViLa's gated cross-attention
    cross_attn_freq: int = 3
    cross_heads: int = 16
    cross_eps: float = 1e-5
    gated_xattn: bool = True


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = torch.nn.functional.rms_norm(x.float(), x.shape[-1:],
                                         eps=self.eps)
        return self.weight * h.to(x.dtype)


def rope_tables(positions, dim: int, theta: float):
    """``e^{i·angle}`` of the positions, ``(L, dim / 2)`` complex64: the
    angle of pair j at position t is ``t · theta^(-2j / dim)``."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=positions.device) / dim)
    ang = positions.float()[:, None] * inv[None]
    return torch.polar(torch.ones_like(ang), ang)


def apply_rope(x, rot):
    """DeepSeek-V3's rotation of the last dim of ``x`` (positions on the
    axis that ``rot`` broadcasts over): its interleaved pairs permuted to
    halves, then rotate-half, which is each pair ``(a, b)`` times
    ``e^{i·angle}`` with the real parts laid out first and the imaginary
    parts after; in fp32, rounded to x's dtype."""
    d = x.shape[-1]
    pairs = torch.view_as_complex(x.float().unflatten(-1, (d // 2, 2)))
    turned = pairs * rot
    return torch.cat([turned.real, turned.imag], -1).to(x.dtype)


class MLAttention(nn.Module):
    """Multi-head latent attention; see the module docstring."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.H, self.C = H, cfg.kv_lora_rank
        self.dn, self.dr, self.dv = (cfg.qk_nope_head_dim,
                                     cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.q_proj = nn.Linear(D, H * (self.dn + self.dr), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(D, self.C + self.dr, bias=False)
        self.kv_a_layernorm = RMSNorm(self.C, cfg.kv_norm_eps)
        self.kv_b_proj = nn.Linear(self.C, H * (self.dn + self.dv),
                                   bias=False)
        self.o_proj = nn.Linear(H * self.dv, D, bias=False)

    def forward(self, x, rope, cache=None, cache_index: int | None = None):
        B, L, _ = x.shape
        H, C, dn, dr, dv = self.H, self.C, self.dn, self.dr, self.dv
        q = self.q_proj(x).view(B, L, H, dn + dr)
        q_rope = apply_rope(q[..., dn:], rope[:, None])
        c, k_rope = self.kv_a_proj_with_mqa(x).split([C, dr], -1)
        c = self.kv_a_layernorm(c)
        k_rope = apply_rope(k_rope, rope)
        if cache is None:
            kv = self.kv_b_proj(c).view(B, L, H, dn + dv)
            # (B, H, L, nope + rope) against the decompressed keys
            q = torch.cat([q[..., :dn], q_rope], -1).transpose(1, 2)
            k = torch.cat([kv[..., :dn], k_rope[:, :, None].expand(
                B, L, H, dr)], -1).transpose(1, 2)
            scores = q @ k.transpose(-1, -2)
            start, values = 0, kv[..., dn:].transpose(1, 2)
        else:
            cache[:, cache_index:cache_index + L, :C] = c
            cache[:, cache_index:cache_index + L, C:] = k_rope
            start = cache_index
            lat = cache[:, :cache_index + L]          # (B, n, C + rope)
            w = self.kv_b_proj.weight.view(H, dn + dv, C)
            # the query in the latent's coordinates beside its rope part,
            # heads and positions as rows: one product over the cache's
            # rows (read in place) gives both score terms
            q_lat = torch.einsum("blhd,hdc->bhlc", q[..., :dn], w[:, :dn])
            q = torch.cat([q_lat, q_rope.transpose(1, 2)], -1)
            scores = (q.view(B, H * L, C + dr) @ lat.transpose(1, 2)).view(
                B, H, L, -1)
            values = lat[..., :C]
        scores = scores.float() * (dn + dr) ** -0.5   # (B, H, L, n)
        if L > 1:
            keys = torch.arange(scores.shape[-1], device=x.device)
            rows = start + torch.arange(L, device=x.device)
            scores = scores.masked_fill(keys[None] > rows[:, None], NEG_INF)
        p = torch.softmax(scores, dim=-1).to(x.dtype)
        if cache is None:
            out = (p @ values).transpose(1, 2)
        else:  # the latent output, through W_kvb's value half
            o_lat = (p.view(B, H * L, -1) @ values).view(B, H, L, C)
            out = torch.einsum("bhlc,hdc->blhd", o_lat, w[:, dn:])
        return self.o_proj(out.reshape(B, L, H * dv))


class DenseMlp(nn.Module):
    """The dense SwiGLU of the leading layers."""

    def __init__(self, D: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Linear(D, inner, bias=False)
        self.up_proj = nn.Linear(D, inner, bias=False)
        self.down_proj = nn.Linear(inner, D, bias=False)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class Router(nn.Module):
    """An expert layer's routing: ``(T, D)`` rows → their weights and
    experts, each ``(T, top_k)`` (:func:`kernels.moe.route`). A forward
    hook on it sees the experts every row chose."""

    def __init__(self, D: int, experts_: int, top_k: int, scale: float):
        super().__init__()
        self.top_k, self.scale = top_k, scale
        self.weight = nn.Parameter(torch.empty(experts_, D))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(experts_))

    def forward(self, t):
        return route(t, self.weight, self.e_score_correction_bias,
                     self.top_k, self.scale)


class Experts(nn.Module):
    """SwiGLU experts of one shape, stacked: ``gate_up (n, 2I, D)`` (gate
    rows first), ``down (n, D, I)``."""

    def __init__(self, n: int, D: int, inner: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n, 2 * inner, D))
        self.down = nn.Parameter(torch.empty(n, D, inner))


class MoE(nn.Module):
    """The expert layer; see the module docstring."""

    def __init__(self, cfg: MoonlightConfig, layer_idx: int):
        super().__init__()
        D, I = cfg.hidden_size, cfg.moe_intermediate_size
        self.layer_idx = layer_idx
        self.gate = Router(D, cfg.n_routed_experts, cfg.num_experts_per_tok,
                           cfg.routed_scaling_factor)
        self.experts = Experts(cfg.n_routed_experts, D, I)
        self.shared_experts = Experts(cfg.n_shared_experts, D, I)

    def forward(self, x):
        t = x.reshape(-1, x.shape[-1])
        weights, idx = self.gate(t)
        if tracing.enabled():
            flat = idx.reshape(-1).long()
            rows = torch.zeros(self.gate.weight.shape[0], dtype=torch.long,
                               device=t.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            tracing.count(f"moe.rows.{self.layer_idx}", rows)
            tracing.count(f"moe.used.{self.layer_idx}", (rows > 0).sum())
        y = experts(t, weights, idx, self.experts.gate_up, self.experts.down,
                    self.shared_experts.gate_up, self.shared_experts.down)
        return y.view(x.shape)


class MoonlightLayer(CrossBlock):
    def __init__(self, cfg: MoonlightConfig, layer_idx: int):
        super().__init__()
        D = cfg.hidden_size
        self.init_cross(cfg.cross_attn_freq > 0
                        and layer_idx % cfg.cross_attn_freq == 0, D,
                        cfg.cross_heads, cfg.cross_eps, cfg.gated_xattn)
        self.self_attn = MLAttention(cfg)
        self.input_layernorm = RMSNorm(D, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(D, cfg.rms_norm_eps)
        self.mlp = (DenseMlp(D, cfg.intermediate_size)
                    if layer_idx < cfg.first_k_dense_replace
                    else MoE(cfg, layer_idx))

    def forward(self, x, rope, encoder_states=None, cross_kv=None,
                cache=None, cache_index=None):
        x = self.cross(x, encoder_states, cross_kv)
        x = x + self.self_attn(self.input_layernorm(x), rope, cache,
                               cache_index)
        return x + self.mlp(self.post_attention_layernorm(x))


class MoonlightModel(nn.Module):
    """Embeddings, layers and the final norm (the checkpoint's ``model``)."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MoonlightLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MoonlightLM(nn.Module):
    """The decoder with its LM head, the narrator's ``text_decoder``: the
    interface of :class:`gpt2.GPT2LMHead` (``forward``,
    :meth:`init_cache`, :meth:`precompute_cross_kv`), so that
    ``VCLM.generate`` runs either."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.cfg = cfg
        self.model = MoonlightModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        # the cached step on the card as CUDA graphs (:class:`StepGraphs`)
        self.cuda_graphs = True
        self._steps: StepGraphs | None = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Embeddings and the experts N(0, fan_in^-1/2), lecun-normal
        linear layers (zero biases), unit norms, zero router bias and
        gates."""
        D = self.cfg.hidden_size
        nn.init.normal_(self.model.embed_tokens.weight, 0.0, D ** -0.5,
                        generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, (RMSNorm, LayerNorm)):
                m.weight.fill_(1.0)
                if isinstance(m, LayerNorm):
                    m.bias.zero_()
            elif isinstance(m, Router):
                nn.init.normal_(m.weight, 0.0, D ** -0.5,
                                generator=generator)
                m.e_score_correction_bias.zero_()
            elif isinstance(m, Experts):
                nn.init.normal_(m.gate_up, 0.0, D ** -0.5,
                                generator=generator)
                nn.init.normal_(m.down, 0.0, m.down.shape[2] ** -0.5,
                                generator=generator)
        for layer in self.model.layers:
            if layer.has_cross and layer.gated:
                layer.alpha_cattn.zero_()
                layer.alpha_dense.zero_()

    def forward(self, input_ids, encoder_states=None, cross_kv=None,
                cache=None, cache_index: int | None = None):
        """Logits ``(B, L, V)``; with a ``cache`` (from :meth:`init_cache`)
        the ids sit at positions ``cache_index`` on and the cache is
        written in place; ``cross_kv`` is :meth:`precompute_cross_kv`'s."""
        steps = self._steps
        if (steps is not None and cache is not None and cache is steps.cache
                and cross_kv is steps.cross_kv and encoder_states is None
                and input_ids.shape == steps.ids.shape):
            return steps.step(self, input_ids, cache_index)
        return self._forward(input_ids, encoder_states, cross_kv, cache,
                             cache_index)

    def _forward(self, input_ids, encoder_states, cross_kv, cache,
                 cache_index):
        m = self.model
        B, L = input_ids.shape
        start = 0 if cache_index is None else cache_index
        positions = torch.arange(start, start + L, device=input_ids.device)
        rope = rope_tables(positions, self.cfg.qk_rope_head_dim,
                           self.cfg.rope_theta)
        x = m.embed_tokens(input_ids)
        for i, layer in enumerate(m.layers):
            x = layer(x, rope, encoder_states,
                      cross_kv[i] if cross_kv is not None else None,
                      cache[i] if cache is not None else None, cache_index)
        return self.lm_head(m.norm(x))

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> list:
        """One zero ``(batch, max_len, kv_lora_rank + qk_rope_head_dim)``
        latent cache a layer; on the card with ``cuda_graphs``, the step
        graphs' own cache, zeroed."""
        width = self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim
        shape = (batch, max_len, width)
        if self._graphed(device):
            if self._steps is None:
                self._steps = StepGraphs()
            device = torch.device(device)
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            return self._steps.static_cache(self, shape, dtype, device)
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(self.cfg.num_hidden_layers)]

    def precompute_cross_kv(self, encoder_states) -> list:
        """Each cross-attention layer's K/V (None for the others),
        computed once per decode; on the card with ``cuda_graphs``, copied
        into the step graphs' own buffers."""
        kv = [layer.crossattention.compute_kv(encoder_states)
              if layer.has_cross else None for layer in self.model.layers]
        if self._graphed(encoder_states.device):
            if self._steps is None:
                self._steps = StepGraphs()
            return self._steps.static_cross_kv(kv)
        return kv

    def _graphed(self, device) -> bool:
        return (self.cuda_graphs and device is not None
                and torch.device(device).type == "cuda")


def _layout(kv: list) -> list:
    """The shapes, dtypes and devices of a cross K/V list."""
    return [None if p is None else [(t.shape, t.dtype, t.device) for t in p]
            for p in kv]


class StepGraphs:
    """A :class:`MoonlightLM`'s cached one-token step on the card as CUDA
    graphs, one a cache index (and tracing's state, whose counters the
    step adds to while it records).

    The graphs read and write fixed buffers: the latent cache
    (:meth:`static_cache`, zeroed for each decode), the cross K/V
    (:meth:`static_cross_kv`, the fresh K/V copied in), the step's ids and
    its logits. An index's first step runs eagerly on a side stream (its
    logits are the result; lazy initialisation happens there, outside any
    capture), then is captured; later steps at that index copy the ids
    in, replay and return a copy of the logits. The graphs share one
    memory pool: each step's temporaries die inside it, and the graphs
    run one at a time. New buffer shapes drop the graphs.

    What runs in Python inside the step (forward hooks on its modules, the
    module globals it calls) is captured as it was at the index's first
    step, and replays without running again."""

    def __init__(self):
        self.cache = self.cross_kv = self.ids = self.out = None
        self.graphs: dict = {}
        self.pool = self.stream = None

    def _drop(self) -> None:
        self.graphs.clear()
        self.pool = None

    def static_cache(self, lm: MoonlightLM, shape, dtype, device) -> list:
        c = self.cache
        if (c is not None and c[0].shape == shape and c[0].dtype == dtype
                and c[0].device == device):
            for t in c:
                t.zero_()
            return c
        self._drop()
        self.cache = [torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(lm.cfg.num_hidden_layers)]
        self.ids = torch.zeros((shape[0], 1), dtype=torch.long,
                               device=device)
        self.out = torch.empty((shape[0], 1, lm.cfg.vocab_size),
                               dtype=lm.lm_head.weight.dtype,
                               device=device)
        return self.cache

    def static_cross_kv(self, kv: list) -> list:
        held = self.cross_kv
        if held is not None and _layout(held) == _layout(kv):
            for a, b in zip(held, kv):
                if a is not None:
                    for x, y in zip(a, b):
                        x.copy_(y)
            return held
        self._drop()
        self.cross_kv = [None if p is None else tuple(t.clone() for t in p)
                         for p in kv]
        return self.cross_kv

    def step(self, lm: MoonlightLM, input_ids, cache_index: int):
        key = (cache_index, tracing.enabled())
        graph = self.graphs.get(key)
        if graph is None:
            return self._first(lm, input_ids, cache_index, key)
        self.ids.copy_(input_ids)
        graph.replay()
        return self.out.clone()

    def _first(self, lm: MoonlightLM, input_ids, i: int, key):
        main = torch.cuda.current_stream()
        if self.stream is None:
            self.stream = torch.cuda.Stream(main.device)
        side = self.stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.ids.copy_(input_ids)
            self.out.copy_(lm._forward(self.ids, None, self.cross_kv,
                                       self.cache, i))
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            self.out.copy_(lm._forward(self.ids, None, self.cross_kv,
                                       self.cache, i))
        if self.pool is None:
            self.pool = graph.pool()
        self.graphs[key] = graph
        return self.out.clone()
