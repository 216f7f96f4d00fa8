"""Gated GPT-2: the narrator's text decoder, with a KV cache.

Counterpart of ``lavila_tpu/models/gpt2.py``, with the reference LaViLa
state-dict names (HF GPT-2 under ``transformer.``: ``wte``, ``wpe``,
``h.{i}.{ln_1, attn.c_attn, attn.c_proj, ln_2, mlp.c_fc, mlp.c_proj}``,
``ln_f``; the gated extension's ``crossattention.{q_attn, c_attn,
c_proj}``, ``ln_cross_attn``, ``ln_2_crossattention``,
``mlp_crossattention``, ``alpha_cattn``, ``alpha_dense``). HF's Conv1D
weights are ``(in, out)``; here every projection is an ``nn.Linear``
``(out, in)`` and the weight bridge transposes.

  * Pre-LN blocks, gelu_new MLP, learned ``wpe``, the LM head tied to
    ``wte``.
  * Layers with ``i % cross_attn_freq == 0`` PREPEND LN → cross-attention
    → ``tanh(alpha_cattn)`` gate and LN → squared-ReLU MLP →
    ``tanh(alpha_dense)`` gate (gates only with ``gated_xattn``).
  * The self-attention cache is flat ``(B, max_len, D)`` per layer (a
    list of ``(k, v)`` pairs from :func:`init_cache`), written in place.
    A one-token step attends over the cache *before* its update (the
    ``cache_index`` valid rows) plus the current token as a separate
    term, through :func:`kernels.decode.decode_attention`, its single
    dispatch site: K9 on a CUDA tensor, the plain version on a CPU
    tensor. Positions ``>= cache_index`` are never read, so writing the
    new row after the call is safe.
  * The cross-attention K/V of a decode is computed once per sequence
    (:meth:`GPT2LMHead.precompute_cross_kv`), heads-major ``(B, H, S,
    d)`` so each step's single-query product reads it without a copy.
    That product and the multi-token prefill over the cache (whose mask
    is offset by ``cache_index``) are plain PyTorch, as they are XLA
    code in the JAX package; the prefill's causal mask is the most
    negative fp32 value.
  * Without a cache (training, the teacher-forced forward) both
    attentions go through :func:`kernels.flash.flash_attention`, on the
    token-major row views of their packed projections: the
    self-attention with the absolute causal mask, the cross-attention
    over every image token. That is K8 (forward and backward) when
    autograd needs the gradient and K7 otherwise, on a CUDA tensor; the
    plain versions on a CPU tensor. The JAX package computes these in
    XLA (``lavila_tpu/models/gpt2.py:281-292``, :330-338): the port
    routes each kernel wherever it is legal.
  * Remat (``cfg.remat``, the JAX ``nn.remat`` per block when no cache
    is passed): each block runs under ``torch.utils.checkpoint``
    (non-reentrant), so the backward runs its forward again; the blocks
    draw no random numbers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lavila_tpu_torch.kernels.decode import decode_attention
from lavila_tpu_torch.kernels.flash import flash_attention
from lavila_tpu_torch.ops.attention import attention
from lavila_tpu_torch.ops.basic import (LayerNorm, gelu_new, init_linear_,
                                        squared_relu)

NEG_INF = torch.finfo(torch.float32).min
ACTIVATIONS = {"gelu_new": gelu_new, "squared_relu": squared_relu}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    activation: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    cross_attn_freq: int = 0  # 0: stock; k: cross-attention on i % k == 0
    gated_xattn: bool = True
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


PRESETS = {
    "gpt2": GPT2Config(),
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
}


def augment_config(cfg: GPT2Config, cross_attn_freq: int = 1,
                   gated_xattn: bool = True, remat: bool = False
                   ) -> GPT2Config:
    """The reference's ``augment_gpt2_config``."""
    return dataclasses.replace(cfg, cross_attn_freq=cross_attn_freq,
                               gated_xattn=gated_xattn, remat=remat)


def init_cache(cfg: GPT2Config, batch: int, max_len: int,
               dtype=torch.float32, device=None,
               width: int | None = None) -> list:
    """The self-attention cache: one ``(k, v)`` pair of zero ``(batch,
    max_len, width)`` tensors per layer; ``width`` is ``n_embd``, or the
    width of the heads a tensor-parallel rank holds
    (:meth:`GPT2LMHead.cache_width`)."""
    shape = (batch, max_len, cfg.n_embd if width is None else width)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layer)]


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, H, D // H)


class SelfAttention(nn.Module):
    """GPT-2 self-attention (packed ``c_attn``) with an optional cache."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        D = cfg.n_embd
        self.n_head = cfg.n_head
        self.head_dim = cfg.head_dim
        self.c_attn = nn.Linear(D, 3 * D)
        self.c_proj = nn.Linear(D, D)

    def forward(self, x, cache=None, cache_index: int | None = None):
        B, L, _ = x.shape
        D = self.c_proj.in_features  # the heads held here
        H = D // self.head_dim
        q, k, v = self.c_attn(x).chunk(3, dim=-1)  # row views, stride 3D
        if cache is None:
            out = flash_attention(_heads(q, H), _heads(k, H), _heads(v, H),
                                  causal=True)
            return self.c_proj(out.reshape(B, L, D))
        k_cache, v_cache = cache
        if L == 1:
            # the pre-update cache plus the current token, then the write
            out = decode_attention(q[:, 0], k_cache, v_cache, k[:, 0],
                                   v[:, 0], cache_index, H)[:, None]
            k_cache[:, cache_index] = k[:, 0]
            v_cache[:, cache_index] = v[:, 0]
            return self.c_proj(out)
        # multi-token prefill: write, then attend over the whole cache
        k_cache[:, cache_index:cache_index + L] = k
        v_cache[:, cache_index:cache_index + L] = v
        max_len = k_cache.shape[1]
        pos = cache_index + torch.arange(L, device=x.device)[:, None]
        keys = torch.arange(max_len, device=x.device)[None, :]
        mask = torch.where(keys <= pos, 0.0, NEG_INF)
        out = attention(_heads(q, H), _heads(k_cache.to(q.dtype), H),
                        _heads(v_cache.to(q.dtype), H), mask)
        return self.c_proj(out.reshape(B, L, D))


class CrossAttention(nn.Module):
    """Queries from the hidden states, packed K/V (``c_attn``) from the
    visual tokens, ``heads`` heads over the width ``D``."""

    def __init__(self, D: int, heads: int):
        super().__init__()
        self.n_head = heads
        self.head_dim = D // heads
        self.q_attn = nn.Linear(D, D)
        self.c_attn = nn.Linear(D, 2 * D)
        self.c_proj = nn.Linear(D, D)

    @property
    def local_heads(self) -> int:
        """The heads its layers hold (this rank's under tensor
        parallelism)."""
        return self.c_proj.in_features // self.head_dim

    def compute_kv(self, encoder_states):
        """K/V of ``(B, S, D)`` states, heads-major ``(B, H, S, d)``."""
        k, v = self.c_attn(encoder_states).chunk(2, dim=-1)
        return tuple(_heads(t, self.local_heads).transpose(1, 2).contiguous()
                     for t in (k, v))

    def forward(self, x, encoder_states=None, cross_kv=None):
        """With ``encoder_states``: flash attention over the token-major
        chunks of ``c_attn``'s output, each token's heads adjacent (K7/K8
        read them so). With a decode's ``cross_kv``: the plain product
        over the heads-major K/V."""
        B, L, _ = x.shape
        H = self.local_heads
        D = H * self.head_dim
        if cross_kv is None:
            k, v = self.c_attn(encoder_states).chunk(2, dim=-1)
            out = flash_attention(_heads(self.q_attn(x), H), _heads(k, H),
                                  _heads(v, H))
            return self.c_proj(out.reshape(B, L, D))
        k, v = cross_kv
        q = _heads(self.q_attn(x), H).transpose(1, 2)  # (B, H, L, d)
        scores = (q @ k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, L, D)
        return self.c_proj(out)


class GPT2Mlp(nn.Module):
    """``c_fc`` (D → 4D) → ``act`` → ``c_proj``, with biases."""

    def __init__(self, D: int, act: str):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.c_fc = nn.Linear(D, 4 * D)
        self.c_proj = nn.Linear(4 * D, D)

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class CrossBlock(nn.Module):
    """A decoder block that may hold LaViLa's gated cross-attention, under
    GPT-2's names, ahead of its own layers (GPT-2's blocks here, the
    Moonlight decoder's layers in ``models/moonlight.py``): LN →
    cross-attention over the visual tokens → × tanh(alpha_cattn), then
    LN → squared-ReLU MLP (4 × the width) → × tanh(alpha_dense)."""

    def init_cross(self, has_cross: bool, D: int, heads: int, eps: float,
                   gated: bool) -> None:
        self.has_cross, self.gated = has_cross, gated
        if has_cross:
            self.ln_cross_attn = LayerNorm(D, eps)
            self.crossattention = CrossAttention(D, heads)
            self.ln_2_crossattention = LayerNorm(D, eps)
            self.mlp_crossattention = GPT2Mlp(D, "squared_relu")
            if gated:
                self.alpha_cattn = nn.Parameter(torch.zeros(()))
                self.alpha_dense = nn.Parameter(torch.zeros(()))

    def cross(self, x, encoder_states=None, cross_kv=None):
        """The gated cross-attention and MLP on the residual stream ``x``,
        where the block has them and visual tokens (or their K/V) are
        given; ``x`` otherwise."""
        if not self.has_cross or (encoder_states is None
                                  and cross_kv is None):
            return x
        att = self.crossattention(self.ln_cross_attn(x), encoder_states,
                                  cross_kv)
        if self.gated:
            att = torch.tanh(self.alpha_cattn).to(x.dtype) * att
        x = x + att
        ff = self.mlp_crossattention(self.ln_2_crossattention(x))
        if self.gated:
            ff = torch.tanh(self.alpha_dense).to(x.dtype) * ff
        return x + ff


class GPT2Block(CrossBlock):
    def __init__(self, cfg: GPT2Config, layer_idx: int):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.init_cross(cfg.cross_attn_freq > 0
                        and layer_idx % cfg.cross_attn_freq == 0,
                        cfg.n_embd, cfg.n_head, eps, cfg.gated_xattn)
        self.ln_1 = LayerNorm(cfg.n_embd, eps)
        self.attn = SelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.n_embd, eps)
        self.mlp = GPT2Mlp(cfg.n_embd, cfg.activation)

    def forward(self, x, encoder_states=None, cross_kv=None, cache=None,
                cache_index=None):
        x = self.cross(x, encoder_states, cross_kv)
        x = x + self.attn(self.ln_1(x), cache, cache_index)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """Embeddings, blocks and the final norm (HF's ``transformer``)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(GPT2Block(cfg, i) for i in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon)


class GPT2LMHead(nn.Module):
    """GPT-2 with the tied LM head and optional gated visual
    cross-attention.

    Training / prefill: ``forward(ids, encoder_states)`` → logits.
    Decode: :meth:`precompute_cross_kv` once, then ``forward`` with
    ``cache``/``cache_index`` one token at a time."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.transformer = GPT2Model(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: wte N(0.02), wpe N(0.01),
        lecun-normal Dense kernels with zero biases, unit LN scales, zero
        gates."""
        t = self.transformer
        nn.init.normal_(t.wte.weight, 0.0, 0.02, generator=generator)
        nn.init.normal_(t.wpe.weight, 0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for blk in t.h:
            if blk.has_cross and blk.gated:
                blk.alpha_cattn.zero_()
                blk.alpha_dense.zero_()

    def forward(self, input_ids, encoder_states=None, cross_kv=None,
                cache=None, cache_index: int | None = None):
        """Returns the logits ``(B, L, V)``; ``cross_kv`` is the list of
        :meth:`precompute_cross_kv` (None for layers without
        cross-attention); ``cache`` is updated in place."""
        t = self.transformer
        B, L = input_ids.shape
        start = 0 if cache_index is None else cache_index
        positions = torch.arange(start, start + L, device=input_ids.device)
        x = t.wte(input_ids) + t.wpe(positions)[None]
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(t.h):
            args = (x, encoder_states,
                    cross_kv[i] if cross_kv is not None else None,
                    cache[i] if cache is not None else None, cache_index)
            if remat:
                x = checkpoint(blk, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(*args)
        x = t.ln_f(x)
        return x @ t.wte.weight.T.to(x.dtype)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> list:
        """The decode's self-attention cache (:func:`init_cache` at the
        width of the heads held here)."""
        return init_cache(self.cfg, batch, max_len, dtype=dtype,
                          device=device, width=self.cache_width())

    def cache_width(self) -> int:
        """The width of the self-attention heads the layers hold: the
        cache's (``n_embd``, or a tensor-parallel rank's share)."""
        return self.transformer.h[0].attn.c_proj.in_features

    def precompute_cross_kv(self, encoder_states) -> list:
        """Each cross-attention layer's K/V (None for the others),
        computed once per decode."""
        return [blk.crossattention.compute_kv(encoder_states)
                if blk.has_cross else None for blk in self.transformer.h]
