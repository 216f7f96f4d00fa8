"""VCLM narrator: video tower → attention-pooled image queries → a text
decoder with LaViLa's gated cross-attention (GPT-2, ``models/gpt2.py``,
or Moonlight-16B-A3B, ``models/moonlight.py``), with cached sampled
decoding.

Counterpart of ``lavila_tpu/models/narrator.py:VCLM``, with the
reference state-dict names (``visual.*``, ``img_queries``,
``img_attn_pool.*``, ``img_attn_pool_norm.gamma``,
``text_decoder.transformer.*``).

  * :meth:`VCLM.encode_image` runs the video tower with
    ``cls_at_last=False`` (1 + T·N tokens), pools them onto
    ``num_img_queries`` learned queries and applies the bias-free norm.
  * ``forward(frames, text)`` is the teacher-forced pass: logits of
    ``text[:, :-1]`` against the labels ``text[:, 1:]``.
  * :meth:`VCLM.generate` samples captions with the decoder's own cache
    (``text_decoder.init_cache``: GPT-2's (k, v) pairs, whose
    self-attention step is K9, or Moonlight's latents), one token per
    step: the image tokens
    repeated ``num_return_sequences`` times, the cross K/V computed once,
    temperature → top-k → top-p, a perplexity per row (NLL against
    ``target``, else the entropy of the unwarped logits, masked after
    EOS). The step loop is Python, with one host sync per step to stop
    once every row has sampled EOS (full length when ``target`` is
    given); positions after the exit hold ``pad_id``. Under tensor
    parallelism every rank of the model group takes model rank 0's
    token at each step, so their caches never part. With
    ``teacher_forcing`` (and a ``target``) each step is fed the target's
    token instead of the sample: ``eval_narrator``'s teacher-forced
    perplexity. The beam decoders are ``models/beam.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from lavila_tpu_torch.models import sampling as S
from lavila_tpu_torch.models.coca import AttentionPooler
from lavila_tpu_torch.ops.basic import BiasFreeLayerNorm, init_linear_
from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.utils import tracing


class VCLM(nn.Module):
    def __init__(self, vision_model: nn.Module, text_decoder: nn.Module,
                 vision_width: int, text_width: int,
                 num_img_queries: int = 256, dim_head: int = 64,
                 heads: int = 8):
        super().__init__()
        self.visual = vision_model
        self.img_queries = nn.Parameter(torch.zeros(num_img_queries,
                                                    text_width))
        self.img_attn_pool = AttentionPooler(
            text_width, vision_width, dim_head=dim_head, heads=heads,
            norm_context=True)
        self.img_attn_pool_norm = BiasFreeLayerNorm(text_width)
        self.text_decoder = text_decoder

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``."""
        self.visual.init_weights(generator)
        width = self.img_queries.shape[1]
        nn.init.normal_(self.img_queries, 0.0, width ** -0.5,
                        generator=generator)
        pool = self.img_attn_pool
        for lin in (pool.to_q, pool.to_kv, pool.to_out):
            init_linear_(lin, generator)
        for norm in (pool.norm, pool.context_norm, self.img_attn_pool_norm):
            norm.gamma.fill_(1.0)
        self.text_decoder.init_weights(generator)

    def encode_image(self, frames: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W, C)`` → ``(B, num_img_queries, text_width)``."""
        with tracing.span("encode.image"):
            tokens = self.visual(frames, cls_at_last=False)
            q = self.img_queries.to(tokens.dtype).repeat(tokens.shape[0], 1,
                                                          1)
            return self.img_attn_pool_norm(self.img_attn_pool(q, tokens))

    def forward(self, frames: torch.Tensor, text: torch.Tensor) -> dict:
        """Teacher-forced caption logits: ``text`` shifted by one."""
        inp, labels = text[:, :-1], text[:, 1:]
        logits = self.text_decoder(inp, encoder_states=self.encode_image(
            frames))
        return {"logits": logits, "labels": labels}

    def prepare_decode(self, image_tokens: torch.Tensor) -> list:
        """Cross-attention K/V, computed once per sequence."""
        return self.text_decoder.precompute_cross_kv(image_tokens)

    def decode_step(self, tokens: torch.Tensor, cross_kv: list, cache: list,
                    cache_index: int) -> torch.Tensor:
        """One cached decoder step: tokens ``(B, 1)`` → logits ``(B, V)``;
        ``cache`` is updated in place."""
        return self.text_decoder(tokens, cross_kv=cross_kv, cache=cache,
                                 cache_index=cache_index)[:, -1]

    @torch.no_grad()
    def generate(self, image_tokens: torch.Tensor, *,
                 generator: torch.Generator | None, bos_id: int,
                 eos_id: int, pad_id: int = 0, max_text_length: int = 77,
                 temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None, num_return_sequences: int = 1,
                 target: torch.Tensor | None = None,
                 teacher_forcing: bool = False) -> tuple:
        """Multinomial sampling with perplexity tracking. Returns
        ``(ids (B·nrs, max_text_length) int64, ppl (B·nrs,) fp32)``; see
        the module docstring. ``generator`` draws the samples (on the
        tensors' device)."""
        with tracing.span("narrate.generate"):
            with tracing.span("narrate.prepare"):
                image_tokens = image_tokens.repeat_interleave(
                    num_return_sequences, dim=0)
                B, device = image_tokens.shape[0], image_tokens.device
                L = max_text_length
                cross_kv = self.prepare_decode(image_tokens)
                cache = self.text_decoder.init_cache(
                    B, L, dtype=image_tokens.dtype, device=device)
                out = torch.full((B, L), pad_id, dtype=torch.long,
                                 device=device)
                out[:, 0] = bos_id
                cur = out[:, 0].clone()
                nlls = torch.zeros(B, device=device)
                counts = torch.zeros(B, device=device)
                reached = torch.zeros(B, dtype=torch.bool, device=device)
            early_exit = target is None
            for i in range(L - 1):
                with tracing.span("narrate.step"):
                    if early_exit and i > 0:
                        with tracing.span("narrate.sync"):
                            done = bool(reached.all())  # the one host sync
                        if done:
                            break
                    with tracing.span("narrate.forward"):
                        logits = self.decode_step(cur[:, None], cross_kv,
                                                  cache, i).float()
                    if target is not None:
                        tgt = target[:, i + 1].long()
                        logz = torch.logsumexp(logits, dim=-1)
                        picked = logits.gather(-1, tgt[:, None])[:, 0]
                        valid = (tgt != pad_id).float()
                        nlls += (logz - picked) * valid
                        counts += valid
                    else:
                        live = (~reached).float()
                        nlls += S.entropy(logits) * live
                        counts += live
                    with tracing.span("narrate.sample"):
                        nxt = S.sample_token(generator, S.warp_logits(
                            logits, temperature, top_k, top_p))
                        # the ranks of a model group all take model rank
                        # 0's draw
                        mesh.broadcast_from_first(nxt, mesh.model_group())
                    reached |= nxt == eos_id
                    out[:, i + 1] = nxt
                    cur = (target[:, i + 1].long()
                           if teacher_forcing and target is not None
                           else nxt)
            ppl = torch.exp(nlls / counts.clamp_min(1.0))
            return out, ppl
