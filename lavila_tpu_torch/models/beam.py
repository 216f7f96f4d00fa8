"""Beam decoding for the narrator: beam search, stochastic beam sample
and diverse group beam search.

Counterpart of ``lavila_tpu/models/beam.py:BeamDecoder``, whose parity
targets are the reference's ``beam_sample`` (stochastic candidate draws
and HF's BeamSearchScorer, reference narrator.py:149-241) and
``group_beam_search`` (diverse beam groups, reference
narrator.py:243-366).

Every decoder forward is the port's cached single-token
:meth:`VCLM.decode_step` (K9 for the self-attention, K3 for the norms,
on a CUDA tensor). The beam bookkeeping (scores, indices, the pools of
finished hypotheses) is small and runs on the host in numpy, as in the
JAX package, on the step's fp32 log-probabilities; the candidates of
``beam_sample`` are drawn by a host ``np.random.Generator``. Between
steps the flat ``(B, max_len, D)`` KV cache is gathered along the beam
axis on the device (``index_select``).

Under tensor parallelism every rank of the model group selects on model
rank 0's log-probabilities, so the host bookkeeping is the same on each
of them where the host generator of ``beam_sample`` is seeded alike (by
data rank).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lavila_tpu_torch.models import sampling as S
from lavila_tpu_torch.models.gpt2 import GPT2LMHead
from lavila_tpu_torch.parallel import mesh


class _Hypotheses:
    """One sample's pool of finished hypotheses under a length penalty
    (HF BeamHypotheses semantics)."""

    def __init__(self, num_beams: int, length_penalty: float):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.items: list[tuple[float, np.ndarray]] = []
        self.worst = 1e9

    def add(self, tokens: np.ndarray, sum_logprob: float):
        score = sum_logprob / max(len(tokens), 1) ** self.length_penalty
        if len(self.items) < self.num_beams or score > self.worst:
            self.items.append((score, tokens))
            if len(self.items) > self.num_beams:
                self.items.sort(key=lambda t: t[0])
                self.items.pop(0)
            self.worst = min(s for s, _ in self.items)

    def is_done(self, best_possible: float, cur_len: int) -> bool:
        if len(self.items) < self.num_beams:
            return False
        return self.worst >= best_possible / (cur_len ** self.length_penalty)


def _warp(scores: np.ndarray, temperature: float, top_k: Optional[int],
          top_p: Optional[float]) -> np.ndarray:
    """The sampling warpers on host scores, keeping at least two tokens
    a row (as HF's beam warpers)."""
    return S.warp_logits(torch.from_numpy(scores), temperature, top_k,
                         top_p, min_tokens_to_keep=2).numpy()


class BeamDecoder:
    """Beam decoding over a ``VCLM`` with its cached step.

    The ``select`` function of a mode takes the step's per-beam
    next-token log-probabilities ``(B, V)`` and the flat beam scores
    ``(B,)`` and returns a list of groups ``(slots, cand_scores,
    cand_tokens, cand_beams)``: the beam positions (within each sample)
    that the group refills, and ``(batch, 2·len(slots))`` candidates
    ranked best first."""

    def __init__(self, model, bos_id: int, eos_id: int, pad_id: int = 0,
                 max_text_length: int = 77):
        self.model = model
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.max_text_length = max_text_length

    @torch.inference_mode()
    def _run(self, image_tokens, num_beams, select_fn, length_penalty,
             num_return_sequences, init_beam_scores):
        model = self.model
        batch, device = image_tokens.shape[0], image_tokens.device
        B = batch * num_beams
        if not isinstance(model.text_decoder, GPT2LMHead):
            raise NotImplementedError(
                f"beam search reorders a GPT-2 (k, v) cache; it is not "
                f"implemented for {type(model.text_decoder).__name__}'s "
                f"cache")
        cross_kv = model.prepare_decode(
            image_tokens.repeat_interleave(num_beams, dim=0))
        # the cache in the tokens' (the model's) dtype
        cache = model.text_decoder.init_cache(
            B, self.max_text_length, dtype=image_tokens.dtype, device=device)

        ids = np.full((B, 1), self.bos_id, np.int64)
        beam_scores = np.tile(init_beam_scores[None], (batch, 1)).reshape(-1)
        hyps = [_Hypotheses(num_beams, length_penalty) for _ in range(batch)]
        done = np.zeros(batch, bool)

        cur = torch.full((B, 1), self.bos_id, dtype=torch.long,
                         device=device)
        for i in range(self.max_text_length - 1):
            logits = model.decode_step(cur, cross_kv, cache, i)
            logp = torch.log_softmax(logits.float(), dim=-1)
            # the ranks of a model group all select on model rank 0's
            mesh.broadcast_from_first(logp, mesh.model_group())
            logp = logp.cpu().numpy()

            groups = select_fn(logp, beam_scores)

            next_scores = np.array(beam_scores)
            next_tokens = np.full(B, self.pad_id, np.int64)
            next_beams = np.arange(B, dtype=np.int64)
            best_possible = np.full(batch, -np.inf)
            for slots, cand_scores, cand_tokens, cand_beams in groups:
                for b in range(batch):
                    best_possible[b] = max(best_possible[b],
                                           float(cand_scores[b].max()))
                    if done[b]:
                        for s in slots:
                            next_tokens[b * num_beams + s] = self.pad_id
                            next_scores[b * num_beams + s] = 0.0
                        continue
                    k = 0
                    for score, tok, beam in zip(cand_scores[b],
                                                cand_tokens[b],
                                                cand_beams[b]):
                        src = b * num_beams + beam
                        if tok == self.eos_id:
                            # only candidates from the top slots finish
                            if k < len(slots):
                                hyps[b].add(ids[src, 1:].copy(),
                                            float(score))
                            continue
                        slot = b * num_beams + slots[k]
                        next_scores[slot] = score
                        next_tokens[slot] = tok
                        next_beams[slot] = src
                        k += 1
                        if k == len(slots):
                            break
            for b in range(batch):
                if not done[b]:
                    done[b] = hyps[b].is_done(best_possible[b], i + 1)

            beam_scores = next_scores
            ids = np.concatenate([ids[next_beams], next_tokens[:, None]],
                                 axis=1)
            reorder = torch.from_numpy(next_beams).to(device)
            cache = [(k.index_select(0, reorder), v.index_select(0, reorder))
                     for k, v in cache]
            cur = torch.from_numpy(next_tokens[:, None]).to(device)
            if done.all():
                break

        # the beams still open at the end join their pools
        for b in range(batch):
            if done[b]:
                continue
            for j in range(num_beams):
                src = b * num_beams + j
                hyps[b].add(ids[src, 1:].copy(), float(beam_scores[src]))

        n_ret = num_return_sequences
        out = np.full((batch * n_ret, self.max_text_length), self.pad_id,
                      np.int64)
        out_scores = np.zeros(batch * n_ret, np.float32)
        for b in range(batch):
            ranked = sorted(hyps[b].items, key=lambda t: -t[0])[:n_ret]
            while len(ranked) < n_ret and ranked:
                ranked.append(ranked[-1])
            for j, (score, toks) in enumerate(ranked):
                row = b * n_ret + j
                seq = np.concatenate([[self.bos_id], toks])
                seq = seq[:self.max_text_length]
                out[row, :len(seq)] = seq
                if len(seq) < self.max_text_length:
                    out[row, len(seq)] = self.eos_id
                out_scores[row] = score
        return out, out_scores

    def beam_sample(self, image_tokens, *, rng: np.random.Generator,
                    num_beams: int = 3, num_return_sequences: int = 1,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    length_penalty: float = 1.0):
        """Stochastic beam search: 2·num_beams candidates drawn from the
        warped joint (beam, token) distribution by ``rng``, ranked by
        their joint score (reference narrator.py:179-227).
        ``num_return_sequences`` > 1 runs that many independent beam sets
        per sample, one hypothesis from each (the reference's
        BeamSearchScorer over batch·nrs, narrator.py:167-176). Returns
        ``(ids (B·nrs, max_text_length) int64, scores (B·nrs,) fp32)``
        as numpy arrays."""
        if num_return_sequences > 1:
            # rows b0r0, b0r1, ..., b1r0, ...: the reference's
            # expanded_return_idx (narrator.py:157-160)
            image_tokens = image_tokens.repeat_interleave(
                num_return_sequences, dim=0)
        slots = np.arange(num_beams)

        def select(logp, beam_scores):
            batch = logp.shape[0] // num_beams
            V = logp.shape[-1]
            scores = logp + beam_scores[:, None]
            warped = _warp(scores, temperature, top_k, top_p)
            flat = warped.reshape(batch, num_beams * V)
            orig = scores.reshape(batch, num_beams * V)
            cs = np.zeros((batch, 2 * num_beams), np.float32)
            ct = np.zeros((batch, 2 * num_beams), np.int64)
            cb = np.zeros((batch, 2 * num_beams), np.int64)
            for b in range(batch):
                p = np.exp(flat[b] - flat[b].max())
                p = p / p.sum()
                picks = rng.choice(len(p), size=2 * num_beams,
                                   replace=False, p=p)
                order = np.argsort(-orig[b, picks])
                picks = picks[order]
                cs[b] = orig[b, picks]
                ct[b] = picks % V
                cb[b] = picks // V
            return [(slots, cs, ct, cb)]

        # every beam starts at score 0: the identical prefixes diverge
        # through the draws (reference narrator.py:174)
        init = np.zeros(num_beams, np.float32)
        return self._run(image_tokens, num_beams, select, length_penalty,
                         1, init)

    def beam_search(self, image_tokens, *, num_beams: int = 3,
                    num_return_sequences: int = 1,
                    length_penalty: float = 1.0):
        """Deterministic beam search over the top 2·num_beams joint
        scores; the best ``num_return_sequences`` hypotheses a sample."""
        slots = np.arange(num_beams)

        def select(logp, beam_scores):
            batch = logp.shape[0] // num_beams
            V = logp.shape[-1]
            flat = (logp + beam_scores[:, None]).reshape(batch,
                                                         num_beams * V)
            picks = np.argsort(-flat, axis=-1)[:, :2 * num_beams]
            rows = np.arange(batch)[:, None]
            return [(slots, flat[rows, picks], picks % V, picks // V)]

        init = np.full(num_beams, -1e9, np.float32)
        init[0] = 0.0
        return self._run(image_tokens, num_beams, select, length_penalty,
                         num_return_sequences, init)

    def group_beam_search(self, image_tokens, *, num_beams: int = 6,
                          num_beam_groups: int = 3,
                          num_return_sequences: int = 1,
                          temperature: float = 1.0,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None,
                          length_penalty: float = 1.0):
        """Diverse beam search: an independent top-2g selection in each
        of ``num_beam_groups`` groups of g beams, over the warped scores
        (reference narrator.py:281-351)."""
        if num_beams % num_beam_groups:
            raise ValueError(f"num_beam_groups {num_beam_groups} must "
                             f"divide num_beams {num_beams}")
        g = num_beams // num_beam_groups

        def select(logp, beam_scores):
            batch = logp.shape[0] // num_beams
            V = logp.shape[-1]
            warped = _warp(logp + beam_scores[:, None], temperature, top_k,
                           top_p)
            groups = []
            for grp in range(num_beam_groups):
                slots = np.arange(grp * g, (grp + 1) * g)
                cs = np.zeros((batch, 2 * g), np.float32)
                ct = np.zeros((batch, 2 * g), np.int64)
                cb = np.zeros((batch, 2 * g), np.int64)
                for b in range(batch):
                    block = warped[b * num_beams + slots].reshape(-1)
                    picks = np.argsort(-block)[:2 * g]
                    cs[b] = block[picks]
                    ct[b] = picks % V
                    cb[b] = slots[0] + picks // V
                groups.append((slots, cs, ct, cb))
            return groups

        init = np.full(num_beams, -1e9, np.float32)
        init[::g] = 0.0
        return self._run(image_tokens, num_beams, select, length_penalty,
                         num_return_sequences, init)
