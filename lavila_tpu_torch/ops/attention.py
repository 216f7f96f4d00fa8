"""Attention primitives.

Counterpart of ``lavila_tpu/ops/attention.py``, with one formulation per
piece and none of the TPU layout variants:

  * :func:`attention`: multi-head attention over ``(B, L, H, d)`` with an
    additive mask and fp32 scores and softmax (GPT-2's self- and
    cross-attention, DistilBERT's self-attention under the key-padding
    bias of :func:`padding_bias`).
  * :func:`causal_attention` and :func:`full_attention`: multi-head
    self-attention over ``(B, L, H, d)`` views, causal (the CLIP text
    tower's) or over every key (the CLIP ViT's), through
    :func:`kernels.flash.flash_attention`, their single dispatch site: K8
    when autograd needs the gradient, K7 otherwise, on a CUDA tensor;
    their plain versions on a CPU tensor. The JAX package computes the
    ViT's attention in XLA (``lavila_tpu/ops/attention.py:attention``);
    the port takes the kernels wherever they are legal.
  * :func:`divided_attention_split`: divided space-time attention in the
    CLS-separate layout. The CLS token's global row over ``[itself; all
    F·N patches]`` goes through :func:`kernels.cls_row.cls_row`, its
    single dispatch site: the CUDA kernels (forward and backward, each
    k/v row read once in the input dtype) on a CUDA tensor, the plain
    version on a CPU tensor. The JAX package writes that row in XLA ops
    with a hand-written VJP (``lavila_tpu/ops/attention.py:
    _cls_row_attention``), which the tests hold both against. The patch
    tokens of each phase go through
    :func:`kernels.divided.divided_phase`, its single dispatch site: the
    CUDA kernel (K1 spatial, K2 temporal) on a CUDA tensor, the plain
    grouped formulation with the CLS key prepended on a CPU tensor. With
    a ring group set (``ops/ring_attention.py``, the JAX
    ``set_ring_mesh``), the time phase is the frame-sharded ring instead
    (plain products; the JAX ring has no Pallas kernel either).
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels.cls_row import cls_row
from lavila_tpu_torch.kernels.divided import divided_phase
from lavila_tpu_torch.kernels.flash import flash_attention
from lavila_tpu_torch.ops import ring_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention over ``(B, L, H, d)`` tensors, scaled by
    ``d ** -0.5``. ``mask`` is an additive fp32 bias broadcastable to
    ``(B, H, Lq, Lk)``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """A ``(B, L)`` {0, 1} key-padding mask → the additive fp32 bias
    ``(B, 1, 1, L)``: 0 where the mask is set, fp32's lowest value
    elsewhere (``lavila_tpu/ops/attention.py:padding_bias``)."""
    neg = torch.finfo(torch.float32).min
    bias = torch.where(attention_mask > 0, 0.0, neg).to(torch.float32)
    return bias[:, None, None, :]


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal multi-head self-attention over ``(B, L, H, d)`` views (row
    views of one packed qkv projection pass), scaled by ``d ** -0.5``:
    query i attends keys 0..i, as the JAX package's additive mask of
    fp32's lowest value above the diagonal. Returns ``(B, L, H, d)``."""
    return flash_attention(q, k, v, causal=True)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Multi-head self-attention of every query over every key, on
    ``(B, L, H, d)`` views as :func:`causal_attention` takes them, scaled
    by ``d ** -0.5``. Returns ``(B, L, H, d)``."""
    return flash_attention(q, k, v, causal=False)


def divided_attention_split(cls_q, cls_k, cls_v, qp, kp, vp, axis: str):
    """Divided space-time attention, CLS kept apart from the patches.

    cls_q/cls_k/cls_v: ``(B, 1, H, d)``; qp/kp/vp: ``(B, F, N, H, d)``
    frame-major and unscaled (row views of the qkv projection with any
    row stride). ``axis``: 'time' (group = position, F+1 keys) or 'space'
    (group = frame, N+1 keys). Returns ``(cls_out (B, 1, H, d),
    patches_out (B, F, N, H, d))``: the CLS row attends over all tokens,
    each patch within its group plus the CLS key. With a ring group set
    (:func:`ring_attention.set_ring_group`) the time phase runs
    :func:`ring_attention.divided_time_ring` over its ranks instead.
    """
    B, F, N, H, d = qp.shape
    D = H * d
    ring = ring_attention.get_ring_group()
    if axis == "time" and ring is not None:
        return ring_attention.divided_time_ring(cls_q, cls_k, cls_v, qp, kp,
                                                vp, ring)
    cls_out = cls_row(cls_q, cls_k, cls_v, kp, vp)
    out, _ = divided_phase(qp.reshape(B, F, N, D), kp.reshape(B, F, N, D),
                           vp.reshape(B, F, N, D), cls_k.reshape(B, D),
                           cls_v.reshape(B, D), axis, H, d ** -0.5)
    return cls_out, out.reshape(B, F, N, H, d)
