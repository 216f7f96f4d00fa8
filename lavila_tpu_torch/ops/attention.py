"""Attention primitives.

Counterpart of ``lavila_tpu/ops/attention.py``, with one formulation per
piece and none of the TPU layout variants:

  * :func:`attention`: multi-head attention over ``(B, L, H, d)`` with an
    additive mask and fp32 scores and softmax (GPT-2's self- and
    cross-attention, DistilBERT's self-attention under the key-padding
    bias of :func:`padding_bias`).
  * :func:`causal_attention`: causal multi-head self-attention over
    ``(B, L, H, d)`` views (the CLIP text tower's), through
    :func:`kernels.flash.flash_attention`, its single dispatch site: K8
    when autograd needs the gradient, K7 otherwise, on a CUDA tensor;
    their plain versions on a CPU tensor.
  * :func:`cls_row_attention`: the CLS token's global attention row over
    ``[itself; all F·N patches]``. The JAX package writes it in XLA ops,
    not Pallas, so it is plain PyTorch here too, and autograd gives its
    gradient (held against the JAX package's hand-written VJP). Autograd
    keeps its fp32 copies of k/v for the backward (~115 MB per clip over
    the tower's 24 phases at TSF-B width).
  * :func:`divided_attention_split`: divided space-time attention in the
    CLS-separate layout. The patch tokens of each phase go through
    :func:`kernels.divided.divided_phase`, its single dispatch site: the
    CUDA kernel (K1 spatial, K2 temporal) on a CUDA tensor, the plain
    grouped formulation with the CLS key prepended on a CPU tensor.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels.divided import divided_phase
from lavila_tpu_torch.kernels.flash import flash_attention


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


def cls_row_attention(cls_q, cls_k, cls_v, kp, vp):
    """The CLS query over ``[cls; all patches]``, fp32 softmax.

    cls_q/cls_k/cls_v: ``(B, 1, H, d)``; kp/vp: ``(B, F, N, H, d)``.
    Returns ``(B, 1, H, d)`` in the input dtype."""
    B, F, N, H, d = kp.shape
    scale = d ** -0.5
    q = cls_q[:, 0].float() * scale                          # (B, H, d)
    s_self = (q * cls_k[:, 0].float()).sum(-1)               # (B, H)
    s_pat = torch.einsum("bhd,bfnhd->bhfn", q, kp.float())
    scores = torch.cat([s_self[..., None], s_pat.reshape(B, H, F * N)], -1)
    p = torch.softmax(scores, dim=-1)                        # (B, H, 1+FN)
    out = p[..., 0, None] * cls_v[:, 0].float()
    out = out + torch.einsum("bhl,blhd->bhd", p[..., 1:],
                             vp.reshape(B, F * N, H, d).float())
    return out[:, None].to(kp.dtype)


def divided_attention_split(cls_q, cls_k, cls_v, qp, kp, vp, axis: str):
    """Divided space-time attention, CLS kept apart from the patches.

    cls_q/cls_k/cls_v: ``(B, 1, H, d)``; qp/kp/vp: ``(B, F, N, H, d)``
    frame-major and unscaled (row views of the qkv projection with any
    row stride). ``axis``: 'time' (group = position, F+1 keys) or 'space'
    (group = frame, N+1 keys). Returns ``(cls_out (B, 1, H, d),
    patches_out (B, F, N, H, d))``: the CLS row attends over all tokens,
    each patch within its group plus the CLS key.
    """
    B, F, N, H, d = qp.shape
    D = H * d
    cls_out = cls_row_attention(cls_q, cls_k, cls_v, kp, vp)
    out, _ = divided_phase(qp.reshape(B, F, N, D), kp.reshape(B, F, N, D),
                           vp.reshape(B, F, N, D), cls_k.reshape(B, D),
                           cls_v.reshape(B, D), axis, H, d ** -0.5)
    return cls_out, out.reshape(B, F, N, H, d)
