"""Training losses.

Counterpart of ``lavila_tpu/losses.py``. On one device the global batch
is the local one, so :func:`clip_loss` is the whole InfoNCE; every
softmax and cross entropy is fp32 whatever the embeddings' dtype.
"""

from __future__ import annotations

import torch

# logit_scale is clamped to [0, LOGIT_SCALE_MAX] after every update:
# exp(4.6052) ≈ 100 (reference main_pretrain.py:529)
LOGIT_SCALE_MAX = 4.6052


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross entropy, fp32. logits (N, C), labels (N,)."""
    logits = logits.float()
    picked = logits.gather(1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def clip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
              logit_scale: torch.Tensor) -> dict:
    """Symmetric InfoNCE over the batch with diagonal labels (reference
    loss.py:46-118). Returns ``loss`` (= ``clip_loss``) and ``clip_acc``
    (top-1 video→text accuracy in %), fp32 scalars."""
    n = image_embed.shape[0]
    logits = logit_scale.float() * (image_embed.float()
                                    @ text_embed.float().T)
    labels = torch.arange(n, device=logits.device)
    loss = 0.5 * (_xent(logits, labels).mean()
                  + _xent(logits.T, labels).mean())
    acc = 100.0 * (logits.argmax(dim=-1) == labels).float().mean()
    return {"loss": loss, "clip_loss": loss, "clip_acc": acc}


def clip_loss_local(*args, **kwargs):
    raise NotImplementedError(
        "the local (all-gather) contrastive loss needs several GPUs: "
        "ROADMAP queue 1, slice 5 (multi-GPU)")


def ssl_clip_loss(*args, **kwargs):
    raise NotImplementedError(
        "the SSL loss over pseudo-narrations (--metadata-aux) is ROADMAP "
        "queue 1, slice 4")
