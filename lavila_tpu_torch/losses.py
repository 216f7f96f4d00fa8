"""Training losses.

Counterpart of ``lavila_tpu/losses.py``. On one device the global batch
is the local one, so :func:`clip_loss` is the whole InfoNCE; every
softmax and cross entropy is fp32 whatever the embeddings' dtype, and so
is :func:`max_margin_loss`, the retrieval fine-tune's ranking loss.
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
        "ROADMAP queue 1: multi-GPU")


def ssl_clip_loss(*args, **kwargs):
    raise NotImplementedError(
        "the SSL loss over pseudo-narrations (--metadata-aux) is not "
        "ported yet: ROADMAP queue 1: the SSL loss")


def _cosine_sim_matrix(a: torch.Tensor, b: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Rows of ``a`` against rows of ``b`` by cosine similarity, fp32."""
    a, b = a.float(), b.float()
    a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(eps)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(eps)
    return a @ b.T


def max_margin_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                    margin: float = 0.2,
                    weights: torch.Tensor | None = None) -> dict:
    """Bidirectional hinge ranking loss over the cosine similarity matrix
    (rows = texts), the diagonal (the positive pairs) left out of the
    mean: reference MaxMarginRankingLoss / AdaptiveMaxMarginRankingLoss
    with fix_norm=True (reference loss.py:267-367). ``weights`` (per text
    row, the EK-100 relevancy) scale the margin: the adaptive variant."""
    x = _cosine_sim_matrix(text_embed, image_embed)
    n = x.shape[0]
    diag = x.diagonal()
    w = (torch.ones(n, device=x.device) if weights is None
         else weights.float())
    m = w[:, None] * margin
    # text→video: row i's positive against every column; video→text:
    # column j's positive against every row (the transposed pass)
    h1 = torch.relu(m - (diag[:, None] - x))
    h2 = torch.relu(m - (diag[:, None] - x.T))
    off = 1.0 - torch.eye(n, device=x.device)
    loss = ((h1 * off).sum() + (h2 * off).sum()) / max(2.0 * n * (n - 1),
                                                       1.0)
    return {"loss": loss, "max_margin_loss": loss}


def get_loss(model_name: str):
    """The loss of a model family (reference models.py:293-304): CLIP_*
    → InfoNCE; the VCLM_* caption loss is not ported yet."""
    if model_name.startswith("CLIP"):
        return clip_loss
    raise NotImplementedError(
        f"{model_name}: only the CLIP family's loss is ported: ROADMAP "
        "queue 1: the narrator's training (the caption loss)")


def get_metric_names(model_name: str) -> list[str]:
    """The metric keys of a model family (reference models.py:307-313)."""
    if model_name.startswith("CLIP"):
        return ["loss", "clip_loss", "clip_acc"]
    raise NotImplementedError(
        f"{model_name}: only the CLIP family's metrics are ported: ROADMAP "
        "queue 1: the narrator's training (the caption loss)")
