"""Training losses.

Counterpart of ``lavila_tpu/losses.py``. On one device the global batch
is the local one, so :func:`clip_loss` is the whole InfoNCE and
:func:`ssl_clip_loss` the whole two-temperature one; every
softmax and cross entropy is fp32 whatever the embeddings' dtype, and so
is :func:`max_margin_loss`, the retrieval fine-tune's ranking loss, and
:func:`caption_loss`, the narrator's teacher-forced cross entropy.
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


def ssl_clip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                  logit_scale: torch.Tensor, logit_scale_pseudo: torch.Tensor,
                  gt_indicators: torch.Tensor) -> dict:
    """Two-temperature InfoNCE over human (indicator 1) and pseudo
    (indicator 0) narrations (reference loss.py:121-217): a pair of two
    pseudo narrations takes ``logit_scale_pseudo``, a pair of two human
    ones ``logit_scale``, a mixed pair their geometric mean. Returns the
    :func:`clip_loss` keys, the counts ``num_gt``/``num_pseudo`` and the
    accuracy over each kind's rows, fp32 scalars."""
    n = image_embed.shape[0]
    ind = gt_indicators.float()
    pair = ind[None, :] + ind[:, None]  # (n, n) in {0, 1, 2}
    scale, pseudo = logit_scale.float(), logit_scale_pseudo.float()
    scale_mat = torch.where(pair == 0, pseudo,
                            torch.where(pair == 2, scale,
                                        torch.sqrt(scale * pseudo)))
    logits = scale_mat * (image_embed.float() @ text_embed.float().T)
    labels = torch.arange(n, device=logits.device)
    loss = 0.5 * (_xent(logits, labels).mean()
                  + _xent(logits.T, labels).mean())
    correct = (logits.argmax(dim=-1) == labels).float()
    num_gt, num_pseudo = ind.sum(), (1.0 - ind).sum()
    return {"loss": loss, "clip_loss": loss,
            "clip_acc": 100.0 * correct.mean(),
            "num_gt": num_gt, "num_pseudo": num_pseudo,
            "clip_acc_gt": 100.0 * (correct * ind).sum()
            / num_gt.clamp_min(1.0),
            "clip_acc_pseudo": 100.0 * (correct * (1.0 - ind)).sum()
            / num_pseudo.clamp_min(1.0)}


def ssl_clip_loss_local(*args, **kwargs):
    raise NotImplementedError(
        "the local (all-gather) SSL loss needs several GPUs: ROADMAP "
        "queue 1: multi-GPU")


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


def caption_loss(logits: torch.Tensor, labels: torch.Tensor,
                 pad_id: int = 0) -> dict:
    """The narrator's teacher-forced next-token cross entropy (reference
    loss.py:220-253): logits ``(B, L, V)`` against labels ``(B, L)``,
    per token in fp32 over the vocabulary, the ``pad_id`` labels masked
    out; ``loss`` (= ``caption_loss``) is the sum over the kept tokens
    over their count, ``caption_acc`` the kept tokens' top-1 accuracy in
    %, ``ppl`` the mean over samples of exp(the sample's NLL / its kept
    count)."""
    B, L, V = logits.shape
    per_tok = _xent(logits.reshape(B * L, V),
                    labels.reshape(B * L).long()).reshape(B, L)
    keep = (labels != pad_id).float()
    kept = keep.sum()
    per_sample = (per_tok * keep).sum(1)
    loss = per_sample.sum() / kept.clamp_min(1.0)
    correct = ((logits.argmax(-1) == labels).float() * keep).sum()
    ppl = torch.exp(per_sample / keep.sum(1).clamp_min(1.0)).mean()
    return {"loss": loss, "caption_loss": loss,
            "caption_acc": 100.0 * correct / kept.clamp_min(1e-8),
            "ppl": ppl}


def get_loss(model_name: str):
    """The loss of a model family (reference models.py:293-304): CLIP_*
    → InfoNCE, VCLM_* → the caption loss."""
    if model_name.startswith("CLIP"):
        return clip_loss
    if model_name.startswith("VCLM"):
        return caption_loss
    raise NotImplementedError(model_name)


def get_metric_names(model_name: str) -> list[str]:
    """The metric keys of a model family (reference models.py:307-313)."""
    if model_name.startswith("CLIP"):
        return ["loss", "clip_loss", "clip_acc"]
    if model_name.startswith("VCLM"):
        return ["loss", "caption_loss", "caption_acc", "ppl"]
    raise NotImplementedError(model_name)
