"""Training losses.

Counterpart of ``lavila_tpu/losses.py``. Every softmax and cross entropy
is fp32 whatever the embeddings' dtype, and so is
:func:`max_margin_loss`, the retrieval fine-tune's ranking loss, and
:func:`caption_loss`, the narrator's teacher-forced cross entropy.

Each function takes this rank's rows of the global batch. In a process
group (``parallel/mesh.py``) the global losses are the JAX functions on
the global batch, which GSPMD partitions there:

  * :func:`clip_loss`, :func:`ssl_clip_loss` and :func:`max_margin_loss`
    gather the ranks' embeddings (and their indicators and relevancy
    weights) with the differentiable all-gather and compute the whole
    ``B_global²`` matrix on every rank;
  * :func:`caption_loss` divides the sum over every rank's kept tokens by
    their global count;
  * the local losses (:func:`clip_loss_local`, :func:`ssl_clip_loss_local`;
    ``--contrastive-use-vissl``) compute only this rank's ``B_local ×
    B_global`` rows against the gathered embeddings and average the
    ranks' losses, as ``pmean`` does.

Each returns the global loss on every rank; its gradient, summed over
the ranks by the collectives' backward and averaged over them by
``train.step``, is the global batch's. Outside a group the global batch
is this process's. The ranks are those of the data group (the world at
``--mesh-model`` 1): the ranks of one model group hold one replica's
rows, and compute its embeddings alike.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.parallel import mesh

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
    image_embed = mesh.all_gather(image_embed)
    text_embed = mesh.all_gather(text_embed)
    n = image_embed.shape[0]
    logits = logit_scale.float() * (image_embed.float()
                                    @ text_embed.float().T)
    labels = torch.arange(n, device=logits.device)
    loss = 0.5 * (_xent(logits, labels).mean()
                  + _xent(logits.T, labels).mean())
    acc = 100.0 * (logits.argmax(dim=-1) == labels).float().mean()
    return {"loss": loss, "clip_loss": loss, "clip_acc": acc}


def _local_labels(b: int, device) -> torch.Tensor:
    """This rank's rows of the global diagonal: ``data_rank·b +
    arange(b)``."""
    return mesh.data_rank() * b + torch.arange(b, device=device)


def _pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks (differentiable, as ``pmean``)."""
    return mesh.all_reduce(x) / mesh.data_world()


def clip_loss_local(local_image: torch.Tensor, local_text: torch.Tensor,
                    logit_scale: torch.Tensor) -> dict:
    """:func:`clip_loss` as this rank's ``B_local × B_global`` rows
    against the gathered embeddings (``lavila_tpu/losses.py:53``; open_clip's
    ``local_loss``): the memory-scalable form, equal to the global loss
    and its gradients. ``loss`` and ``clip_acc`` are the ranks' mean."""
    all_image = mesh.all_gather(local_image)
    all_text = mesh.all_gather(local_text)
    labels = _local_labels(local_image.shape[0], local_image.device)
    scale = logit_scale.float()
    logits_i = scale * (local_image.float() @ all_text.float().T)
    logits_t = scale * (local_text.float() @ all_image.float().T)
    loss = _pmean(0.5 * (_xent(logits_i, labels).mean()
                         + _xent(logits_t, labels).mean()))
    acc = _pmean(100.0 * (logits_i.argmax(dim=-1) == labels).float().mean())
    return {"loss": loss, "clip_loss": loss, "clip_acc": acc.detach()}


def _pair_scale(ind_rows, ind_cols, logit_scale, logit_scale_pseudo):
    """The two-temperature scale of each (row, column) pair: the pseudo
    scale for two pseudo narrations, ``logit_scale`` for two human ones,
    their geometric mean for a mixed pair."""
    pair = ind_rows[:, None] + ind_cols[None, :]  # in {0, 1, 2}
    scale, pseudo = logit_scale.float(), logit_scale_pseudo.float()
    return torch.where(pair == 0, pseudo,
                       torch.where(pair == 2, scale,
                                   torch.sqrt(scale * pseudo)))


def ssl_clip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                  logit_scale: torch.Tensor, logit_scale_pseudo: torch.Tensor,
                  gt_indicators: torch.Tensor) -> dict:
    """Two-temperature InfoNCE over human (indicator 1) and pseudo
    (indicator 0) narrations (reference loss.py:121-217): a pair of two
    pseudo narrations takes ``logit_scale_pseudo``, a pair of two human
    ones ``logit_scale``, a mixed pair their geometric mean. Returns the
    :func:`clip_loss` keys, the counts ``num_gt``/``num_pseudo`` and the
    accuracy over each kind's rows, fp32 scalars."""
    image_embed = mesh.all_gather(image_embed)
    text_embed = mesh.all_gather(text_embed)
    ind = mesh.all_gather(gt_indicators.float())
    n = image_embed.shape[0]
    logits = (_pair_scale(ind, ind, logit_scale, logit_scale_pseudo)
              * (image_embed.float() @ text_embed.float().T))
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


def ssl_clip_loss_local(local_image: torch.Tensor, local_text: torch.Tensor,
                        logit_scale: torch.Tensor,
                        logit_scale_pseudo: torch.Tensor,
                        local_gt_indicators: torch.Tensor) -> dict:
    """:func:`ssl_clip_loss` as this rank's ``B_local × B_global`` rows
    against the gathered embeddings and indicators
    (``lavila_tpu/losses.py:113``): ``loss`` is the ranks' mean, the
    counts and accuracies are over the global batch."""
    all_image = mesh.all_gather(local_image)
    all_text = mesh.all_gather(local_text)
    ind_l = local_gt_indicators.float()
    ind_g = mesh.all_gather(ind_l)
    labels = _local_labels(local_image.shape[0], local_image.device)
    scale_mat = _pair_scale(ind_l, ind_g, logit_scale, logit_scale_pseudo)
    logits_i = scale_mat * (local_image.float() @ all_text.float().T)
    logits_t = scale_mat * (local_text.float() @ all_image.float().T)
    loss = _pmean(0.5 * (_xent(logits_i, labels).mean()
                         + _xent(logits_t, labels).mean()))
    correct = (logits_i.argmax(dim=-1) == labels).float()
    num_gt, num_pseudo, n_correct, corr_gt, corr_pseudo = mesh.all_reduce(
        torch.stack([ind_l.sum(), (1.0 - ind_l).sum(), correct.sum(),
                     (correct * ind_l).sum(),
                     (correct * (1.0 - ind_l)).sum()]).detach())
    return {"loss": loss, "clip_loss": loss,
            "clip_acc": 100.0 * n_correct / (num_gt + num_pseudo),
            "num_gt": num_gt, "num_pseudo": num_pseudo,
            "clip_acc_gt": 100.0 * corr_gt / num_gt.clamp_min(1.0),
            "clip_acc_pseudo": 100.0 * corr_pseudo
            / num_pseudo.clamp_min(1.0)}


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
    image_embed = mesh.all_gather(image_embed)
    text_embed = mesh.all_gather(text_embed)
    if weights is not None:
        weights = mesh.all_gather(weights.float())
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
    count). In a group the sums and counts are the global batch's: the
    ranks' kept tokens differ with their padding, so a mean of the
    ranks' losses would not be the global one."""
    B, L, V = logits.shape
    per_tok = _xent(logits.reshape(B * L, V),
                    labels.reshape(B * L).long()).reshape(B, L)
    keep = (labels != pad_id).float()
    per_sample = (per_tok * keep).sum(1)
    correct = ((logits.argmax(-1) == labels).float() * keep).sum()
    ppls = torch.exp(per_sample / keep.sum(1).clamp_min(1.0))
    kept, correct, ppl_sum, samples = mesh.all_reduce(torch.stack([
        keep.sum(), correct, ppls.sum(),
        keep.new_full((), float(B))]).detach())
    loss = mesh.all_reduce(per_sample.sum()) / kept.clamp_min(1.0)
    return {"loss": loss, "caption_loss": loss,
            "caption_acc": 100.0 * correct / kept.clamp_min(1e-8),
            "ppl": ppl_sum / samples}


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
