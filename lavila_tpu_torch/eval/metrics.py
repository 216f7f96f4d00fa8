"""Evaluation metric library (pure numpy).

Covers every metric family the reference evaluates with
(reference: lavila/utils/evaluation*.py):

  * top-k accuracy, per-class mean accuracy (EGTEA confusion matrix)
  * EK-100 MIR retrieval mAP / nDCG against a graded relevancy matrix
  * Charades-Ego multi-label video mAP
  * EgoMCQ intra/inter-video accuracy
  * EK-100 CLS verb/noun marginalization helpers
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


# --------------------------------------------------------------------------
# classification
# --------------------------------------------------------------------------

def topk_accuracy(logits: np.ndarray, targets: np.ndarray,
                  ks: Sequence[int] = (1,)) -> list[float]:
    """Top-k accuracy in percent (reference evaluation.py:accuracy)."""
    order = np.argsort(-logits, axis=-1)
    out = []
    for k in ks:
        hit = (order[:, :k] == targets[:, None]).any(axis=1)
        out.append(100.0 * hit.mean())
    return out


def confusion_matrix(preds: np.ndarray, targets: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (targets, preds), 1)
    return cm


def mean_class_accuracy(cm: np.ndarray) -> tuple[float, float]:
    """(mean per-class acc %, overall acc %) — EGTEA protocol
    (reference evaluation.py:get_mean_accuracy)."""
    totals = cm.sum(axis=1)
    per_class = np.where(totals > 0, np.diag(cm) / np.maximum(totals, 1), 0.0)
    return 100.0 * per_class.mean(), 100.0 * np.trace(cm) / max(cm.sum(), 1)


def marginal_indexes(action_to_parts: np.ndarray, part: int) -> list:
    """For each verb (part=0) / noun (part=1) id, the action ids containing
    it (reference evaluation_ek100cls.py:get_marginal_indexes)."""
    n = int(action_to_parts[:, part].max()) + 1
    out = []
    for v in range(n):
        idx = np.where(action_to_parts[:, part] == v)[0]
        out.append(idx if len(idx) else np.array([0]))
    return out


def marginalize(probs: np.ndarray, indexes: list) -> np.ndarray:
    """Sum action probabilities into verb/noun marginals."""
    return np.stack([probs[:, idx].sum(axis=1) for idx in indexes], axis=1)


# --------------------------------------------------------------------------
# EK-100 MIR retrieval: graded-relevancy mAP / nDCG
# --------------------------------------------------------------------------

def _average_precision_rows(sim: np.ndarray, rel: np.ndarray) -> np.ndarray:
    order = np.argsort(-sim, axis=1)
    rows = np.arange(sim.shape[0])[:, None]
    rel_ranked = rel[rows, order]
    # Reference protocol (evaluation_ek100mir.py:calculate_mAP): cumsum the
    # GRADED relevancy values, then zero every position whose own relevancy
    # is != 1 — p(k) at a hit thus credits partial-relevance items ranked
    # above it. Normalizer counts only rel == 1 docs.
    cum = np.cumsum(rel_ranked, axis=1)
    cum[rel_ranked != 1] = 0
    ranks = np.arange(1, sim.shape[1] + 1)[None]
    n_rel = (rel_ranked == 1).sum(axis=1)
    ap = (cum / ranks).sum(axis=1) / np.maximum(n_rel, 1)
    return np.where(n_rel > 0, ap, 0.0)


def retrieval_map(sim: np.ndarray, rel: np.ndarray
                  ) -> tuple[float, float, float]:
    """(video→text mAP, text→video mAP, avg); graded-relevance AP with
    hits at rel == 1 (reference evaluation_ek100mir.py:calculate_mAP/get_mAP)."""
    v = float(_average_precision_rows(sim, rel).mean())
    t = float(_average_precision_rows(sim.T, rel.T).mean())
    return v, t, (v + t) / 2


def _dcg_rows(sim: np.ndarray, rel: np.ndarray,
              k_counts: np.ndarray) -> np.ndarray:
    order = np.argsort(-sim, axis=1)
    rows = np.arange(sim.shape[0])[:, None]
    gains = rel[rows, order] * k_counts
    discounts = np.log2(np.arange(sim.shape[1]) + 2)[None]
    return (gains / discounts).sum(axis=1)


def _k_counts(rel: np.ndarray) -> np.ndarray:
    """Mask of valid retrieval slots: first k positions where k = number
    of relevant items per row (reference calculate_k_counts)."""
    return (np.sort(rel, axis=1)[:, ::-1] > 0).astype(np.float64)


def retrieval_ndcg(sim: np.ndarray, rel: np.ndarray
                   ) -> tuple[float, float, float]:
    """(video→text nDCG, text→video nDCG, avg)
    (reference evaluation_ek100mir.py:calculate_nDCG/get_nDCG)."""

    def one(s, r):
        kc = _k_counts(r)
        dcg = _dcg_rows(s, r, kc)
        idcg = _dcg_rows(r, r, kc)
        return float(np.mean(dcg / np.maximum(idcg, 1e-12)))

    v = one(sim, rel)
    t = one(sim.T, rel.T)
    return v, t, (v + t) / 2


# --------------------------------------------------------------------------
# Charades-Ego multi-label video mAP
# --------------------------------------------------------------------------

def multilabel_map(scores: np.ndarray, gts: np.ndarray
                   ) -> tuple[float, np.ndarray]:
    """(mAP %, per-class AP) over classes; videos with no labels are
    excluded the Charades way — their scores forced to -inf
    (reference evaluation_charades.py:charades_map)."""
    scores = scores.copy()
    empty = gts.sum(axis=1) == 0
    scores[empty] = -np.inf
    n_classes = scores.shape[1]
    aps = np.full(n_classes, np.nan)
    for c in range(n_classes):
        order = np.argsort(-scores[:, c])
        hits = gts[order, c] == 1
        n_pos = hits.sum()
        if n_pos < 1:
            continue
        prec = np.cumsum(hits) / np.arange(1, len(hits) + 1)
        aps[c] = prec[hits].sum() / n_pos
    return 100.0 * np.nanmean(aps), aps


# --------------------------------------------------------------------------
# EgoMCQ
# --------------------------------------------------------------------------

def egomcq_accuracy(preds: np.ndarray, answers: np.ndarray,
                    types: np.ndarray) -> dict:
    """Per-question-type accuracy; type 1 = intra-video, 2 = inter-video
    (reference evaluation_egomcq.py)."""
    out = {}
    for t, name in ((1, "Intra-video"), (2, "Inter-video")):
        m = types == t
        if m.sum() == 0:
            out[name] = float("nan")
            continue
        out[name] = 100.0 * float(
            (preds[m].argmax(axis=1) == answers[m]).mean())
    return out
