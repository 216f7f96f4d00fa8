"""NLG metrics for narrator evaluation: BLEU-1..4, ROUGE-L, METEOR
(exact-match variant), CIDEr.

The reference shells out to nlg-eval (reference eval_narrator.py:296-301);
here the standard formulations are implemented directly in numpy so the
evaluation runs offline. CIDEr follows Vedantam et al. 2015 (tf-idf over
1-4 grams, cosine similarity, length gaussian penalty); ROUGE-L the
Lin 2004 LCS F-measure (beta=1.2); METEOR is the harmonic-mean variant on
exact unigram matches with the 0.5 fragmentation penalty (no WordNet
synonyms available offline — scores are a close lower bound).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import numpy as np


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(hypotheses: list[str], references: list[list[str]],
         max_n: int = 4) -> list[float]:
    """Corpus BLEU-1..max_n with brevity penalty (uniform weights)."""
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    hyp_len, ref_len = 0, 0
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            hc = _ngrams(h, n)
            max_ref = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(len(h) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in hc.items())
    precisions = clipped / np.maximum(totals, 1)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len /
                                                max(hyp_len, 1))
    out = []
    for n in range(1, max_n + 1):
        ps = precisions[:n]
        if (ps > 0).all():
            score = bp * math.exp(np.mean(np.log(ps)))
        else:
            score = 0.0
        out.append(float(score))
    return out


def _lcs_len(a: list[str], b: list[str]) -> int:
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if x == y
                                else max(dp[i, j + 1], dp[i + 1, j]))
    return int(dp[-1, -1])


def rouge_l(hypotheses: list[str], references: list[list[str]],
            beta: float = 1.2) -> float:
    """Mean ROUGE-L F-measure (max over references per sample)."""
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(h, r)
            if lcs == 0:
                continue
            p = lcs / len(h) if h else 0.0
            rec = lcs / len(r) if r else 0.0
            f = ((1 + beta ** 2) * p * rec) / (rec + beta ** 2 * p)
            best = max(best, f)
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def _porter_stemmer():
    try:
        from nltk.stem.porter import PorterStemmer
        return PorterStemmer()
    except Exception:
        return None


def meteor(hypotheses: list[str], references: list[list[str]],
           alpha: float = 0.9, beta_: float = 3.0,
           gamma: float = 0.5, use_stem: bool = True) -> float:
    """METEOR (original parameters α=0.9 β=3 γ=0.5, like nltk): staged
    exact-match then Porter-stem unigram alignment, weighted harmonic
    mean of P/R with the chunk fragmentation penalty (max over refs).
    The WordNet synonym stage is unavailable offline — see PARITY.md for
    the measured delta vs the reference's nlg-eval METEOR."""
    stemmer = _porter_stemmer() if use_stem else None
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            if not h or not r:
                continue
            # stage 1: greedy one-to-one exact alignment in order
            used = [False] * len(r)
            matched_h = [False] * len(h)
            align = []
            for i, w in enumerate(h):
                for j, v in enumerate(r):
                    if not used[j] and v == w:
                        used[j] = True
                        matched_h[i] = True
                        align.append((i, j))
                        break
            # stage 2: stem-equality on the leftovers
            if stemmer is not None:
                hs = [stemmer.stem(w) for w in h]
                rs = [stemmer.stem(v) for v in r]
                for i, w in enumerate(hs):
                    if matched_h[i]:
                        continue
                    for j, v in enumerate(rs):
                        if not used[j] and v == w:
                            used[j] = True
                            matched_h[i] = True
                            align.append((i, j))
                            break
            align.sort()
            m = len(align)
            if m == 0:
                continue
            p = m / len(h)
            rec = m / len(r)
            fmean = p * rec / (alpha * p + (1 - alpha) * rec)
            # chunks: maximal runs contiguous on both sides
            chunks = 1
            for (i0, j0), (i1, j1) in zip(align, align[1:]):
                if not (i1 == i0 + 1 and j1 == j0 + 1):
                    chunks += 1
            frag = gamma * (chunks / m) ** beta_
            best = max(best, fmean * (1 - frag))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def cider(hypotheses: list[str], references: list[list[str]],
          max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D style score: tf-idf weighted n-gram cosine similarity,
    averaged over n, with a length penalty."""
    # document frequencies over the reference corpus
    dfs = [Counter() for _ in range(max_n)]
    n_docs = len(references)
    for refs in references:
        seen = [set() for _ in range(max_n)]
        for ref in refs:
            toks = ref.split()
            for n in range(1, max_n + 1):
                seen[n - 1] |= set(_ngrams(toks, n))
        for n in range(max_n):
            for g in seen[n]:
                dfs[n][g] += 1

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        total = max(sum(cnt.values()), 1)
        vec = {}
        for g, c in cnt.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(dfs[n - 1][g], 1))
            vec[g] = (c / total) * idf
        return vec

    def cosine(va, vb, len_a, len_b):
        common = set(va) & set(vb)
        num = sum(min(va[g], vb[g]) * vb[g] for g in common)  # CIDEr-D clip
        na = math.sqrt(sum(v * v for v in va.values()))
        nb = math.sqrt(sum(v * v for v in vb.values()))
        if na == 0 or nb == 0:
            return 0.0
        pen = math.exp(-((len_a - len_b) ** 2) / (2 * sigma ** 2))
        return pen * num / (na * nb)

    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        per_n = []
        for n in range(1, max_n + 1):
            vh = tfidf_vec(h, n)
            s = 0.0
            for ref in refs:
                r = ref.split()
                s += cosine(vh, tfidf_vec(r, n), len(h), len(r))
            per_n.append(10.0 * s / max(len(refs), 1))
        scores.append(float(np.mean(per_n)))
    return float(np.mean(scores)) if scores else 0.0


def bert_style_normalize(text: str, wordpiece=None) -> str:
    """Reference protocol: hypotheses AND references are re-normalized
    through a BERT tokenizer encode→decode before scoring
    (reference eval_narrator.py:267-271). Given a ``WordPieceTokenizer``
    this is the exact round-trip (OOV words become [UNK]); without a
    vocab file the BasicTokenizer stage alone (lowercase, accent strip,
    punctuation split) is applied — identical output for in-vocab
    English text."""
    if wordpiece is not None:
        return wordpiece.decode(wordpiece.encode(text))
    from lavila_tpu_torch.data.tokenizers import bert_basic_tokens
    return " ".join(bert_basic_tokens(text))


def nlg_scores(hypotheses: list[str], references: list[list[str]]) -> dict:
    b = bleu(hypotheses, references)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "METEOR": meteor(hypotheses, references),
        "ROUGE_L": rouge_l(hypotheses, references),
        "CIDEr": cider(hypotheses, references),
    }
