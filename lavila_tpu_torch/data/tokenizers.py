"""Tokenizers: CLIP BPE, GPT-2 byte-level BPE, BERT WordPiece.

Self-contained (no network, no HF hub): the CLIP merge table is vendored
under ``lavila_tpu_torch/assets`` (data asset shared with the reference,
reference: lavila/models/tokenizer.py:75-162); GPT-2/BERT vocabularies are
loaded from local files when provided.

All tokenizers return numpy int32 arrays padded to ``context_length``
(tokens after the true sequence are pad_id 0), matching the fixed-shape
contract the TPU input pipeline needs.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import unicodedata
from typing import Optional, Sequence

import numpy as np

try:
    import ftfy
except ImportError:  # pragma: no cover
    ftfy = None

try:
    import regex as _regex
except ImportError:  # pragma: no cover
    import re as _regex

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
CLIP_BPE_PATH = os.path.join(ASSETS_DIR, "bpe_simple_vocab_16e6.txt.gz")

# CLIP / GPT-2 shared byte-level BPE token pattern (public constant from
# the BPE papers/implementations; required verbatim for id parity)
_CLIP_PAT = _regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    _regex.IGNORECASE)
_GPT2_PAT = _regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
    r"""|\s+(?!\S)|\s+""")


@functools.lru_cache()
def byte_unicode_table() -> dict[int, str]:
    """Reversible byte→printable-unicode map (standard byte-level BPE).

    Insertion order defines vocab ids: printable bytes first ('!'..'~',
    '¡'..'¬', '®'..'ÿ'), then the remaining bytes mapped to chr(256+k)."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    table = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def _apply_bpe(symbols: tuple[str, ...],
               ranks: dict[tuple[str, str], int]) -> tuple[str, ...]:
    """Iteratively merge the lowest-rank adjacent pair."""
    word = list(symbols)
    while len(word) > 1:
        pairs = [(ranks.get((word[i], word[i + 1]), None), i)
                 for i in range(len(word) - 1)]
        candidates = [(r, i) for r, i in pairs if r is not None]
        if not candidates:
            break
        best_rank, best_i = min(candidates)
        a, b = word[best_i], word[best_i + 1]
        # merge ALL occurrences of the winning pair left-to-right
        merged = []
        i = 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                merged.append(a + b)
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = merged
    return tuple(word)


def _clean_text(text: str) -> str:
    if ftfy is not None:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _regex.sub(r"\s+", " ", text)
    return text.strip()


class ClipBpeTokenizer:
    """OpenAI CLIP tokenizer: 49408-entry vocab, word-final ``</w>``
    convention, fixed 77-token context with SOT/EOT."""

    def __init__(self, bpe_path: str = CLIP_BPE_PATH):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # header line + exactly 48894 merges → 49408 total vocab entries
        # (256 bytes + 256 byte</w> + merges + 2 specials)
        n_merges = 49152 - 256 - 2
        merge_pairs = [tuple(line.split()) for line in lines[1:1 + n_merges]]
        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base]
        vocab += ["".join(p) for p in merge_pairs]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merge_pairs)}
        self._cache: dict[str, tuple[str, ...]] = {}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.bos_token_id = self.sot_token
        self.eos_token_id = self.eot_token
        self.pad_token_id = 0

    def _bpe(self, token: str) -> tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        if not token:
            return ()
        symbols = tuple(token[:-1]) + (token[-1] + "</w>",)
        out = _apply_bpe(symbols, self.bpe_ranks)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _clean_text(text).lower()
        for tok in _CLIP_PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_token] + self.encode(t) + [self.eot_token]
            ids = ids[:context_length]
            out[i, :len(ids)] = ids
        return out[0] if single else out


class Gpt2BpeTokenizer:
    """GPT-2 byte-level BPE. Requires local ``vocab.json`` + ``merges.txt``
    (HF layout); no network access is attempted. Adds BOS/EOS like the
    reference narrator tokenizer (reference tokenizer.py:211-239):
    pad_token_id is 0 by that convention."""

    def __init__(self, vocab_file: str, merges_file: str,
                 add_bos: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self.bpe_ranks = {p: i for i, p in enumerate(merges)}
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, tuple[str, ...]] = {}
        self.bos_token_id = self.encoder.get("<|endoftext|>", 50256)
        self.eos_token_id = self.bos_token_id
        self.pad_token_id = 0
        self.add_bos = add_bos

    @classmethod
    def from_dir(cls, path: str, add_bos: bool = True):
        return cls(os.path.join(path, "vocab.json"),
                   os.path.join(path, "merges.txt"), add_bos=add_bos)

    def _bpe(self, token: str) -> tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        out = _apply_bpe(tuple(token), self.bpe_ranks)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        for tok in _GPT2_PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace")

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if self.add_bos:
                ids = [self.bos_token_id] + ids[:context_length - 2] \
                    + [self.eos_token_id]
            else:
                ids = ids[:context_length - 1] + [self.eos_token_id]
            out[i, :len(ids)] = ids
        return out[0] if single else out


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def bert_basic_tokens(text: str, lowercase: bool = True) -> list[str]:
    """BERT BasicTokenizer: lowercase + accent-strip + punctuation split +
    whitespace tokenize. Module-level so NLG normalization can reuse it
    without a vocab file."""
    if lowercase:
        text = _strip_accents(text.lower())
    out, cur = [], []
    for ch in text:
        if ch.isspace():
            if cur:
                out.append("".join(cur))
                cur = []
        elif _is_punct(ch):
            if cur:
                out.append("".join(cur))
                cur = []
            out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


class WordPieceTokenizer:
    """BERT/DistilBERT (uncased) tokenizer: basic tokenization + greedy
    longest-match WordPiece. Needs a local ``vocab.txt``. Returns
    (ids, attention_mask) like the reference wrappers
    (reference tokenizer.py:165-208)."""

    def __init__(self, vocab_file: str, lowercase: bool = True):
        self.vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    self.vocab[tok] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab["[UNK]"]
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        self.bos_token_id = self.cls_id
        self.eos_token_id = self.sep_id

    def _basic_tokens(self, text: str) -> list[str]:
        return bert_basic_tokens(text, lowercase=self.lowercase)

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in self._basic_tokens(text):
            ids.extend(self._wordpiece(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), "[UNK]") for i in ids]
        out = []
        for t in toks:
            if t.startswith("##"):
                out.append(t[2:])
            else:
                if out:
                    out.append(" ")
                out.append(t)
        return "".join(out)

    def __call__(self, texts, context_length: int = 77):
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        ids_out = np.zeros((len(texts), context_length), np.int32)
        mask_out = np.zeros((len(texts), context_length), np.float32)
        for i, t in enumerate(texts):
            ids = [self.cls_id] + self.encode(t) + [self.sep_id]
            ids = ids[:context_length]
            ids_out[i, :len(ids)] = ids
            mask_out[i, :len(ids)] = 1.0
        if single:
            return ids_out[0], mask_out[0]
        return ids_out, mask_out


def generate_tokenizer(model: str, assets_dir: Optional[str] = None):
    """Pick the tokenizer by model name, mirroring the reference factory
    (reference lavila/utils/preprocess.py:67-86). GPT-2/BERT vocabularies
    are looked up under ``assets_dir`` (or $LAVILA_TOKENIZER_DIR) in HF
    file layout: gpt2/vocab.json+merges.txt, bert/vocab.txt."""
    assets_dir = assets_dir or os.environ.get("LAVILA_TOKENIZER_DIR",
                                              ASSETS_DIR)

    def hf_path(sub):
        return os.path.join(assets_dir, sub)

    if model.endswith("DISTILBERT_BASE"):
        return WordPieceTokenizer(
            os.path.join(hf_path("distilbert-base-uncased"), "vocab.txt"))
    if model.endswith("BERT_BASE"):
        return WordPieceTokenizer(
            os.path.join(hf_path("bert-base-uncased"), "vocab.txt"))
    if model.endswith("BERT_LARGE"):
        return WordPieceTokenizer(
            os.path.join(hf_path("bert-large-uncased"), "vocab.txt"))
    for suffix, sub in (("GPT2_XL", "gpt2-xl"), ("GPT2_LARGE", "gpt2-large"),
                        ("GPT2_MEDIUM", "gpt2-medium"),
                        ("GPT2_MINI", "gpt2"), ("GPT2", "gpt2")):
        if model.endswith(suffix):
            return Gpt2BpeTokenizer.from_dir(hf_path(sub), add_bos=True)
    return ClipBpeTokenizer()
