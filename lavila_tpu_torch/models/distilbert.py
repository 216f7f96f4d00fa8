"""DistilBERT text encoder.

Counterpart of ``lavila_tpu/models/distilbert.py``, the text tower of the
CLIP_HF dual encoders, under the HF / LaViLa state-dict keys
(``embeddings.word_embeddings``, ``embeddings.position_embeddings``,
``embeddings.LayerNorm``, ``transformer.layer.{i}.attention.{q,k,v,
out}_lin``, ``.sa_layer_norm``, ``.ffn.lin{1,2}``,
``.output_layer_norm``), so a reference checkpoint's ``textual.*`` loads
strictly:

  embeddings: word + learned position embeddings → LayerNorm (eps 1e-12)
  n_layers × post-LN block: self-attention → add → sa_layer_norm →
             FFN (erf GELU) → add → output_layer_norm

The embeddings' norm is K3; each block's two residual norms are K5,
LN(a + b) with the sum taken in fp32 (the JAX package adds in the
activations' dtype, then normalises: the same in fp32, one rounding
apart in bf16). The self-attention is the plain :func:`attention` with
a per-sample key-padding bias (:func:`padding_bias`), as in the JAX
package: the flash kernels K7/K8 take one key length for the whole call,
not one per caption. There is no pooler and no token-type embedding;
the dual encoder pools the ``[CLS]`` row.
"""

from __future__ import annotations

import torch
from torch import nn

from lavila_tpu_torch.ops.attention import attention, padding_bias
from lavila_tpu_torch.ops.basic import LayerNorm, gelu_exact, init_linear_

EPS = 1e-12


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_lin = nn.Linear(dim, dim)
        self.k_lin = nn.Linear(dim, dim)
        self.v_lin = nn.Linear(dim, dim)
        self.out_lin = nn.Linear(dim, dim)

    def forward(self, x, bias=None):
        """Self-attention of ``x`` ``(B, L, D)`` under the additive fp32
        ``bias`` ``(B, 1, 1, L)``, or none."""
        B, L, _ = x.shape
        D = self.out_lin.in_features  # the heads held here
        H = D // self.head_dim
        q, k, v = (lin(x).reshape(B, L, H, self.head_dim)
                   for lin in (self.q_lin, self.k_lin, self.v_lin))
        return self.out_lin(attention(q, k, v, bias).reshape(B, L, D))


class FFN(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return self.lin2(gelu_exact(self.lin1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden_dim: int):
        super().__init__()
        self.attention = BertSelfAttention(dim, num_heads)
        self.sa_layer_norm = LayerNorm(dim, eps=EPS)
        self.ffn = FFN(dim, hidden_dim)
        self.output_layer_norm = LayerNorm(dim, eps=EPS)

    def forward(self, x, bias=None):
        x = self.sa_layer_norm(self.attention(x, bias), residual=x,
                               return_sum=False)
        return self.output_layer_norm(self.ffn(x), residual=x,
                                      return_sum=False)


class Embeddings(nn.Module):
    def __init__(self, vocab_size: int, dim: int,
                 max_position_embeddings: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_position_embeddings, dim)
        self.LayerNorm = LayerNorm(dim, eps=EPS)


class Transformer(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden_dim: int,
                 n_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerBlock(dim, num_heads, hidden_dim)
            for _ in range(n_layers))


class DistilBertModel(nn.Module):
    """Token ids ``(B, L)`` and an optional ``(B, L)`` {0, 1} attention
    mask → the last hidden state ``(B, L, dim)``. The defaults are
    ``distilbert-base-uncased``."""

    def __init__(self, vocab_size: int = 30522, dim: int = 768,
                 num_heads: int = 12, hidden_dim: int = 3072,
                 n_layers: int = 6, max_position_embeddings: int = 512):
        super().__init__()
        self.dim = dim
        self.embeddings = Embeddings(vocab_size, dim,
                                     max_position_embeddings)
        self.transformer = Transformer(dim, num_heads, hidden_dim, n_layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``:
        normal(0.02) embeddings, lecun-normal linears with zero biases;
        the LayerNorms keep their ones and zeros."""
        for emb in (self.embeddings.word_embeddings,
                    self.embeddings.position_embeddings):
            nn.init.normal_(emb.weight, 0.0, 0.02, generator=generator)
        for blk in self.transformer.layer:
            a = blk.attention
            for lin in (a.q_lin, a.k_lin, a.v_lin, a.out_lin, blk.ffn.lin1,
                        blk.ffn.lin2):
                init_linear_(lin, generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        emb = self.embeddings
        x = emb.word_embeddings(input_ids) \
            + emb.position_embeddings.weight[:input_ids.shape[1]]
        x = emb.LayerNorm(x)
        bias = None if attention_mask is None else padding_bias(
            attention_mask)
        for blk in self.transformer.layer:
            x = blk(x, bias)
        return x
