"""OpenAI-CLIP text tower.

Counterpart of ``lavila_tpu/models/openai_clip.py`` (``MultiheadAttention``,
``ResidualAttentionBlock``, ``Transformer``, ``TextTransformer``), with
the reference state-dict names: ``transformer.resblocks.{i}.attn.
in_proj_weight``, ``.ln_1``, ``.mlp.c_fc``, ``token_embedding``,
``positional_embedding``, ``ln_final`` and ``text_projection``.

Causal self-attention over ``(B, L, D)`` without the reference's
NLD↔LND permutes (q/k/v are views of the packed in_proj output, handed
to the flash kernels K7/K8 without copies), pre-LN residual blocks with
QuickGELU, and EOT pooling at ``argmax(text)`` (the EOT token has the
largest id in CLIP's vocab).
The CLIP image tower (``VisionTransformer``) belongs to a later slice.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from lavila_tpu_torch.ops.attention import causal_attention
from lavila_tpu_torch.ops.basic import (LayerNorm, init_linear_,
                                        lecun_normal_, quick_gelu)


class MultiheadAttention(nn.Module):
    """Packed-QKV attention in the layout of ``torch.nn.MultiheadAttention``
    (``in_proj_weight`` ``(3D, D)``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        """Causal self-attention of ``x`` ``(B, L, D)``."""
        B, L, D = x.shape
        H = self.num_heads
        q, k, v = (t.reshape(B, L, H, D // H) for t in F.linear(
            x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        return self.out_proj(causal_attention(q, k, v).reshape(B, L, D))


class ClipMlp(nn.Module):
    """c_fc → QuickGELU → c_proj (the reference's key names)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, num_heads)
        self.ln_2 = LayerNorm(dim)
        self.mlp = ClipMlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x):
        """The blocks over ``x`` ``(B, L, D)``, each causal."""
        for blk in self.resblocks:
            x = blk(x)
        return x


class TextTransformer(nn.Module):
    """CLIP text tower: token embedding + learned PE + causal transformer +
    ``ln_final`` + EOT pooling + ``text_projection``."""

    CONTEXT_LENGTH = 77
    VOCAB_SIZE = 49408  # CLIP's BPE vocabulary

    def __init__(self, width: int = 512, heads: int = 8, layers: int = 12,
                 embed_dim: int = 256):
        super().__init__()
        self.token_embedding = nn.Embedding(self.VOCAB_SIZE, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(self.CONTEXT_LENGTH, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        init_text_weights(self, generator)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return encode_text(self, text)


def encode_text(tower: nn.Module, text: torch.Tensor) -> torch.Tensor:
    """The text tower's forward over the modules of ``tower``: a
    :class:`TextTransformer`, or a dual encoder that holds the same
    modules at its top level, as the reference checkpoints name them."""
    L = text.shape[1]
    x = tower.token_embedding(text) + tower.positional_embedding[:L]
    x = tower.transformer(x)
    x = tower.ln_final(x)
    x = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
    return x @ tower.text_projection


@torch.no_grad()
def init_text_weights(tower: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers for the text modules of ``tower``
    (as in :func:`encode_text`), drawn from ``generator``."""
    width = tower.positional_embedding.shape[1]
    nn.init.normal_(tower.token_embedding.weight, 0.0, 0.02,
                    generator=generator)
    nn.init.normal_(tower.positional_embedding, 0.0, 0.01,
                    generator=generator)
    nn.init.normal_(tower.text_projection, 0.0, width ** -0.5,
                    generator=generator)
    for blk in tower.transformer.resblocks:
        lecun_normal_(blk.attn.in_proj_weight, width, generator)
        blk.attn.in_proj_bias.zero_()
        init_linear_(blk.attn.out_proj, generator)
        init_linear_(blk.mlp.c_fc, generator)
        init_linear_(blk.mlp.c_proj, generator)
