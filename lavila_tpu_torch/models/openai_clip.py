"""OpenAI-CLIP towers: the text tower and the image tower (ViT).

Counterpart of ``lavila_tpu/models/openai_clip.py`` (``MultiheadAttention``,
``ResidualAttentionBlock``, ``Transformer``, ``TextTransformer``,
``VisionTransformer``) and of the ViT frame wrappers of
``lavila_tpu/models/zoo.py`` (``FrameMeanViT``, ``_FrameTokensViT``), with
OpenAI's state-dict names: ``transformer.resblocks.{i}.attn.
in_proj_weight``, ``.ln_1``, ``.mlp.c_fc``; the text tower's
``token_embedding``, ``positional_embedding``, ``ln_final`` and
``text_projection``; the ViT's ``conv1`` (no bias), ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``ln_post`` and ``proj``.

Self-attention over ``(B, L, D)`` without the reference's NLD↔LND
permutes (q/k/v are views of the packed in_proj output, handed to the
flash kernels K7/K8 without copies), causal in the text tower and over
every key in the ViT; pre-LN residual blocks with QuickGELU; EOT pooling
at ``argmax(text)`` (the EOT token has the largest id in CLIP's vocab).
The ViT takes channel-last images ``(B, H, W, C)``; its patch
embedding is a plain convolution, as in the JAX package (outside
Pallas). Every LayerNorm is the port's (K3 on the card); the residual
adds stay separate from the norms, as the JAX blocks write them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from lavila_tpu_torch.ops.attention import causal_attention, full_attention
from lavila_tpu_torch.ops.basic import (LayerNorm, init_linear_,
                                        lecun_normal_, quick_gelu)
from lavila_tpu_torch.parallel.tensor import copy_to


class MultiheadAttention(nn.Module):
    """Packed-QKV attention in the layout of ``torch.nn.MultiheadAttention``
    (``in_proj_weight`` ``(3D, D)``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = True):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.head_dim = dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        # the model group once ``parallel.sharding.shard_model`` has
        # sliced in_proj to this rank's heads (a ``tensor.GroupRef``)
        self.tp = None

    def forward(self, x):
        """Self-attention of ``x`` ``(B, L, D)``, causal or over every
        key as the module was built, on the heads ``in_proj`` holds."""
        B, L, _ = x.shape
        D = self.in_proj_weight.shape[0] // 3
        H = D // self.head_dim
        if self.tp is not None:
            x = copy_to(x, self.tp.group)
        q, k, v = (t.reshape(B, L, H, self.head_dim) for t in F.linear(
            x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        attention = causal_attention if self.causal else full_attention
        return self.out_proj(attention(q, k, v).reshape(B, L, D))


class ClipMlp(nn.Module):
    """c_fc → QuickGELU → c_proj (the reference's key names)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, num_heads, causal)
        self.ln_2 = LayerNorm(dim)
        self.mlp = ClipMlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = True):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal)
            for _ in range(layers))

    def forward(self, x):
        """The blocks over ``x`` ``(B, L, D)``."""
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
    _init_blocks(tower.transformer, width, generator)


def _init_blocks(transformer: Transformer, width: int,
                 generator: torch.Generator) -> None:
    """flax's defaults for the blocks: lecun-normal kernels (the packed
    in_proj's fan-in is ``width``), zero biases; the norms ones and
    zeros, as built."""
    for blk in transformer.resblocks:
        lecun_normal_(blk.attn.in_proj_weight, width, generator)
        blk.attn.in_proj_bias.zero_()
        init_linear_(blk.attn.out_proj, generator)
        init_linear_(blk.mlp.c_fc, generator)
        init_linear_(blk.mlp.c_proj, generator)


class VisionTransformer(nn.Module):
    """CLIP ViT over channel-last images ``(B, H, W, C)``: the patch
    convolution, the CLS token prepended, the positional embedding,
    ``ln_pre``, the blocks over every token, ``ln_post`` on the CLS row
    and ``@ proj``. ``embed_dim`` is the width of what the forward
    returns: ``output_dim`` (the projected CLS feature)."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512):
        super().__init__()
        self.patch_size, self.width = patch_size, width
        self.embed_dim = output_dim
        self.num_patches = (input_resolution // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(self.num_patches + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, causal=False)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``:
        normal(width ** -0.5) for the class and positional embeddings and
        ``proj``, lecun-normal for the convolution (fan-in p·p·3) and the
        blocks as the text tower's."""
        D, p = self.width, self.patch_size
        lecun_normal_(self.conv1.weight, 3 * p * p, generator)
        for t in (self.class_embedding, self.positional_embedding,
                  self.proj):
            nn.init.normal_(t, 0.0, D ** -0.5, generator=generator)
        _init_blocks(self.transformer, D, generator)

    def forward(self, x: torch.Tensor, apply_project: bool = True,
                cls_at_last: bool = True) -> torch.Tensor:
        """``(B, H, W, C)`` → the CLS feature ``(B, output_dim)``
        (``(B, width)`` without ``apply_project``); with
        ``cls_at_last=False`` the patch tokens ``(B, N, width)`` before
        ``ln_post``, which the narrator conditions on."""
        w = self.conv1.weight
        x = F.conv2d(x.permute(0, 3, 1, 2).to(w.dtype), w,
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                    # (B, N, D)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(
            x.dtype)
        x = self.transformer(self.ln_pre(x))
        if not cls_at_last:
            return x[:, 1:]
        x = self.ln_post(x[:, 0].contiguous())
        return x @ self.proj if apply_project else x


class FrameMeanViT(VisionTransformer):
    """The ViT over each frame of a clip ``(B, T, H, W, C)``, its projected
    CLS features mean-pooled over T (an image ``(B, H, W, C)`` passes
    through): the dual encoders' image tower (reference
    openai_model.py:372-382). Its parameters are the ViT's own, so
    OpenAI's ``visual.*`` keys load as they are. ``generator`` (drop-path
    masks in the video towers) is accepted and unused: the ViT has no
    drop path."""

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if x.dim() == 4:
            return super().forward(x)
        B, T = x.shape[:2]
        feats = super().forward(x.reshape(B * T, *x.shape[2:]))
        return feats.reshape(B, T, -1).mean(dim=1)


class FrameTokensViT(VisionTransformer):
    """The ViT over each frame, the frames' patch tokens (before
    ``ln_post``, no CLS) concatenated to ``(B, T·N, width)``, with no
    temporal embedding: the narrators' conditioning on raw CLIP towers
    (reference narrator.py:63-70). ``embed_dim`` is the tokens' width."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.embed_dim = self.width

    def forward(self, x: torch.Tensor,
                cls_at_last: bool = False) -> torch.Tensor:
        B, T = x.shape[:2]
        toks = super().forward(x.reshape(B * T, *x.shape[2:]),
                               cls_at_last=False)
        return toks.reshape(B, T * toks.shape[1], toks.shape[2])
