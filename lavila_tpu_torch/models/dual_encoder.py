"""CLIP-style dual encoders.

Counterpart of ``lavila_tpu/models/dual_encoder.py`` (``VideoCLIP``,
``VideoCLIPHF``, ``l2_normalize``). As in the reference checkpoints, the
video tower sits under ``visual.``; :class:`VideoCLIP` keeps the CLIP
text tower's modules at the top level (``token_embedding``,
``transformer.resblocks.{i}``, ``ln_final``, ``text_projection``),
:class:`VideoCLIPHF` its DistilBERT under ``textual.``; both beside
``image_projection`` and ``logit_scale``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lavila_tpu_torch.models.distilbert import DistilBertModel
from lavila_tpu_torch.models.openai_clip import (TextTransformer, encode_text,
                                                init_text_weights)
from lavila_tpu_torch.ops.basic import init_linear_


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / n.clamp_min(eps)).to(x.dtype)


class VideoCLIP(nn.Module):
    """Video tower + OpenAI CLIP text tower, matrix projections and a
    learnable logit scale initialised at ``log(1 / temperature_init)``."""

    def __init__(self, vision_model: nn.Module, text_model: TextTransformer,
                 embed_dim: int = 256, temperature_init: float = 0.07):
        super().__init__()
        self.visual = vision_model
        # adopt the text tower's modules at the top level
        self.token_embedding = text_model.token_embedding
        self.positional_embedding = text_model.positional_embedding
        self.transformer = text_model.transformer
        self.ln_final = text_model.ln_final
        self.text_projection = text_model.text_projection
        self.image_projection = nn.Parameter(
            torch.zeros(vision_model.embed_dim, embed_dim))
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / temperature_init)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``."""
        self.visual.init_weights(generator)
        init_text_weights(self, generator)
        width = self.image_projection.shape[0]
        nn.init.normal_(self.image_projection, 0.0, width ** -0.5,
                        generator=generator)

    def encode_image(self, image: torch.Tensor,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """``generator`` draws the video tower's drop-path masks (train
        mode only)."""
        return self.visual(image, generator=generator) @ \
            self.image_projection

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return encode_text(self, text)

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                norm_embed: bool = False,
                generator: torch.Generator | None = None) -> dict:
        image_embed = self.encode_image(image, generator)
        text_embed = self.encode_text(text)
        if norm_embed:
            image_embed = l2_normalize(image_embed)
            text_embed = l2_normalize(text_embed)
        return {"image_embed": image_embed, "text_embed": text_embed,
                "logit_scale": self.logit_scale.exp()}


class VideoCLIPHF(nn.Module):
    """Video tower + DistilBERT (``textual``), the text feature pooled at
    ``[CLS]``, and a learnable logit scale. ``projection``: 'default'
    (``image_projection`` and ``text_projection`` matrices) or
    'frozen_in_time' (``image_projection`` a ``Sequential(Linear)``,
    ``text_projection`` a ``Sequential(ReLU, Linear)``, the reference's
    keys ``image_projection.0`` and ``text_projection.1``)."""

    def __init__(self, vision_model: nn.Module, text_model: DistilBertModel,
                 embed_dim: int = 256, projection: str = "default",
                 temperature_init: float = 0.07):
        super().__init__()
        self.visual = vision_model
        self.textual = text_model
        self.projection = projection
        vw, tw = vision_model.embed_dim, text_model.dim
        if projection == "default":
            self.image_projection = nn.Parameter(torch.zeros(vw, embed_dim))
            self.text_projection = nn.Parameter(torch.zeros(tw, embed_dim))
        elif projection == "frozen_in_time":
            self.image_projection = nn.Sequential(nn.Linear(vw, embed_dim))
            self.text_projection = nn.Sequential(nn.ReLU(),
                                                 nn.Linear(tw, embed_dim))
        else:
            raise ValueError(f"projection must be 'default' or "
                             f"'frozen_in_time', got {projection!r}")
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / temperature_init)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``:
        normal(width ** -0.5) for the projection matrices and the text
        fc, lecun-normal (flax's default) for the image fc, zero
        biases."""
        self.visual.init_weights(generator)
        self.textual.init_weights(generator)
        vw, tw = self.visual.embed_dim, self.textual.dim
        if self.projection == "default":
            nn.init.normal_(self.image_projection, 0.0, vw ** -0.5,
                            generator=generator)
            nn.init.normal_(self.text_projection, 0.0, tw ** -0.5,
                            generator=generator)
        else:
            init_linear_(self.image_projection[0], generator)
            fc = self.text_projection[1]
            nn.init.normal_(fc.weight, 0.0, tw ** -0.5, generator=generator)
            fc.bias.zero_()

    def encode_image(self, image: torch.Tensor,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """``generator`` draws the video tower's drop-path masks (train
        mode only)."""
        x = self.visual(image, generator=generator)
        if self.projection == "default":
            return x @ self.image_projection
        return self.image_projection(x)

    def encode_text(self, text: torch.Tensor,
                    attention_mask: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """Token ids ``(B, L)`` with ``[CLS]`` first and their {0, 1}
        mask (None: every position attends)."""
        x = self.textual(text, attention_mask)[:, 0]
        if self.projection == "default":
            return x @ self.text_projection
        return self.text_projection(x)

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                mask: torch.Tensor | None = None, norm_embed: bool = False,
                generator: torch.Generator | None = None) -> dict:
        image_embed = self.encode_image(image, generator)
        text_embed = self.encode_text(text, mask)
        if norm_embed:
            image_embed = l2_normalize(image_embed)
            text_embed = l2_normalize(text_embed)
        return {"image_embed": image_embed, "text_embed": text_embed,
                "logit_scale": self.logit_scale.exp()}
