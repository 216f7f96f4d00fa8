"""CLIP-style dual encoder.

Counterpart of ``lavila_tpu/models/dual_encoder.py`` (``VideoCLIP``,
``l2_normalize``). As in the reference checkpoints, the video tower sits
under ``visual.`` and the text tower's modules at the top level
(``token_embedding``, ``transformer.resblocks.{i}``, ``ln_final``,
``text_projection``), beside ``image_projection`` and ``logit_scale``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lavila_tpu_torch.models.openai_clip import (TextTransformer, encode_text,
                                                init_text_weights)


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
