"""Model zoo: the reference factory names the port supports so far.

Counterpart of ``lavila_tpu/models/zoo.py``. Each factory builds the
module on the CPU, draws its initial weights from an explicit
``torch.Generator`` (the JAX package's initialisers, so one seed gives
the same weights whatever the device), then moves it to ``device`` in
``dtype``. Unlike the JAX zoo, an unknown keyword argument raises; of
the training options, ``drop_path_rate`` is taken and ``remat`` raises
unless False (not ported yet).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from lavila_tpu_torch.models.dual_encoder import VideoCLIP
from lavila_tpu_torch.models.openai_clip import TextTransformer
from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer

_REGISTRY: dict[str, Callable[..., VideoCLIP]] = {}


def register(fn):
    _REGISTRY[fn.__name__] = fn
    return fn


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(name: str, *, device, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                train: bool = False, **kwargs) -> nn.Module:
    """Build ``name`` with weights drawn from ``generator`` (seed 0 when
    None), on ``device`` in ``dtype``, in train mode when ``train`` and
    eval mode otherwise."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {available_models()}")
    model = _REGISTRY[name](**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.init_weights(generator)
    return model.to(device=device, dtype=dtype).train(train)


@register
def CLIP_OPENAI_TIMESFORMER_MINI(num_frames: int = 4,
                                 project_embed_dim: int = 64,
                                 temperature_init: float = 0.07,
                                 drop_path_rate: float = 0.0,
                                 remat: bool = False):
    """Tiny debug/CI configuration (not in the reference zoo): 64px,
    2-layer towers 64 wide."""
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat)
    text = TextTransformer(width=64, heads=4, layers=2,
                           embed_dim=project_embed_dim)
    return VideoCLIP(vision, text, project_embed_dim, temperature_init)


@register
def CLIP_OPENAI_TIMESFORMER_BASE(num_frames: int = 4,
                                 project_embed_dim: int = 256,
                                 temperature_init: float = 0.07,
                                 drop_path_rate: float = 0.0,
                                 remat: bool = False):
    """TSF-B video tower (12 blocks, 768 wide, 12 heads, 224², patch 16)
    with the CLIP text tower (12 layers, 512 wide, 8 heads, 77 tokens)."""
    vision = SpaceTimeTransformer(
        img_size=224, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat)
    text = TextTransformer(width=512, heads=8, layers=12,
                           embed_dim=project_embed_dim)
    return VideoCLIP(vision, text, project_embed_dim, temperature_init)
