"""Model zoo: the reference factory names the port supports so far.

Counterpart of ``lavila_tpu/models/zoo.py``. Each factory builds the
module on the generator's device, draws its initial weights from that
explicit ``torch.Generator`` (the JAX package's initialisers), then moves
it to ``device`` in ``dtype``. A CPU generator (the default) gives the
same weights whatever the target device; a generator on the target
device initialises a GPT-2 XL narrator there in seconds instead of
minutes on the host, with other (equally seeded) values. Unlike the JAX
zoo, an unknown keyword argument raises. The TimeSformer models take the
training options ``drop_path_rate`` (the dual encoders), ``remat`` and
``remat_policy`` (``full``, ``dots``, ``save_attn``, ``dots_attn``:
``models/timesformer.py``) and ``timesformer_gated_xattn`` (the tanh gate
on the time attention); as in the JAX zoo, the MINI and CLIP_HF towers
take the gate's keyword and build no gate.

The dual encoders are the TimeSformer ones with the CLIP text tower:
TSF-B (224², patch 16; text 512 wide, 8 heads) and TSF-L (patch 14,
1024 wide, 24 blocks, 16 heads; text 768 wide, 12 heads) at 224² and
336² (N = 576 patches a frame: the spatial phase runs K6); the same
three towers with DistilBERT (``*_DISTILBERT_BASE``, ``VideoCLIPHF``);
and the two CLIP_HF ones, a TSF-B-shaped tower without ``ln_pre``, with
a patch-embed bias and the erf GELU, with DistilBERT, under the matrix
projections (``CLIP_HF_TIMESFORMER``) or, by default, frozen-in-time's
MLP projections (``CLIP_HF_EGOVLP``). The
narrators (``VCLM_*``) are the TimeSformer ones: MINI (CI), TSF-B or
TSF-L with GPT-2 (12 layers, cross-attention on every layer), TSF-B or
TSF-L with GPT-2 XL (48 layers, cross-attention on every second), and
the flagship TSF-L@336 with GPT-2 XL (cross-attention on every third,
16 layers), the narrator LaViLa used to narrate Ego4D. As in the JAX
CLIs, the narrator CLIs build them with ``gated_xattn=True``. Beyond the
reference zoo, ``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_MOONLIGHT_16B_A3B``
puts the same tower and cross-attention in front of Moonlight-16B-A3B
(``models/moonlight.py``; its MINI sibling for CI); its decoder is made
in ``param_dtype``, since it does not fit one card in float32.

The raw OpenAI CLIP ViTs (``CLIP_OPENAI_VIT{B32,B16,L14,L14_336PX}``,
JAX ``_VIT_GEOM``) are dual encoders of a :class:`FrameMeanViT` (the
ViT per frame, its projected CLS feature mean-pooled over time) and the
CLIP text tower (512 wide with 8 heads when the ViT projects to 512,
else 768 wide with 12), with no image projection; the ViT narrators
(``VCLM_OPENAI_{VITB16,VITL14,VITL14_336PX}_GPT2_{LARGE,XL}``) condition
GPT-2 on a :class:`FrameTokensViT` (every frame's patch tokens before
``ln_post``) with cross-attention on every second layer. The JAX
factories swallow every keyword (``**_unused``); these accept the ones
the CLIs pass and give them the JAX meaning: ``num_frames``,
``project_embed_dim``, ``temperature_init``, ``drop_path_rate``,
``remat``, ``remat_policy`` and ``timesformer_gated_xattn`` change
nothing in a ViT dual encoder (the ViT has no remat and no drop path,
the logit scale starts at log(1 / 0.07), the embedding is the ViT's
``output_dim``); a ViT narrator hands ``remat`` to GPT-2 only and
ignores ``num_frames``, ``remat_policy`` and
``timesformer_gated_xattn``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from lavila_tpu_torch.models.distilbert import DistilBertModel
from lavila_tpu_torch.models.dual_encoder import VideoCLIP, VideoCLIPHF
from lavila_tpu_torch.models.gpt2 import (PRESETS, GPT2Config, GPT2LMHead,
                                          augment_config)
from lavila_tpu_torch.models.moonlight import MoonlightConfig, MoonlightLM
from lavila_tpu_torch.models.narrator import VCLM
from lavila_tpu_torch.models.openai_clip import (FrameMeanViT,
                                                FrameTokensViT,
                                                TextTransformer)
from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}


def register(fn):
    _REGISTRY[fn.__name__] = fn
    return fn


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(name: str, *, device, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                train: bool = False, **kwargs) -> nn.Module:
    """Build ``name`` with weights drawn from ``generator`` (a CPU one
    seeded 0 when None) on the generator's device, then move it to
    ``device`` in ``dtype``, in train mode when ``train`` and eval mode
    otherwise."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {available_models()}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        model = _REGISTRY[name](**kwargs)
    model.init_weights(generator)
    return model.to(device=device, dtype=dtype).train(train)


@register
def CLIP_OPENAI_TIMESFORMER_MINI(num_frames: int = 4,
                                 project_embed_dim: int = 64,
                                 temperature_init: float = 0.07,
                                 drop_path_rate: float = 0.0,
                                 remat: bool = False,
                                 remat_policy: str = "full",
                                 timesformer_gated_xattn: bool = False):
    """Tiny debug/CI configuration (not in the reference zoo): 64px,
    2-layer towers 64 wide; no time gate, as the JAX MINI."""
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat,
        remat_policy=remat_policy)
    text = TextTransformer(width=64, heads=4, layers=2,
                           embed_dim=project_embed_dim)
    return VideoCLIP(vision, text, project_embed_dim, temperature_init)


# TimeSformer geometries of the reference zoo (lavila_tpu/models/zoo.py:
# 55-70) and the width and heads of the CLIP text tower beside each
_TSF = {"base": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
        "large": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16)}
_TEXT = {"base": (512, 8), "large": (768, 12)}


def _timesformer(size: str, img_size: int, num_frames: int,
                 timesformer_gated_xattn: bool = False, **train_kw
                 ) -> SpaceTimeTransformer:
    return SpaceTimeTransformer(img_size=img_size, num_frames=num_frames,
                                is_tanh_gating=timesformer_gated_xattn,
                                **_TSF[size], **train_kw)


def _clip_timesformer(size: str, img_size: int, num_frames: int = 4,
                      project_embed_dim: int = 256,
                      temperature_init: float = 0.07,
                      drop_path_rate: float = 0.0,
                      remat: bool = False, remat_policy: str = "full",
                      timesformer_gated_xattn: bool = False) -> VideoCLIP:
    vision = _timesformer(size, img_size, num_frames,
                          timesformer_gated_xattn,
                          drop_path_rate=drop_path_rate, remat=remat,
                          remat_policy=remat_policy)
    width, heads = _TEXT[size]
    text = TextTransformer(width=width, heads=heads, layers=12,
                           embed_dim=project_embed_dim)
    return VideoCLIP(vision, text, project_embed_dim, temperature_init)


@register
def CLIP_OPENAI_TIMESFORMER_BASE(**kw):
    """TSF-B video tower (12 blocks, 768 wide, 12 heads, 224², patch 16)
    with the CLIP text tower (12 layers, 512 wide, 8 heads, 77 tokens)."""
    return _clip_timesformer("base", 224, **kw)


@register
def CLIP_OPENAI_TIMESFORMER_LARGE(**kw):
    """TSF-L video tower (24 blocks, 1024 wide, 16 heads, 224², patch 14:
    N = 256) with the CLIP text tower (12 layers, 768 wide, 12 heads)."""
    return _clip_timesformer("large", 224, **kw)


@register
def CLIP_OPENAI_TIMESFORMER_LARGE_336PX(**kw):
    """TSF-L at 336² (N = 576 patches a frame, K6), the high-resolution
    dual encoder, with the CLIP text tower (768 wide, 12 heads)."""
    return _clip_timesformer("large", 336, **kw)


def _clip_timesformer_distilbert(size: str, img_size: int,
                                 num_frames: int = 4,
                                 project_embed_dim: int = 256,
                                 temperature_init: float = 0.07,
                                 projection: str = "default",
                                 drop_path_rate: float = 0.0,
                                 remat: bool = False,
                                 remat_policy: str = "full",
                                 timesformer_gated_xattn: bool = False
                                 ) -> VideoCLIPHF:
    vision = _timesformer(size, img_size, num_frames,
                          timesformer_gated_xattn,
                          drop_path_rate=drop_path_rate, remat=remat,
                          remat_policy=remat_policy)
    return VideoCLIPHF(vision, DistilBertModel(), project_embed_dim,
                       projection, temperature_init)


@register
def CLIP_OPENAI_TIMESFORMER_BASE_DISTILBERT_BASE(**kw):
    """TSF-B video tower with DistilBERT (6 layers, 768 wide, 12 heads,
    ``[CLS]`` pooling)."""
    return _clip_timesformer_distilbert("base", 224, **kw)


@register
def CLIP_OPENAI_TIMESFORMER_LARGE_DISTILBERT_BASE(**kw):
    """TSF-L@224 video tower with DistilBERT."""
    return _clip_timesformer_distilbert("large", 224, **kw)


@register
def CLIP_OPENAI_TIMESFORMER_LARGE_336PX_DISTILBERT_BASE(**kw):
    """TSF-L@336 (N = 576, K6) with DistilBERT: LaViLa's TSF-L@HR
    recipe (docs/TRAINING.md)."""
    return _clip_timesformer_distilbert("large", 336, **kw)


def _clip_hf_timesformer(projection: str, num_frames: int = 4,
                         project_embed_dim: int = 256,
                         temperature_init: float = 0.07,
                         drop_path_rate: float = 0.0,
                         remat: bool = False, remat_policy: str = "full",
                         timesformer_gated_xattn: bool = False
                         ) -> VideoCLIPHF:
    # the JAX CLIP_HF towers take no gate either
    vision = SpaceTimeTransformer(
        img_size=224, num_frames=num_frames, drop_path_rate=drop_path_rate,
        remat=remat, remat_policy=remat_policy, ln_pre=False, act="gelu",
        **_TSF["base"])
    return VideoCLIPHF(vision, DistilBertModel(), project_embed_dim,
                       projection, temperature_init)


@register
def CLIP_HF_EGOVLP_DISTILBERT_BASE(projection: str = "frozen_in_time",
                                   **kw):
    """EgoVLP's configuration: the CLIP_HF tower (TSF-B shape, no
    ``ln_pre``, a patch-embed bias, erf GELU) with DistilBERT, under
    frozen-in-time's MLP projections unless ``projection`` says
    otherwise."""
    return _clip_hf_timesformer(projection, **kw)


@register
def CLIP_HF_TIMESFORMER_DISTILBERT_BASE(**kw):
    """The CLIP_HF tower with DistilBERT under the matrix projections."""
    return _clip_hf_timesformer("default", **kw)


def _vclm(vision: nn.Module, gpt2: GPT2Config,
          cross_attn_freq: int, gated_xattn: bool, remat: bool,
          heads: int, num_img_queries: int = 256, dim_head: int = 64):
    cfg = augment_config(gpt2, cross_attn_freq=cross_attn_freq,
                         gated_xattn=gated_xattn, remat=remat)
    return VCLM(vision, GPT2LMHead(cfg), vision_width=vision.embed_dim,
                text_width=cfg.n_embd, num_img_queries=num_img_queries,
                dim_head=dim_head, heads=heads)


# the TimeSformer narrators of the reference zoo: (tower size, image
# size, GPT-2 preset, cross-attention every n layers, pooler heads), as
# lavila_tpu/models/zoo.py:302-351 and its _GPT2_HEADS
_NARRATORS = {
    "BASE_GPT2": ("base", 224, "gpt2", 1, 12),
    "BASE_GPT2_XL": ("base", 224, "gpt2-xl", 2, 25),
    "LARGE_GPT2": ("large", 224, "gpt2", 1, 12),
    "LARGE_GPT2_XL": ("large", 224, "gpt2-xl", 2, 25),
    "LARGE_336PX_GPT2_XL": ("large", 336, "gpt2-xl", 3, 25),
}


def _register_narrator(suffix: str) -> None:
    size, img, preset, freq, heads = _NARRATORS[suffix]

    def factory(num_frames: int = 4, gated_xattn: bool = False,
                timesformer_gated_xattn: bool = False, remat: bool = False,
                remat_policy: str = "full"):
        vision = _timesformer(size, img, num_frames,
                              timesformer_gated_xattn, remat=remat,
                              remat_policy=remat_policy)
        return _vclm(vision, PRESETS[preset], freq, gated_xattn, remat,
                     heads=heads)

    factory.__name__ = f"VCLM_OPENAI_TIMESFORMER_{suffix}"
    factory.__doc__ = (f"TSF-{size[0].upper()}@{img} video tower with "
                       f"{preset.upper()}, cross-attention every {freq} "
                       f"layer(s), a {heads}-head attention pooler.")
    register(factory)


for _suffix in _NARRATORS:
    _register_narrator(_suffix)


@register
def VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI(num_frames: int = 4,
                                           gated_xattn: bool = False,
                                           remat: bool = False,
                                           remat_policy: str = "full",
                                           timesformer_gated_xattn:
                                           bool = False):
    """Tiny debug/CI narrator (not in the reference zoo): the MINI video
    tower (no time gate, as the JAX MINI), a 2-layer GPT-2 64 wide with
    cross-attention on every layer, 16 image queries of 4 heads × 16."""
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, remat=remat, remat_policy=remat_policy)
    gpt2 = GPT2Config(vocab_size=50257, n_positions=128, n_embd=64,
                      n_layer=2, n_head=4)
    return _vclm(vision, gpt2, 1, gated_xattn, remat, heads=4,
                 num_img_queries=16, dim_head=16)


def _moonlight_lm(cfg: MoonlightConfig,
                  param_dtype: torch.dtype) -> MoonlightLM:
    """The decoder with its parameters in ``param_dtype``, made on the
    meta device and then allocated on the current one (its weights are
    drawn by ``init_weights``): the published model's 16 B parameters do
    not fit one card in float32."""
    with torch.device("meta"):
        lm = MoonlightLM(cfg)
    return lm.to(param_dtype).to_empty(device=torch.get_default_device())


@register
def VCLM_OPENAI_TIMESFORMER_MINI_MOONLIGHT_MINI(num_frames: int = 4,
                                               gated_xattn: bool = False,
                                               remat: bool = False,
                                               remat_policy: str = "full",
                                               timesformer_gated_xattn:
                                               bool = False,
                                               param_dtype: torch.dtype =
                                               torch.float32):
    """Tiny debug/CI narrator on a Moonlight-shaped decoder (not in the
    reference zoo): the MINI video tower, 3 layers 256 wide (layer 0
    dense, 1-2 of 8 routed experts, top 3, and 2 shared), MLA of 4 heads
    (32 + 16 query/key dims, 32 value dims, a latent of 64),
    cross-attention on layers 0 and 2, 16 image queries of 4 heads × 16.
    The widths are the smallest the expert kernels take, so the card's
    tests build it too; it takes the published entry's ``param_dtype``,
    so that one call builds either."""
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, remat=remat, remat_policy=remat_policy)
    cfg = MoonlightConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512,
        moe_intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, kv_lora_rank=64, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=8,
        n_shared_experts=2, num_experts_per_tok=3, cross_attn_freq=2,
        cross_heads=4, gated_xattn=gated_xattn)
    return VCLM(vision, _moonlight_lm(cfg, param_dtype), vision_width=64,
                text_width=256, num_img_queries=16, dim_head=16, heads=4)


@register
def VCLM_OPENAI_TIMESFORMER_LARGE_336PX_MOONLIGHT_16B_A3B(
        num_frames: int = 4, gated_xattn: bool = False,
        timesformer_gated_xattn: bool = False, remat: bool = False,
        remat_policy: str = "full",
        param_dtype: torch.dtype = torch.float32):
    """The flagship narrator's TSF-L@336 tower and 256-query pooler (16
    heads × 64) into Moonlight-16B-A3B at its published configuration
    (``models/moonlight.py``), LaViLa's gated cross-attention before every
    third layer (9 of 27), as the TSF-L@336 GPT-2 XL narrator. Build it
    with ``param_dtype=torch.bfloat16`` (and ``dtype`` the same) on a
    card: the decoder's 16 B parameters do not fit one in float32.
    ``remat`` reaches the tower only (the expert kernels serve and do not
    train)."""
    vision = _timesformer("large", 336, num_frames, timesformer_gated_xattn,
                          remat=remat, remat_policy=remat_policy)
    cfg = MoonlightConfig(cross_attn_freq=3, gated_xattn=gated_xattn)
    return VCLM(vision, _moonlight_lm(cfg, param_dtype),
                vision_width=vision.embed_dim,
                text_width=cfg.hidden_size, num_img_queries=256,
                dim_head=64, heads=16)


# the raw OpenAI CLIP ViTs' geometry (lavila_tpu/models/zoo.py:358-367)
_VIT_GEOM = {
    "B32": dict(patch_size=32, width=768, layers=12, heads=12,
                output_dim=512, input_resolution=224),
    "B16": dict(patch_size=16, width=768, layers=12, heads=12,
                output_dim=512, input_resolution=224),
    "L14": dict(patch_size=14, width=1024, layers=24, heads=16,
                output_dim=768, input_resolution=224),
    "L14_336PX": dict(patch_size=14, width=1024, layers=24, heads=16,
                      output_dim=768, input_resolution=336),
}


def _register_clip_vit(geom: str) -> None:
    g = _VIT_GEOM[geom]

    def factory(num_frames: int = 4, project_embed_dim: int = 256,
                temperature_init: float = 0.07, drop_path_rate: float = 0.0,
                remat: bool = False, remat_policy: str = "full",
                timesformer_gated_xattn: bool = False):
        # every keyword is ignored, as the JAX factory swallows it
        text_width = 512 if g["output_dim"] == 512 else 768
        text = TextTransformer(width=text_width,
                               heads=8 if text_width == 512 else 12,
                               layers=12, embed_dim=g["output_dim"])
        return VideoCLIP(FrameMeanViT(**g), text, g["output_dim"],
                         use_image_projection=False)

    factory.__name__ = f"CLIP_OPENAI_VIT{geom}"
    factory.__doc__ = (f"OpenAI's CLIP ViT-{geom} ({g['layers']} blocks "
                       f"{g['width']} wide, patch {g['patch_size']}, "
                       f"{g['input_resolution']}²) per frame, mean-pooled, "
                       f"with the CLIP text tower; embeddings of "
                       f"{g['output_dim']}.")
    register(factory)


for _geom in _VIT_GEOM:
    _register_clip_vit(_geom)

# the ViT narrators (lavila_tpu/models/zoo.py:277-299): (geometry, GPT-2
# preset, pooler heads); cross-attention on every second layer
_VIT_NARRATORS = {
    "VITB16_GPT2_LARGE": ("B16", "gpt2-large", 20),
    "VITB16_GPT2_XL": ("B16", "gpt2-xl", 25),
    "VITL14_GPT2_XL": ("L14", "gpt2-xl", 25),
    "VITL14_336PX_GPT2_XL": ("L14_336PX", "gpt2-xl", 25),
}


def _register_vit_narrator(suffix: str) -> None:
    geom, preset, heads = _VIT_NARRATORS[suffix]

    def factory(num_frames: int = 4, gated_xattn: bool = False,
                timesformer_gated_xattn: bool = False, remat: bool = False,
                remat_policy: str = "full"):
        return _vclm(FrameTokensViT(**_VIT_GEOM[geom]), PRESETS[preset], 2,
                     gated_xattn, remat, heads=heads)

    factory.__name__ = f"VCLM_OPENAI_{suffix}"
    factory.__doc__ = (f"OpenAI's CLIP ViT-{geom} patch tokens of every "
                       f"frame into {preset.upper()}, cross-attention "
                       f"every 2 layers, a {heads}-head attention pooler.")
    register(factory)


for _suffix in _VIT_NARRATORS:
    _register_vit_narrator(_suffix)
