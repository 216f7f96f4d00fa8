"""OpenAI CLIP's released checkpoints: their cache, and the TimeSformer
dual encoder's init from one.

Counterpart of ``lavila_tpu/models/openai_weights.py`` (the reference's
openai_clip loader, lavila/models/openai_clip.py:40-198): the official
URL map, whose second-to-last path component is each file's sha256, a
local cache (``$LAVILA_CLIP_CACHE``), a check of the digest, and a
download only when the file is absent and downloading is allowed; where
it fails, the error names the cache path to fill.
:func:`load_into_timesformer_dual_encoder` copies a released ViT into a
TimeSformer dual encoder as the reference factory does
(models.py:316-371): the visual weights renamed by
``convert.remap_clip_visual_to_timesformer``, the text tower copied
under its own names, each tensor only where the model has one of the
same shape, and the time attention left at its zero init.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import urllib.request

import torch
from torch import nn

from lavila_tpu_torch.models.convert import remap_clip_visual_to_timesformer

MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",  # noqa: E501
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",  # noqa: E501
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",  # noqa: E501
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",  # noqa: E501
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",  # noqa: E501
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",  # noqa: E501
}

CACHE_DIR = os.environ.get(
    "LAVILA_CLIP_CACHE", osp.expanduser("~/.cache/lavila_tpu/clip"))

# the CLIP text tower's entries outside its residual blocks, under the
# names the port's dual encoders give them
_TEXT_KEYS = ("token_embedding.weight", "positional_embedding",
              "ln_final.weight", "ln_final.bias", "text_projection")


def checkpoint_path(name: str, download: bool = True) -> str:
    """The checkpoint's path in :data:`CACHE_DIR`, its sha256 checked;
    downloaded first when absent and ``download``."""
    url = MODELS[name]
    expected_sha = url.split("/")[-2]
    path = osp.join(CACHE_DIR, url.split("/")[-1])
    if not osp.exists(path):
        if not download:
            raise FileNotFoundError(
                f"{name} checkpoint not cached at {path}; place the file "
                f"there (sha256 {expected_sha}) or allow download")
        os.makedirs(CACHE_DIR, exist_ok=True)
        try:
            urllib.request.urlretrieve(url, path)
        except OSError as e:  # URLError is an OSError
            raise FileNotFoundError(
                f"cannot download {url} (no network?): {e}; pre-populate "
                f"{path}") from e
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != expected_sha:
        raise RuntimeError(f"sha256 mismatch for {path}: got {digest}, "
                           f"expected {expected_sha}")
    return path


def load_state_dict(name: str, download: bool = True
                    ) -> dict[str, torch.Tensor]:
    """The released archive's state dict in fp32: a TorchScript archive
    (OpenAI's format), else a pickled model or state dict."""
    path = checkpoint_path(name, download)
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except (RuntimeError, ValueError):  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, nn.Module):
            sd = sd.state_dict()
    return {k: torch.as_tensor(v).float() for k, v in sd.items()}


@torch.no_grad()
def load_into_timesformer_dual_encoder(name: str, model: nn.Module,
                                       layers: int, text_layers: int,
                                       download: bool = True) -> nn.Module:
    """Initialise a TimeSformer ``VideoCLIP`` in place from the released
    CLIP checkpoint ``name``: the first ``layers`` ViT blocks remapped
    into the video tower (its time attention, ``norm3`` and
    ``temporal_embed`` keep their init), the text tower's first
    ``text_layers`` blocks and its other entries copied, each only where
    the model has a tensor of that name and shape; ``image_projection``,
    ``text_projection`` and ``logit_scale`` when the image projection's
    shape is the checkpoint's ``visual.proj``'s. Returns ``model``."""
    sd = load_state_dict(name, download)
    new = {f"visual.{k}": v
           for k, v in remap_clip_visual_to_timesformer(sd, layers).items()}
    blocks = tuple(f"transformer.resblocks.{i}." for i in range(text_layers))
    new.update({k: v for k, v in sd.items()
                if k in _TEXT_KEYS or k.startswith(blocks)})
    own = model.state_dict()
    if own["image_projection"].shape == sd["visual.proj"].shape:
        new.update(image_projection=sd["visual.proj"],
                   text_projection=sd["text_projection"],
                   logit_scale=sd["logit_scale"].reshape(
                       own["logit_scale"].shape))
    for k, v in new.items():
        if k in own and own[k].shape == v.shape:
            own[k].copy_(v)
    return model
