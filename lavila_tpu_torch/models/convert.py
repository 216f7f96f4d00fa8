"""The weight bridge: JAX parameter trees and released LaViLa checkpoints
to the port's state dicts.

The port names its parameters after the reference LaViLa state-dict keys
(the names ``lavila_tpu/models/import_torch.py`` reads), so a released
checkpoint loads with ``load_state_dict(strict=True)`` once ``module.``
is stripped and ``temporal_embed`` fits the clip length.

  * :func:`state_dict_from_jax` maps a ``lavila_tpu`` ``VideoCLIP``,
    ``VideoCLIPHF`` or ``VCLM`` parameter tree onto those keys: Dense
    kernels ``(in, out) → (out, in)``, Conv kernels ``(kh, kw, I, O) →
    (O, I, kh, kw)``, ``h_{i}`` → ``h.{i}``, the pooler's LN ``scale`` →
    ``gamma``; DistilBERT's flax names onto HF's under ``textual.``
    (``import_distilbert``'s map, read backwards), the frozen-in-time
    projections ``image_projection_fc`` / ``text_projection_fc`` onto
    ``image_projection.0`` / ``text_projection.1`` (as
    ``import_video_clip_hf`` reads them). Every JAX leaf must be
    consumed; a leftover raises.
  * :func:`load_reference_checkpoint` reads a reference ``.pt``/``.pth``
    (HF's ``position_ids`` buffer dropped, as the JAX importer ignores
    it);
    :func:`narrator_state_dict` turns a released narrator's keys into
    the port's (HF Conv1D ``(in, out)`` weights transposed, the tied
    ``lm_head`` and the attention-mask buffers dropped, the CoCa norms'
    zero ``beta`` buffers checked and dropped), and
    :func:`count_layers` reads a tower's depth from the checkpoint.

Numpy and torch only: ``import_torch`` itself is not imported, because
importing anything under ``lavila_tpu.models`` pulls in jax.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _block_index(name: str, stem: str) -> str:
    """``blocks_3`` → ``blocks.3`` (flax numbers submodules with '_')."""
    m = re.fullmatch(rf"{stem}_(\d+)", name)
    return f"{stem}.{m.group(1)}" if m else name


# last path element → (torch suffix, how the array is laid out)
_LEAF = {"kernel": ("weight", "dense"), "bias": ("bias", None),
         "scale": ("weight", None)}
# renames inside the text tower (the reference's MLP names)
_TEXT_RENAMES = {"fc1": "c_fc", "fc2": "c_proj"}
# DistilBERT: flax module names → HF's (lavila_tpu import_distilbert)
_BERT_EMBEDDINGS = {"word_embeddings": "embeddings.word_embeddings",
                    "position_embeddings": "embeddings.position_embeddings",
                    "emb_layer_norm": "embeddings.LayerNorm"}
_BERT_RENAMES = {"ffn_lin1": "ffn.lin1", "ffn_lin2": "ffn.lin2"}
# VideoCLIPHF's frozen-in-time projections: Sequential(Linear) and
# Sequential(ReLU, Linear) in the reference
_PROJECTION_FC = {"image_projection_fc": "image_projection.0",
                  "text_projection_fc": "text_projection.1"}


def _distilbert_key(rest: list) -> tuple[str, str | None]:
    """One flax path inside ``DistilBertModel`` → (key under
    ``textual.``, layout)."""
    if rest[0] in _BERT_EMBEDDINGS:
        name = _BERT_EMBEDDINGS[rest[0]]
        if rest[1] == "embedding":
            return f"textual.{name}.weight", None
        return f"textual.{name}.{_LEAF[rest[1]][0]}", None
    parts = [_BERT_RENAMES.get(p, p) for p in rest]
    layer = re.fullmatch(r"layer_(\d+)", parts[0]).group(1)
    suffix, layout = _LEAF[parts[-1]]
    return ".".join(["textual.transformer.layer", layer, *parts[1:-1],
                     suffix]), layout


def torch_key(path: tuple) -> tuple[str, str | None]:
    """Map one flax path to (reference key, layout), or raise KeyError."""
    top, rest = path[0], list(path[1:])
    if top in ("image_projection", "text_projection",
               "logit_scale") and not rest:
        return top, None
    if top in _PROJECTION_FC:
        suffix, layout = _LEAF[rest[0]]
        return f"{_PROJECTION_FC[top]}.{suffix}", layout
    if top == "vision_model":
        parts = [_block_index(p, "blocks") for p in rest]
        if parts[0] == "patch_embed":
            if parts[1] == "bias":  # the CLIP_HF towers' conv
                return "visual.patch_embed.proj.bias", None
            return "visual.patch_embed.proj.weight", {"kernel": "conv"}[
                parts[1]]
        if len(parts) == 1:  # cls_token, pos_embed, temporal_embed
            return f"visual.{parts[0]}", None
        suffix, layout = _LEAF[parts[-1]]
        return ".".join(["visual", *parts[:-1], suffix]), layout
    if top == "text_model" and (rest[0] in _BERT_EMBEDDINGS
                                or rest[0].startswith("layer_")):
        return _distilbert_key(rest)
    if top == "text_model":
        if rest == ["token_embedding", "embedding"]:
            return "token_embedding.weight", None
        if len(rest) == 1:  # positional_embedding, text_projection
            return rest[0], None
        parts = [_block_index(p, "resblocks") for p in rest]
        if parts[-2] == "in_proj":  # torch MultiheadAttention's packing
            name = {"kernel": "in_proj_weight", "bias": "in_proj_bias"}[
                parts[-1]]
            return ".".join([*parts[:-2], name]), (
                "dense" if parts[-1] == "kernel" else None)
        parts = [_TEXT_RENAMES.get(p, p) for p in parts]
        suffix, layout = _LEAF[parts[-1]]
        return ".".join([*parts[:-1], suffix]), layout
    if top == "img_queries" and not rest:
        return top, None
    if top in ("img_attn_pool", "img_attn_pool_norm"):
        if rest[-1] == "scale":  # CoCa's bias-free LayerNorm
            return ".".join([top, *rest[:-1], "gamma"]), None
        return ".".join([top, *rest[:-1], "weight"]), "dense"
    if top == "text_decoder":
        if rest[0] in ("wte", "wpe"):  # [name, "embedding"]
            return f"text_decoder.transformer.{rest[0]}.weight", None
        parts = [_block_index(p, "h") for p in rest]
        if parts[-1].startswith("alpha_"):
            return ".".join(["text_decoder.transformer", *parts]), None
        suffix, layout = _LEAF[parts[-1]]
        return ".".join(["text_decoder.transformer", *parts[:-1], suffix]), \
            layout
    raise KeyError(top)


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """``lavila_tpu`` ``VideoCLIP``, ``VideoCLIPHF`` or ``VCLM`` params (a
    nested dict of
    arrays, the ``'params'`` collection) → the port's fp32 state dict. Raises
    ``KeyError`` naming every leaf that has no counterpart."""
    out, leftover = {}, []
    for path, arr in _flatten(params).items():
        try:
            key, layout = torch_key(path)
        except (KeyError, IndexError):
            leftover.append("/".join(path))
            continue
        if layout == "dense":
            arr = arr.T
        elif layout == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(arr, dtype=torch.float32)
    if leftover:
        raise KeyError(f"{len(leftover)} JAX parameter(s) have no port "
                       f"counterpart: {sorted(leftover)}")
    return out


def inflate_temporal_embed(te: torch.Tensor,
                           num_frames: int) -> torch.Tensor:
    """``(1, F_ckpt, D) → (1, num_frames, D)``: truncate when shrinking,
    resample linearly (align_corners=False) when growing. The rule of
    ``lavila_tpu.models.import_torch.inflate_temporal_embed`` in its
    default 'bilinear' mode (reference models/utils.py:13-48)."""
    f = te.shape[1]
    if f >= num_frames:
        return te[:, :num_frames]
    pos = (torch.arange(num_frames, dtype=torch.float64) + 0.5) \
        * (f / num_frames) - 0.5
    lo = pos.floor().long().clamp(0, f - 1)
    hi = (lo + 1).clamp(max=f - 1)
    w = (pos - lo).clamp(0.0, 1.0).to(te.dtype)[None, :, None]
    return te[:, lo] * (1 - w) + te[:, hi] * w


def load_reference_checkpoint(path: str, num_frames: int | None = None
                              ) -> dict[str, torch.Tensor]:
    """Read a released LaViLa ``.pt``/``.pth`` checkpoint into a state
    dict for the port: take ``'state_dict'`` when present, strip the DDP
    ``module.`` prefix, drop HF's ``position_ids`` buffer (the CLIP_HF
    checkpoints' ``textual.embeddings.position_ids``, ``arange(512)``),
    cast to fp32, and fit ``visual.temporal_embed`` to ``num_frames``
    when given."""
    # released checkpoints pickle their argparse namespace beside the
    # weights, which weights_only=True refuses
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    sd = {k.removeprefix("module."): torch.as_tensor(v).float()
          for k, v in ckpt.items() if not k.endswith("position_ids")}
    if num_frames is not None and "visual.temporal_embed" in sd:
        sd["visual.temporal_embed"] = inflate_temporal_embed(
            sd["visual.temporal_embed"], num_frames)
    return sd


# HF GPT-2 Conv1D projections: weights stored (in, out)
_CONV1D = re.compile(r"text_decoder\.transformer\.h\.\d+\."
                     r"(attn|crossattention|mlp|mlp_crossattention)\."
                     r"(c_attn|c_proj|c_fc|q_attn)\.weight")
# buffers of the reference modules that the port does not keep
_DROPPED = re.compile(r"text_decoder\.lm_head\.weight"
                      r"|.*\.(attn|crossattention)\.(bias|masked_bias)")


def count_layers(sd: Mapping[str, torch.Tensor], prefix: str) -> int:
    """The number of distinct layer indices ``i`` among keys
    ``{prefix}{i}.*``."""
    return len({int(k[len(prefix):].split(".")[0]) for k in sd
                if k.startswith(prefix)
                and k[len(prefix):].split(".")[0].isdigit()})


def narrator_state_dict(sd: Mapping[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """A released narrator (``VCLM_*``) state dict, as
    :func:`load_reference_checkpoint` returns it, → the port's keys:
    Conv1D weights ``(in, out) → (out, in)``; ``lm_head.weight`` (tied to
    ``wte``) and the causal-mask buffers dropped; the CoCa norms' ``beta``
    buffers, which must be zero, dropped."""
    out = {}
    for k, v in sd.items():
        if _DROPPED.fullmatch(k):
            continue
        if k.endswith(".beta") and k.startswith("img_attn_pool"):
            if torch.count_nonzero(v):
                raise ValueError(f"{k}: a non-zero CoCa beta has no place "
                                 "in the port's bias-free LayerNorm")
            continue
        out[k] = v.T.contiguous() if _CONV1D.fullmatch(k) else v
    return out
