"""Parameter freezing as optimizer masking.

Counterpart of ``lavila_tpu/train/freeze.py``. The reference freezes
parts by toggling ``requires_grad`` (reference timesformer.py:325-343,
gpt2_gated.py:1019-1028, models.py:334-345, main_pretrain.py:176); the
JAX package routes frozen leaves to ``optax.set_to_zero``. Here a frozen
parameter is left out of the optimizer (:func:`freeze_by_predicate`): it
gets no update, no weight decay and no share in the clipping norm, and
it stays in the fp32 masters and in every checkpoint. ``TrainState``
then turns its ``requires_grad`` off, so its gradient is never computed
(as XLA drops what ``set_to_zero`` never reads).

The predicates read the port's parameter names (``visual.blocks.0.
timeattn.qkv.weight``, ``logit_scale``, ``text_decoder.transformer.h.3.
crossattention...``), which hold the same words as the JAX package's
paths, so each is the JAX predicate's rule.
"""

from __future__ import annotations

from typing import Callable, Iterable


def freeze_by_predicate(named_params: Iterable,
                        frozen: Callable[[str], bool]) -> list:
    """The (name, parameter) pairs that train: those whose name does not
    satisfy ``frozen``. Hand them to ``train.optim.make_optimizer``."""
    return [(n, p) for n, p in named_params if not frozen(n)]


def temporal_parts(name: str) -> bool:
    """The TimeSformer's temporal branch: the temporal embedding, time
    attention and its norm (reference timesformer.py:328)."""
    return "temporal_embed" in name or "timeattn" in name or "norm3" in name


def spatial_parts(name: str) -> bool:
    """The video tower except its temporal branch (reference
    freeze_spatial_weights)."""
    if "vision_model" not in name and "visual" not in name:
        return False
    return not temporal_parts(name)


def lm_parts(name: str) -> bool:
    """GPT-2's weights except the cross-attention insertions (reference
    gpt2_gated.py:1019-1028)."""
    if "text_decoder" not in name:
        return False
    return not any(keep in name for keep in (
        "crossattention", "ln_cross_attn", "ln_2_crossattention",
        "mlp_crossattention", "alpha_cattn", "alpha_dense"))


def logit_scale_only(name: str) -> bool:
    return name.endswith("logit_scale")


def pseudo_scale_only(name: str) -> bool:
    """SSLCLIPLoss's own pseudo temperature (reference loss.py:141-143)."""
    return name.endswith("logit_scale_pseudo")


def build_freeze_predicate(*, freeze_temperature=False,
                           timesformer_freeze_space=False,
                           freeze_visual_vclm=False,
                           freeze_visual_vclm_temporal=False,
                           freeze_lm_vclm=False,
                           freeze_pseudo_temperature=False
                           ) -> Callable[[str], bool]:
    """One predicate for the reference's freeze flags."""
    preds = []
    if freeze_temperature:
        preds.append(logit_scale_only)
    if freeze_pseudo_temperature:
        preds.append(pseudo_scale_only)
    if timesformer_freeze_space or freeze_visual_vclm:
        preds.append(spatial_parts)
    if freeze_visual_vclm_temporal:
        preds.append(lambda n: ("vision_model" in n or "visual" in n)
                     and temporal_parts(n))
    if freeze_lm_vclm:
        preds.append(lm_parts)
    return lambda n: any(f(n) for f in preds)
