"""The dual encoder's train steps: pretraining and retrieval fine-tuning.

Counterpart of ``lavila_tpu/train/step.py`` (``TrainState``,
``make_clip_train_step``, ``make_retrieval_train_step``) on one device.
JAX's step is a pure function of an immutable state; here the step
updates the state in place (the
parameters, the optimizer's moments, the step count) and returns it, so
no second copy of the model or its moments is ever held.

Mixed precision follows the JAX package's ``dtype=bf16`` (parameters and
optimizer state fp32, the towers computing in bf16 with a bf16 residual
stream, LayerNorm statistics, softmax and the loss in fp32,
``logit_scale`` fp32), not ``torch.autocast``, which would promote the
residual stream to fp32 at the first fp32 add:

  * :attr:`TrainState.params` are the fp32 masters, the only tensors the
    optimizer sees;
  * :attr:`TrainState.model` is the working copy that runs forward and
    backward: every parameter in the compute dtype except the LayerNorm
    weights/biases and ``logit_scale``, which stay fp32 as flax keeps
    them (the LayerNorm kernels read fp32 γ/β beside bf16 rows);
  * after backward the gradients are cast to fp32 onto the masters, the
    optimizer updates the masters, and the masters are copied back into
    the working copy.

With an fp32 compute dtype the model is its own master: no copy is made.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from lavila_tpu_torch import losses
from lavila_tpu_torch.ops.basic import LayerNorm
from lavila_tpu_torch.train.optim import Optimizer, clamp_logit_scale


def working_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` in ``dtype``, LayerNorm γ/β and ``logit_scale``
    kept fp32."""
    work = copy.deepcopy(model)
    keep = {f"{m_name}.{p_name}".lstrip(".")
            for m_name, m in work.named_modules() if isinstance(m, LayerNorm)
            for p_name, _ in m.named_parameters(recurse=False)}
    for name, p in work.named_parameters():
        if name not in keep and not name.endswith("logit_scale"):
            p.data = p.data.to(dtype)
    return work


class TrainState:
    """What one step reads and writes: the working copy ``model``, the
    fp32 masters ``params`` (by parameter name), ``optimizer`` over the
    masters, the step count, and the generator of the drop-path masks."""

    def __init__(self, model: nn.Module, params: dict[str, torch.Tensor],
                 optimizer: Optimizer, step: int = 0,
                 generator: torch.Generator | None = None):
        self.model = model
        self.params = params
        self.optimizer = optimizer
        self.step = step
        self.generator = generator

    @classmethod
    def create(cls, model: nn.Module,
               make_optimizer: Callable[..., Optimizer],
               dtype: torch.dtype = torch.bfloat16,
               generator: torch.Generator | None = None) -> "TrainState":
        """``model`` in fp32 becomes the masters; ``make_optimizer`` takes
        the masters' (name, parameter) pairs."""
        params = dict(model.named_parameters())
        if any(p.dtype != torch.float32 for p in params.values()):
            raise TypeError("TrainState.create takes an fp32 model: its "
                            "parameters become the fp32 masters")
        work = model if dtype == torch.float32 else working_copy(model,
                                                                 dtype)
        return cls(work, params, make_optimizer(params.items()), 0,
                   generator)

    @property
    def has_copy(self) -> bool:
        return next(iter(self.params.values())) is not next(
            self.model.parameters())

    def state_dict(self) -> dict:
        """What a checkpoint holds: the fp32 masters under the model's
        parameter names, the optimizer and schedule states (and the
        running mean of the gradients under ``update_freq`` > 1), the
        step."""
        opt = self.optimizer.state_dict()
        return {"state_dict": {k: p.detach() for k, p in self.params.items()},
                **opt, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, ckpt: dict) -> None:
        for k, p in self.params.items():
            p.copy_(ckpt["state_dict"][k])
        self.optimizer.load_state_dict(
            {k: v for k, v in ckpt.items() if k not in ("state_dict", "step")})
        self.step = int(ckpt["step"])
        self._copy_masters()

    @torch.no_grad()
    def _copy_masters(self) -> None:
        if self.has_copy:
            for name, p in self.model.named_parameters():
                p.copy_(self.params[name])


def make_clip_train_step(norm_embed: bool = False,
                         loss_fn: Callable = losses.clip_loss,
                         use_ssl: bool = False, local_loss_mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``frames`` (B, T, H, W, C) and ``text`` (B, L) on the
    model's device, and the text's {0, 1} ``mask`` (B, L) where the
    batch has one (the DistilBERT dual encoders). One step: forward,
    ``loss_fn``, backward, the optimizer's update of the fp32 masters,
    ``logit_scale`` clamped,
    ``step += 1``. ``metrics`` are the loss function's, as detached fp32
    tensors (reading them synchronises; the step itself does not).
    """
    if use_ssl:
        raise NotImplementedError(
            "the SSL step (--metadata-aux) is not ported yet: ROADMAP "
            "queue 1: the SSL loss")
    if local_loss_mesh is not None:
        raise NotImplementedError(
            "the local loss over a mesh is not ported yet: ROADMAP queue "
            "1: multi-GPU")

    def train_step(state: TrainState, batch: dict):
        out = _forward(state, batch, norm_embed)
        metrics = loss_fn(out["image_embed"], out["text_embed"],
                          out["logit_scale"])
        metrics["loss"].backward()
        _update(state)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _forward(state: TrainState, batch: dict, norm_embed: bool) -> dict:
    """The working copy's forward on ``batch``, its gradients cleared;
    the batch's ``mask``, where it has one, goes to the text tower."""
    model = state.model
    for p in model.parameters():
        p.grad = None
    kwargs = {"mask": batch["mask"]} if "mask" in batch else {}
    return model(batch["frames"], batch["text"], norm_embed=norm_embed,
                 generator=state.generator, **kwargs)


def _update(state: TrainState, zero: tuple[str, ...] = ()) -> None:
    """After backward: the working copy's gradients (those named in
    ``zero`` zeroed) onto the fp32 masters, the optimizer's update,
    ``logit_scale`` clamped, the masters copied back, ``step += 1``."""
    for name, p in state.model.named_parameters():
        master = state.params[name]
        # a parameter the loss did not reach still decays, as in optax
        master.grad = (torch.zeros_like(master)
                       if p.grad is None or name in zero
                       else p.grad.float() if state.has_copy else p.grad)
    state.optimizer.step()
    clamp_logit_scale(state.params.items())
    state._copy_masters()
    state.step += 1


RETRIEVAL_LOSSES = ("clip", "max_margin", "adaptive_max_margin")


def make_retrieval_train_step(loss_type: str = "adaptive_max_margin",
                              margin: float = 0.4, norm_embed: bool = False):
    """The retrieval fine-tune's step (reference
    main_finetune_retrieval.py:131-160): the max-margin ranking loss over
    the batch, with the EK-100 relevancy (``batch["relevancy"]``, per
    clip) scaling the margin under ``adaptive_max_margin``, or the CLIP
    loss (CharadesEgo). ``logit_scale``'s gradient is always zeroed, as
    the reference freezes it (reference line 142). Returns
    ``train_step(state, batch) -> (state, metrics)``, as
    :func:`make_clip_train_step`."""
    if loss_type not in RETRIEVAL_LOSSES:
        raise ValueError(f"loss_type must be one of {RETRIEVAL_LOSSES}, "
                         f"got {loss_type!r}")

    def train_step(state: TrainState, batch: dict):
        out = _forward(state, batch, norm_embed)
        if loss_type == "clip":
            metrics = losses.clip_loss(out["image_embed"], out["text_embed"],
                                       out["logit_scale"])
        else:
            weights = (batch.get("relevancy")
                       if loss_type == "adaptive_max_margin" else None)
            metrics = losses.max_margin_loss(
                out["image_embed"], out["text_embed"], margin=margin,
                weights=weights)
        metrics["loss"].backward()
        _update(state, zero=("logit_scale",))
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
