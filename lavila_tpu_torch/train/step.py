"""The train steps: the dual encoder's pretraining (the CLIP loss, or
the SSL loss over human and pseudo narrations), retrieval fine-tuning,
the classification fine-tune of the video tower, and the narrator's
caption step.

Counterpart of ``lavila_tpu/train/step.py`` (``TrainState``,
``make_clip_train_step``, ``make_retrieval_train_step``,
``make_classifier_train_step``, ``make_caption_train_step``).
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
    weights/biases (the narrator's bias-free pooler norms' γ too) and
    the scalars (``logit_scale``, the narrator's ``alpha_cattn`` and
    ``alpha_dense`` gates), which stay fp32 as flax keeps them (the
    LayerNorm kernels read fp32 γ/β beside bf16 rows);
  * after backward the gradients are cast to fp32 onto the masters, the
    optimizer updates the masters, and the masters are copied back into
    the working copy.

With an fp32 compute dtype the model is its own master: no copy is made.

A parameter the optimizer does not hold (``train.freeze``) is frozen:
it gets ``requires_grad_(False)`` in the masters and in the working
copy, so autograd computes no gradient for it (the JAX package's
``optax.set_to_zero`` never reads one, and XLA drops its computation),
it gets no ``.grad``, and it is never copied back after an update, since
it never changes.

The SSL loss's own parameter, ``logit_scale_pseudo``, lives in
:attr:`TrainState.criterion` (the JAX state's ``criterion_params``): an
fp32 scalar under the model's optimizer (no weight decay, as every
scalar; a share in the clipping norm), never cast and never clamped,
since the JAX step clamps only the model's parameters.

Data parallelism (``parallel/mesh.py``): in a process group each rank
steps on its rows of the global batch, the losses take the ranks'
embeddings through the differentiable all-gather, and before the
optimizer (its clipping and accumulation included) every rank's fp32
master gradients are averaged over the ranks in a few coalesced
buffers, in the same order on every rank (the frozen parameters, which
have none, skipped alike), so that every rank updates by the global
batch's gradient, as the JAX step on the ``data`` axis does. The
averaging runs at a world of one too; outside a group there is none.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from lavila_tpu_torch import losses
from lavila_tpu_torch.ops.basic import BiasFreeLayerNorm, LayerNorm
from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.train.optim import (MultiTransform, Optimizer,
                                          clamp_logit_scale)
from lavila_tpu_torch.utils import tracing


def working_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` in ``dtype``, the LayerNorms' parameters (γ/β,
    and the bias-free norms' γ) and the scalar parameters kept fp32."""
    work = copy.deepcopy(model)
    keep = {f"{m_name}.{p_name}".lstrip(".")
            for m_name, m in work.named_modules()
            if isinstance(m, (LayerNorm, BiasFreeLayerNorm))
            for p_name, _ in m.named_parameters(recurse=False)}
    for name, p in work.named_parameters():
        if name not in keep and p.dim() > 0:
            p.data = p.data.to(dtype)
    return work


def _held(optimizer: Optimizer | MultiTransform) -> set[int]:
    """The ids of the tensors ``optimizer`` updates."""
    opts = (optimizer.optimizers.values()
            if isinstance(optimizer, MultiTransform) else (optimizer,))
    return {id(p) for opt in opts for p in opt.params}


class TrainState:
    """What one step reads and writes: the working copy ``model``, the
    fp32 masters ``params`` (by parameter name), the loss's own fp32
    parameters ``criterion`` (by name; empty but for the SSL loss),
    ``optimizer`` over the masters and ``criterion``, the step count,
    the generator of the drop-path masks (and of the classifier's
    dropout), and the names of the ``frozen`` parameters, those the
    optimizer does not hold."""

    def __init__(self, model: nn.Module, params: dict[str, torch.Tensor],
                 optimizer: Optimizer | MultiTransform, step: int = 0,
                 generator: torch.Generator | None = None,
                 criterion: dict[str, torch.Tensor] | None = None):
        self.model = model
        self.params = params
        self.optimizer = optimizer
        self.step = step
        self.generator = generator
        self.criterion = criterion or {}
        held = _held(optimizer)
        self.frozen = {n for n, p in params.items() if id(p) not in held}
        for name, p in model.named_parameters():
            if name in self.frozen:
                p.requires_grad_(False)
                params[name].requires_grad_(False)
        for p in self.criterion.values():
            p.requires_grad_(id(p) in held)

    @classmethod
    def create(cls, model: nn.Module,
               make_optimizer: Callable[..., Optimizer | MultiTransform],
               dtype: torch.dtype = torch.bfloat16,
               generator: torch.Generator | None = None,
               criterion: dict[str, float] | None = None) -> "TrainState":
        """``model`` in fp32 becomes the masters; ``criterion`` (name →
        initial value) the loss's fp32 parameters on the model's device;
        ``make_optimizer`` takes the (name, parameter) pairs of both."""
        params = dict(model.named_parameters())
        if any(p.dtype != torch.float32 for p in params.values()):
            raise TypeError("TrainState.create takes an fp32 model: its "
                            "parameters become the fp32 masters")
        device = next(iter(params.values())).device
        crit = {k: nn.Parameter(torch.tensor(float(v), device=device))
                for k, v in (criterion or {}).items()}
        work = model if dtype == torch.float32 else working_copy(model,
                                                                 dtype)
        return cls(work, params,
                   make_optimizer([*params.items(), *crit.items()]), 0,
                   generator, crit)

    @property
    def has_copy(self) -> bool:
        return next(iter(self.params.values())) is not next(
            self.model.parameters())

    def state_dict(self) -> dict:
        """What a checkpoint holds: the fp32 masters under the model's
        parameter names, the optimizer and schedule states (and the
        running mean of the gradients under ``update_freq`` > 1), the
        step, and the loss's parameters under ``criterion`` where it has
        any."""
        opt = self.optimizer.state_dict()
        crit = ({"criterion": {k: p.detach()
                               for k, p in self.criterion.items()}}
                if self.criterion else {})
        return {"state_dict": {k: p.detach() for k, p in self.params.items()},
                **opt, **crit, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, ckpt: dict) -> None:
        for k, p in self.params.items():
            p.copy_(ckpt["state_dict"][k])
        for k, p in self.criterion.items():
            p.copy_(ckpt["criterion"][k])
        self.optimizer.load_state_dict(
            {k: v for k, v in ckpt.items()
             if k not in ("state_dict", "criterion", "step")})
        self.step = int(ckpt["step"])
        self._copy_masters(frozen=True)

    @torch.no_grad()
    def _copy_masters(self, frozen: bool = False) -> None:
        """The masters into the working copy; the frozen ones only with
        ``frozen`` (they never change after the first copy)."""
        if self.has_copy:
            for name, p in self.model.named_parameters():
                if frozen or name not in self.frozen:
                    p.copy_(self.params[name])


def make_clip_train_step(norm_embed: bool = False,
                         loss_fn: Callable = losses.clip_loss,
                         use_ssl: bool = False, local_loss: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``frames`` (B, T, H, W, C) and ``text`` (B, L) on the
    model's device, and the text's {0, 1} ``mask`` (B, L) where the
    batch has one (the DistilBERT dual encoders). One step: forward,
    ``loss_fn``, backward, the optimizer's update of the fp32 masters,
    ``logit_scale`` clamped,
    ``step += 1``. ``metrics`` are the loss function's, as detached fp32
    tensors (reading them synchronises; the step itself does not).

    ``use_ssl``: the loss is :func:`losses.ssl_clip_loss` at the pseudo
    scale ``exp(state.criterion["logit_scale_pseudo"])``, over the
    batch's ``gt_indicators`` (B,) (1 for a human narration, 0 for a
    pseudo one).

    ``local_loss`` (``--contrastive-use-vissl``; the JAX
    ``local_loss_mesh``): the loss is :func:`losses.clip_loss_local` (or
    :func:`losses.ssl_clip_loss_local`), each rank computing only its own
    rows of the logits against the gathered embeddings; the loss and the
    gradients are the global ones.
    """
    ssl_loss = (losses.ssl_clip_loss_local if local_loss
                else losses.ssl_clip_loss)
    if local_loss:
        loss_fn = losses.clip_loss_local

    def train_step(state: TrainState, batch: dict):
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                out = _forward(state, batch, norm_embed)
                if use_ssl:
                    metrics = ssl_loss(
                        out["image_embed"], out["text_embed"],
                        out["logit_scale"],
                        state.criterion["logit_scale_pseudo"].exp(),
                        batch["gt_indicators"])
                else:
                    metrics = loss_fn(out["image_embed"], out["text_embed"],
                                      out["logit_scale"])
            _backward(metrics["loss"])
            _update(state)
            return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _backward(loss: torch.Tensor) -> None:
    with tracing.span("train.backward"):
        loss.backward()


def _clear_grads(state: TrainState) -> None:
    for p in (*state.model.parameters(), *state.criterion.values()):
        p.grad = None


def _forward(state: TrainState, batch: dict, norm_embed: bool) -> dict:
    """The working copy's forward on ``batch``, its gradients (and the
    criterion's) cleared; the batch's ``mask``, where it has one, goes
    to the text tower."""
    model = state.model
    _clear_grads(state)
    kwargs = {"mask": batch["mask"]} if "mask" in batch else {}
    return model(batch["frames"], batch["text"], norm_embed=norm_embed,
                 generator=state.generator, **kwargs)


def _update(state: TrainState, zero: tuple[str, ...] = ()) -> None:
    """After backward: the working copy's gradients (those named in
    ``zero`` zeroed) onto the fp32 masters, averaged over the ranks of a
    process group, the optimizer's update, ``logit_scale`` clamped (not
    the criterion's parameters), the trained masters copied back,
    ``step += 1``. A frozen parameter gets no gradient."""
    with tracing.span("train.update"):
        with tracing.span("update.grads"):
            grads = _master_grads(state, zero)
        with tracing.span("update.average"):
            mesh.average_grads(grads)
        with tracing.span("update.optimizer"):
            state.optimizer.step()
            clamp_logit_scale(state.params.items())
        with tracing.span("update.copy"):
            state._copy_masters()
        state.step += 1


def _master_grads(state: TrainState,
                  zero: tuple[str, ...]) -> list[torch.Tensor]:
    """The working copy's gradients cast onto the fp32 masters (and the
    criterion's own), zeros where none reached a parameter or where it is
    named in ``zero``; returns them in the order every rank shares."""
    grads = []
    for name, p in state.model.named_parameters():
        if name in state.frozen:
            continue
        master = state.params[name]
        # a parameter the loss did not reach still decays, as in optax
        master.grad = (torch.zeros_like(master)
                       if p.grad is None or name in zero
                       else p.grad.float() if state.has_copy else p.grad)
        grads.append(master.grad)
    for p in state.criterion.values():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    return grads


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
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                out = _forward(state, batch, norm_embed)
                if loss_type == "clip":
                    metrics = losses.clip_loss(
                        out["image_embed"], out["text_embed"],
                        out["logit_scale"])
                else:
                    weights = (batch.get("relevancy")
                               if loss_type == "adaptive_max_margin"
                               else None)
                    metrics = losses.max_margin_loss(
                        out["image_embed"], out["text_embed"],
                        margin=margin, weights=weights)
            _backward(metrics["loss"])
            _update(state, zero=("logit_scale",))
            return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _xent_smoothed(logits: torch.Tensor, labels: torch.Tensor,
                   smoothing: float) -> torch.Tensor:
    """Mean cross entropy of fp32 ``log_softmax(logits)`` against the
    one-hot of class ids ``labels`` (B,), or against ``labels`` itself
    where it is already a (B, C) target (multi-hot), smoothed towards
    uniform by ``smoothing``."""
    n_cls = logits.shape[-1]
    target = (nn.functional.one_hot(labels.long(), n_cls).float()
              if labels.dim() == 1 else labels.float())
    if smoothing > 0:
        target = target * (1 - smoothing) + smoothing / n_cls
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(target * logp).sum(-1).mean()


def make_classifier_train_step(multihead: bool = False,
                               label_smoothing: float = 0.0):
    """The classification fine-tune's step (reference
    main_finetune_classification.py:453-464): cross entropy with label
    smoothing over a ``VideoClassifier``'s logits and ``batch["label"]``
    (class ids (B,), or a (B, C) multi-hot for the multi-label case,
    whose ``acc1`` is 0), or with ``multihead`` the sum of the verb, noun
    and action heads' terms over ``batch["labels"]`` (three (B,) id
    tensors; ``acc1`` is the action head's). The tower's drop-path masks
    and the head's dropout draw from ``state.generator``. Returns
    ``train_step(state, batch) -> (state, metrics)``, as
    :func:`make_clip_train_step`."""

    def train_step(state: TrainState, batch: dict):
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                _clear_grads(state)
                outs = state.model(batch["frames"],
                                   generator=state.generator)
                if multihead:
                    labels = batch["labels"]
                    loss = sum(_xent_smoothed(o, lab, label_smoothing)
                               for o, lab in zip(outs, labels))
                    top1 = 100.0 * (outs[-1].argmax(-1)
                                    == labels[-1]).float().mean()
                else:
                    lab = batch["label"]
                    loss = _xent_smoothed(outs, lab, label_smoothing)
                    top1 = (torch.zeros((), device=loss.device)
                            if lab.dim() > 1
                            else 100.0 * (outs.argmax(-1)
                                          == lab).float().mean())
            _backward(loss)
            _update(state)
            # the global batch's mean (equal rows on every rank)
            loss, top1 = mesh.all_reduce(
                torch.stack([loss, top1]).detach()) / mesh.data_world()
            return state, {"loss": loss, "acc1": top1}

    return train_step


def make_caption_train_step(pad_id: int = 0):
    """The narrator's step (reference CaptionLoss, loss.py:220-253; the
    JAX ``make_caption_train_step``): the teacher-forced forward of a
    ``VCLM`` on ``batch["frames"]`` and ``batch["text"]`` (the logits of
    ``text[:, :-1]`` against ``text[:, 1:]``), :func:`losses.caption_loss`
    with ``pad_id`` masked out, backward and the optimizer's update
    (``--update-freq`` through its accumulation); a VCLM has no
    ``logit_scale`` to clamp. Returns ``train_step(state, batch) -> (state,
    metrics)``, as :func:`make_clip_train_step`."""

    def train_step(state: TrainState, batch: dict):
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                _clear_grads(state)
                out = state.model(batch["frames"], batch["text"])
                metrics = losses.caption_loss(out["logits"], out["labels"],
                                              pad_id=pad_id)
            _backward(metrics["loss"])
            _update(state)
            return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
