"""Optimizer, LR schedule and weight-decay grouping.

Counterpart of ``lavila_tpu/train/optim.py`` (the reference recipe,
main_pretrain.py:199-222, scheduler.py:10-21), with ``torch.optim.AdamW``
(or ``torch.optim.SGD``) in place of the optax chain:

  * two parameter groups: weight decay only where :func:`no_decay` is
    False (matrices whose name holds no ``bias``/``ln``/``bn``);
  * the cosine schedule with linear warm-up, indexed like optax: the
    first update uses ``schedule(0)``;
  * optional clipping, by global norm with optax's formula
    ``g·c / max(‖g‖, c)`` or by value;
  * gradient accumulation (``update_freq`` k > 1) with
    ``optax.MultiSteps``' semantics: the gradients of k micro-steps
    averaged (its running mean), then one clipped update and one schedule
    step every k;
  * SGD with momentum 0.9 (``use_sgd``), as ``optax.sgd`` after a masked
    ``add_decayed_weights``: the decay joins the clipped gradient before
    the momentum trace, whose first value is that gradient (no
    dampening), which is what ``torch.optim.SGD`` with per-group
    ``weight_decay`` computes;
  * :func:`clamp_logit_scale` after each update.

Under tensor parallelism (``parallel/sharding.py``) a sharded parameter
(one with a ``tp_split``) is this rank's slice, and so is its optimizer
state; the clipping norm sums the sharded gradients' squares over the
model group and counts each replicated gradient once.

Frozen parameters (``train/freeze.py``) are left out of the optimizer
altogether: no update, no weight decay, no share in the clipping norm,
as ``optax.multi_transform`` with ``set_to_zero`` leaves them.
:class:`MultiTransform` is ``optax.multi_transform`` over labelled
groups (the classification fine-tune's head and backbone,
:func:`lr_multiplier_labels`), each an :class:`Optimizer` with its own
schedule and its own clipping norm.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from lavila_tpu_torch.losses import LOGIT_SCALE_MAX
from lavila_tpu_torch.parallel import mesh


def cosine_schedule(base_lr: float, final_lr: float, epochs: int,
                    steps_per_epoch: int, warmup_epochs: int = 0,
                    start_warmup_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up then cosine decay, the JAX package's curve."""
    warmup_steps = warmup_epochs * steps_per_epoch
    decay_steps = max(epochs * steps_per_epoch - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return start_warmup_lr + (base_lr - start_warmup_lr) * (
                step / max(warmup_steps, 1))
        t = (step - warmup_steps) / decay_steps
        return final_lr + 0.5 * (base_lr - final_lr) * (
            1.0 + math.cos(math.pi * t))

    return schedule


def no_decay(name: str, param: torch.Tensor) -> bool:
    """The reference grouping (main_pretrain.py:199-206): no weight decay
    for ndim < 2 or a name holding ``bias``/``ln``/``bn``."""
    return param.dim() < 2 or any(tag in name.lower()
                                  for tag in ("bias", "ln", "bn"))


def wd_mask(named_params: Iterable) -> dict[str, bool]:
    """True where weight decay applies."""
    return {n: not no_decay(n, p) for n, p in named_params}


def clamp_logit_scale(named_params: Iterable) -> None:
    """Clamp every ``logit_scale`` parameter into [0, log 100], in
    place."""
    with torch.no_grad():
        for name, p in named_params:
            if "logit_scale" in name.rsplit(".", 1)[-1]:
                p.clamp_(0.0, LOGIT_SCALE_MAX)


# the video tower's names: a classifier's, a dual encoder's
BACKBONE = ("vision_model", "visual")


def lr_multiplier_labels(names: Iterable[str]) -> dict[str, str]:
    """``'backbone'`` where a dotted component of the name is one of
    :data:`BACKBONE`, else ``'head'``: the classification fine-tune's
    groups for --lr-multiplier-on-backbone (reference
    main_finetune_classification.py:189-209)."""
    return {n: "backbone" if any(part in BACKBONE for part in n.split("."))
            else "head" for n in names}


class Optimizer:
    """Clipping, then AdamW (or SGD) at the scheduled rate: one
    :meth:`step` is one optax update of the JAX chain (with
    ``update_freq`` k > 1, one micro-step of ``optax.MultiSteps``: k of
    them make one update). ``inner``/``scheduler`` are the torch
    objects; :meth:`state_dict` holds both, and the running mean of the
    gradients when k > 1."""

    def __init__(self, named_params, lr: float | Callable[[int], float],
                 weight_decay: float, betas, eps: float,
                 clip_grad_value: float | None, clip_grad_type: str,
                 update_freq: int = 1, use_sgd: bool = False):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self.update_freq = update_freq
        # MultiSteps' running mean of the micro-steps' gradients, and how
        # many it holds
        self.mean_grads = ([torch.zeros_like(p) for p in self.params]
                           if update_freq > 1 else [])
        self.micro_step = 0
        decay = wd_mask(named)
        groups = [{"params": [p for n, p in named if decay[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not decay[n]],
                   "weight_decay": 0.0}]
        # the parameter names in the order of the inner state_dict's
        # indices (``parallel.sharding`` gathers a sharded one's moments)
        self.index_names = ([n for n, _ in named if decay[n]]
                            + [n for n, _ in named if not decay[n]])
        # lr 1.0 scaled by the schedule: the rate is schedule(count)
        # the JAX make_optimizer's optax.sgd momentum
        self.inner = (torch.optim.SGD(groups, lr=1.0, momentum=0.9)
                      if use_sgd else
                      torch.optim.AdamW(groups, lr=1.0, betas=tuple(betas),
                                        eps=eps))
        schedule = lr if callable(lr) else (lambda _: lr)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.inner,
                                                           schedule)
        self.clip_grad_value = clip_grad_value
        self.clip_grad_type = clip_grad_type

    @torch.no_grad()
    def _clip(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        c = self.clip_grad_value
        if self.clip_grad_type == "value":
            for g in grads:
                g.clamp_(-c, c)
            return
        sharded = [p.grad for p in self.params if p.grad is not None
                   and getattr(p, "tp_split", None) is not None]
        if sharded:
            norm = self._tp_norm(grads, sharded)
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        factor = c / torch.maximum(norm, torch.as_tensor(c, device=norm.device))
        for g in grads:
            g.mul_(factor.to(g.dtype))

    @staticmethod
    def _tp_norm(grads: list, sharded: list) -> torch.Tensor:
        """The global norm under tensor parallelism: the squared norms
        of the sharded gradients (this rank's slices) summed over the
        model group, each replicated gradient (the same on every rank
        of it) counted once."""
        ids = {id(g) for g in sharded}

        def sq(gs):
            return torch.stack([g.float().square().sum() for g in gs]).sum()
        total = mesh.all_reduce(sq(sharded), mesh.model_group())
        rep = [g for g in grads if id(g) not in ids]
        if rep:
            total = total + sq(rep)
        return total.sqrt()

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """Fold this micro-step's gradients into the running mean (as
        MultiSteps: ``acc + (g - acc) / (n + 1)``); on the k-th, hand the
        mean to the update as the gradients and restart. Returns whether
        an update is due."""
        n = self.micro_step
        for p, acc in zip(self.params, self.mean_grads):
            acc.add_((p.grad - acc) / (n + 1))
        self.micro_step = (n + 1) % self.update_freq
        if self.micro_step:
            return False
        for p, acc in zip(self.params, self.mean_grads):
            p.grad = acc.clone()
            acc.zero_()
        return True

    def step(self) -> None:
        if self.update_freq > 1 and not self._accumulate():
            return
        if self.clip_grad_value is not None:
            self._clip()
        self.inner.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        state = {"optimizer": self.inner.state_dict(),
                 "scheduler": self.scheduler.state_dict()}
        if self.update_freq > 1:
            state["accumulate"] = {"micro_step": self.micro_step,
                                   "mean_grads": [a.clone()
                                                  for a in self.mean_grads]}
        return state

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.update_freq > 1:
            acc = state["accumulate"]
            self.micro_step = int(acc["micro_step"])
            with torch.no_grad():
                for a, saved in zip(self.mean_grads, acc["mean_grads"]):
                    a.copy_(saved)


def make_optimizer(named_params, lr: float | Callable[[int], float],
                   weight_decay: float = 0.01,
                   betas: tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, clip_grad_value: float | None = None,
                   clip_grad_type: str = "norm", update_freq: int = 1,
                   use_sgd: bool = False) -> Optimizer:
    """AdamW (SGD with momentum 0.9 under ``use_sgd``) over
    ``named_params`` ((name, tensor) pairs), as the JAX package's
    ``make_optimizer``; pass the pairs through
    ``train.freeze.freeze_by_predicate`` to freeze some."""
    if clip_grad_type not in ("norm", "value"):
        raise ValueError(clip_grad_type)
    if update_freq < 1:
        raise ValueError(f"update_freq must be >= 1, got {update_freq}")
    return Optimizer(named_params, lr, weight_decay, betas, eps,
                     clip_grad_value, clip_grad_type, update_freq, use_sgd)


class MultiTransform:
    """``optax.multi_transform`` over labelled groups: each label's
    parameters under their own :class:`Optimizer`, so each group has its
    own schedule and is clipped by its own global norm, and every
    :meth:`step` steps them all. Where each group accumulates over the
    same ``update_freq``, every group's running mean is the one that
    ``optax.MultiSteps`` outside the multi-transform keeps for its
    leaves, and all update on the same micro-step."""

    def __init__(self, optimizers: dict[str, Optimizer]):
        self.optimizers = optimizers

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    def state_dict(self) -> dict:
        return {label: opt.state_dict()
                for label, opt in self.optimizers.items()}

    def load_state_dict(self, state: dict) -> None:
        for label, opt in self.optimizers.items():
            opt.load_state_dict(state[label])


def make_multi_optimizer(named_params, labels: dict[str, str],
                         lrs: dict[str, float | Callable[[int], float]],
                         **kwargs) -> MultiTransform:
    """One :func:`make_optimizer` per label of ``lrs`` over the
    parameters that ``labels`` (name → label) gives it, with that
    label's rate and the shared ``kwargs``."""
    named = list(named_params)
    return MultiTransform({
        label: make_optimizer([(n, p) for n, p in named
                               if labels[n] == label], lr, **kwargs)
        for label, lr in lrs.items()})
