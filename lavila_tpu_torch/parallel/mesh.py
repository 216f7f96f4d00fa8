"""Data parallelism over processes: the process-group bootstrap, the rank
queries and the collectives of the train steps.

Counterpart of ``lavila_tpu/parallel/mesh.py``. The JAX package lays a
``(data, model)`` mesh over every chip of one SPMD program and lets
GSPMD insert the collectives; the port runs one process per GPU (the
reference's DDP, reference distributed.py:76-102), so its ``data`` axis
is the process group:

  * :func:`init_process_group` joins the group (``nccl`` for CUDA,
    ``gloo`` for the CPU; the backend is an argument, so that two ranks
    can share one card through gloo); :func:`world`, :func:`rank` and
    :func:`local_rank` answer 1, 0 and 0 in a process that never joined
    one, which then runs as a world of one with no collective;
  * :func:`check_mesh_data` is ``create_mesh``'s check of ``--mesh-data``
    (-1: the world size; any other value must equal it);
  * ``shard_batch`` has no counterpart: each rank's loader yields its
    own slice of the global batch (``DataLoader(shard_index=rank(),
    num_shards=world())``) and the rank's tensors are that slice;
  * :func:`all_gather` is differentiable: its forward gathers the ranks'
    tensors along dim 0 and its backward returns this rank's rows of the
    gradient summed over the ranks, so that a loss every rank computes
    alike hands each rank ``world()`` times its share of the global
    gradient; :func:`all_reduce` (a differentiable sum) keeps the same
    convention, and :func:`average_grads`, which divides the summed
    gradients by ``world()``, completes it: every rank's gradient is the
    global batch's;
  * :func:`broadcast_params` sends rank 0's parameters, the loss's
    parameters and the optimizer's state, so that the replicas never
    rest on each device drawing the same initial weights.

The ``(data, model)`` mesh (:func:`init_model_parallel`): at
``--mesh-model`` M the world splits into ``world // M`` model groups of M
consecutive ranks (``create_mesh``'s ``reshape(data, model)``,
``lavila_tpu/parallel/mesh.py:47``), each holding one replica whose wide
layers are sharded over its ranks (``parallel/sharding.py``,
``parallel/tensor.py``), and M data groups, the ranks that hold the same
shard in each replica. The collectives above take a ``group`` and mean
the data group when given none: at ``--mesh-model 1`` that is the world,
exactly as before the model axis existed. :func:`data_rank`,
:func:`data_world`, :func:`model_rank` and :func:`model_world` answer
for the two axes. The optimizer state follows its parameter: whole where
the parameter is replicated, this rank's slice where it is sharded, as
in the JAX package, whose optimizer state follows the parameters'
shardings (its ``use_zero`` is kept only for parity).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from lavila_tpu_torch.parallel.tensor import copy_to, gather_from, reduce_from

# the bytes of one coalesced buffer of :func:`average_grads` and
# :func:`broadcast_params`: a few collectives a step, not one a parameter
BUCKET_BYTES = 1 << 28

_local_rank = 0
# the model axis: its size, and this rank's model and data groups (None
# at a model axis of 1: no model group, the data group is the world)
_model = 1
_model_group = None
_data_group = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    return _local_rank if is_initialized() else 0


def backend_for(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(backend: str, init_method: str, world_size: int,
                       rank: int, local_rank: int | None = None,
                       timeout: float = 1800.0) -> None:
    """Join the group of ``world_size`` processes at ``init_method``
    (``tcp://host:port`` or ``env://``) as ``rank``. ``local_rank`` (by
    default ``rank`` modulo the visible cards) picks the rank's card,
    ``cuda:{local_rank}``; ``timeout`` (seconds) bounds every
    collective."""
    global _local_rank
    n_cards = torch.cuda.device_count()
    _local_rank = (local_rank if local_rank is not None
                   else rank % max(n_cards, 1))
    if n_cards:
        torch.cuda.set_device(_local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def destroy_process_group() -> None:
    global _model, _model_group, _data_group
    _model, _model_group, _data_group = 1, None, None
    if is_initialized():
        dist.destroy_process_group()


def check_mesh_model(model: int) -> int:
    """``--mesh-model``: a positive divisor of the world size, as
    ``create_mesh`` requires of the devices
    (``lavila_tpu/parallel/mesh.py:29-46``). Returns the data-parallel
    size ``world // model``."""
    n = world()
    if model < 1 or n % model:
        raise ValueError(
            f"--mesh-model {model}: the {n} process(es) of the group are "
            f"not divisible by model={model}. Pass a model-axis size that "
            f"divides the process count, or launch a multiple of {model} "
            "processes (python -m lavila_tpu_torch.cli.launch "
            "--num-processes ...)")
    return n // model


def init_model_parallel(model: int) -> None:
    """Split the group into ``world // model`` model groups of
    ``model`` consecutive ranks and ``model`` data groups (every rank
    calls it, with the same ``model``). At ``model`` 1 there is no model
    group and the data group is the world. Raises ``ValueError`` as
    :func:`check_mesh_model`."""
    global _model, _model_group, _data_group
    data = check_mesh_model(model)
    _model, _model_group, _data_group = 1, None, None
    if model == 1 or not is_initialized():
        return
    r = rank()
    # every rank creates every group, in the same order
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        group = dist.new_group(ranks)
        if r in ranks:
            _model_group = group
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        group = dist.new_group(ranks)
        if r in ranks:
            _data_group = group
    _model = model


def world_group():
    """The whole group (torch's ``WORLD``; None outside a group)."""
    return dist.group.WORLD if is_initialized() else None


def model_group():
    """This rank's model group (None at a model axis of 1)."""
    return _model_group


def model_world() -> int:
    return _model


def model_rank() -> int:
    return rank() % _model


def data_world() -> int:
    return world() // _model


def data_rank() -> int:
    return rank() // _model


def rank_device(name: str) -> torch.device:
    """``--device`` as this rank's device: a bare ``cuda`` is the rank's
    card, ``cuda:{local_rank()}``; anything else as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def check_mesh_data(mesh_data: int, mesh_model: int = 1) -> int:
    """``--mesh-data``: -1 means the world size over ``mesh_model``; any
    other value must equal it (``create_mesh``,
    ``lavila_tpu/parallel/mesh.py:37-46``). Returns the data-parallel
    size."""
    n = check_mesh_model(mesh_model)
    if mesh_data not in (-1, n):
        raise ValueError(
            f"--mesh-data {mesh_data} does not match the {world()} "
            f"process(es) of the group at --mesh-model {mesh_model}: the "
            f"data axis is the world size over the model axis; pass "
            f"--mesh-data -1 or {n}, or launch {mesh_data * mesh_model} "
            "processes "
            "(python -m lavila_tpu_torch.cli.launch --num-processes "
            f"{mesh_data * mesh_model} ...)")
    return n


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _group(group):
    """``group`` as torch takes it: the data group where none is
    given."""
    return _data_group if group is None else group


def _world_if_none(group):
    # torch's None is the world; parallel/tensor.py's None is no group
    return dist.group.WORLD if group is None else group


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` (default the data
    group) concatenated along dim 0, in rank order; differentiable (the
    module docstring's convention: the gradient summed over the ranks by
    :func:`tensor.copy_to`, then this rank's rows by
    :func:`tensor.gather_from`). ``x`` itself outside a group."""
    if not is_initialized():
        return x
    group = _world_if_none(_group(group))
    return copy_to(gather_from(x, group, dim=0), group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` (default the data
    group); differentiable, its backward the sum of the ranks'
    gradients. ``x`` itself outside a group."""
    if not is_initialized():
        return x
    group = _world_if_none(_group(group))
    return copy_to(reduce_from(x, group), group)


def _comm_device(t: torch.Tensor) -> torch.device:
    # NCCL moves only tensors on the card (AdamW keeps its step counts on
    # the host)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _buckets(tensors):
    """Runs of consecutive tensors of one dtype and device, each up to
    :data:`BUCKET_BYTES` (a larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def _coalesced(tensors, collective) -> None:
    """``collective`` on each bucket of ``tensors`` (ordered by device and
    dtype, stably) flattened into one buffer, the result copied back in
    place."""
    tensors = sorted(tensors, key=lambda t: (str(t.device), str(t.dtype)))
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket]).to(
            _comm_device(bucket[0]))
        collective(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def average_grads(grads, group=None) -> None:
    """Replace each of ``grads`` by its mean over the ranks of ``group``
    (default the data group), in coalesced buffers. Every rank passes
    the same tensors in the same order. Runs the collectives at a world
    of one too; a no-op outside a group."""
    if not is_initialized():
        return
    group = _group(group)
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced(list(grads), mean)


def _optimizer_tensors(optimizer) -> list:
    """The tensors of an ``Optimizer``'s (or a ``MultiTransform``'s)
    state in a fixed order: each parameter's moments by name, then the
    running mean of ``update_freq`` > 1."""
    opts = getattr(optimizer, "optimizers", {"": optimizer}).values()
    out = []
    for opt in opts:
        for p in opt.params:
            state = opt.inner.state.get(p, {})
            out += [state[k] for k in sorted(state)
                    if isinstance(state[k], torch.Tensor)]
        out += list(opt.mean_grads)
    return out


def broadcast_tensors(tensors, group=None) -> None:
    """Rank 0's of ``tensors`` (of ``group``, default the data group) to
    every rank of it, in place, in coalesced buffers. A no-op outside a
    group."""
    if not is_initialized():
        return
    group = _group(group)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    _coalesced(list(tensors),
               lambda flat: dist.broadcast(flat, src, group=group))


def broadcast_from_first(t: torch.Tensor, group) -> torch.Tensor:
    """The first rank of ``group``'s ``t`` to every rank of it, in place
    (the ranks of a model group agreeing on a decode's tokens); ``t``
    as it is without a group. Returns ``t``."""
    if group is not None:
        dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t


def broadcast_params(state, group=None) -> None:
    """Rank 0's fp32 masters, the loss's parameters and the optimizer's
    state to every rank of ``group`` (default the data group: each model
    rank's shards from the first replica's), a ``train.step.TrainState``
    after it is built or restored, then the masters into the working
    copy. A no-op outside a group."""
    if not is_initialized():
        return
    broadcast_tensors([*(p.detach() for p in state.params.values()),
                       *(p.detach() for p in state.criterion.values()),
                       *_optimizer_tensors(state.optimizer)], group)
    state._copy_masters(frozen=True)

