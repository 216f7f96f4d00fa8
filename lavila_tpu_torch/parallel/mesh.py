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

The optimizer state stays whole on every rank, as in the JAX package at
``--mesh-model 1`` (its ``use_zero`` is kept only for parity). The
tensor-parallel ``model`` axis is not ported (ROADMAP queue 1: tensor
parallelism).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# the bytes of one coalesced buffer of :func:`average_grads` and
# :func:`broadcast_params`: a few collectives a step, not one a parameter
BUCKET_BYTES = 1 << 28

_local_rank = 0


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
    if is_initialized():
        dist.destroy_process_group()


def rank_device(name: str) -> torch.device:
    """``--device`` as this rank's device: a bare ``cuda`` is the rank's
    card, ``cuda:{local_rank()}``; anything else as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def check_mesh_data(mesh_data: int) -> int:
    """``--mesh-data``: -1 means the world size; any other value must
    equal it (``create_mesh``, ``lavila_tpu/parallel/mesh.py:37-46``).
    Returns the data-parallel size."""
    n = world()
    if mesh_data not in (-1, n):
        raise ValueError(
            f"--mesh-data {mesh_data} does not match the {n} process(es) "
            f"of the group: the data axis is the world size; pass "
            f"--mesh-data -1 or {n}, or launch {mesh_data} processes "
            "(python -m lavila_tpu_torch.cli.launch --num-processes "
            f"{mesh_data} ...)")
    return n


def barrier() -> None:
    if is_initialized():
        dist.barrier()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        out = x.new_empty((world() * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        rows = grad.shape[0] // world()
        return grad[rank() * rows:(rank() + 1) * rows]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0, in rank
    order; differentiable (the module docstring's convention). ``x``
    itself outside a group."""
    return _AllGather.apply(x) if is_initialized() else x


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``; differentiable, its backward the
    sum of the ranks' gradients. ``x`` itself outside a group."""
    return _AllReduce.apply(x) if is_initialized() else x


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


def average_grads(grads) -> None:
    """Replace each of ``grads`` by its mean over the ranks, in coalesced
    buffers. Every rank passes the same tensors in the same order. Runs
    the collectives at a world of one too; a no-op outside a group."""
    if not is_initialized():
        return
    n = world()

    def mean(flat):
        dist.all_reduce(flat)
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


def broadcast_params(state) -> None:
    """Rank 0's fp32 masters, the loss's parameters and the optimizer's
    state to every rank of the group (a ``train.step.TrainState`` after
    it is built or restored), then the masters into the working copy.
    A no-op outside a group."""
    if not is_initialized():
        return
    tensors = [*(p.detach() for p in state.params.values()),
               *(p.detach() for p in state.criterion.values()),
               *_optimizer_tensors(state.optimizer)]
    _coalesced(tensors, lambda flat: dist.broadcast(flat, 0))
    state._copy_masters(frozen=True)

