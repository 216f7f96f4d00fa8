"""Megatron-style tensor-parallel layers over a model process group.

Counterpart of what GSPMD makes of ``lavila_tpu/parallel/sharding.py``'s
rules: the JAX package annotates each wide kernel with a
``PartitionSpec`` over the ``model`` axis and lets XLA insert the
collectives; here each sharded layer holds only this rank's slice and
runs Megatron's conjugate operators (``torch.autograd.Function``s over
the model group):

  * :func:`copy_to` (identity forward, all-reduce backward) in front of
    a column-parallel layer, whose input every rank holds whole: each
    rank's input gradient is its heads' share, and the all-reduce sums
    the shares;
  * :func:`reduce_from` (all-reduce forward, identity backward) after a
    row-parallel layer, whose output is each rank's partial sum;
  * :func:`gather_from` (all-gather along a dim forward, this rank's
    slice backward) behind a column layer whose consumer reads all its
    outputs (``gather_output``: the attention pooler's single shared K/V
    head, which the pooler then takes through :func:`copy_to`, since
    each rank's query heads read it for their share only);
  * :func:`scatter_to` (this rank's slice along a dim forward,
    all-gather backward) in front of a row layer fed a replicated tensor
    (``input_is_parallel=False``).

The two also serve the other axes: ``parallel/mesh.py``'s
differentiable ``all_gather`` is ``copy_to(gather_from(x, dim=0))``, the
ring attention scatters and gathers the frames (dim 1), and
:func:`all_gather_pieces` joins a checkpoint's shards.

:class:`ColumnParallelLinear` splits ``nn.Linear``'s output rows (weight
``(out, in)`` dim 0, its bias likewise); :class:`RowParallelLinear` its
input columns (dim 1), the bias replicated and added after the
reduction, as JAX's row-parallel bias. Both keep ``weight``/``bias`` as
their parameter names, so a sharded model's state-dict keys are the
whole model's. A split is a :class:`Split`: ``parts`` packed parts
along the dim (q|k|v: 3), each cut into consecutive per-rank pieces of
``sizes`` (whole heads of an attention projection: as even as they go,
13/12 of GPT-2 XL's 25 heads on two ranks).

Every rank of the group computes the same replicated activations, so a
gradient that leaves a sharded layer agrees across the model ranks: no
replicated parameter's gradient is all-reduced again.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class Split:
    """How one tensor is sharded: along ``dim``, each of its ``parts``
    equal packed parts cut into consecutive pieces of ``sizes[r]``
    (rank r's), ``sum(sizes)`` the width of one part."""
    dim: int
    parts: int
    sizes: tuple

    def bounds(self, r: int) -> tuple[int, int]:
        start = sum(self.sizes[:r])
        return start, start + self.sizes[r]

    def take(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s slice of the whole tensor ``t``."""
        lo, hi = self.bounds(r)
        return torch.cat([p.narrow(self.dim, lo, hi - lo)
                          for p in t.chunk(self.parts, self.dim)], self.dim)

    def join(self, pieces: list) -> torch.Tensor:
        """The whole tensor from every rank's slice, in rank order."""
        per_rank = [p.chunk(self.parts, self.dim) for p in pieces]
        return torch.cat([torch.cat([rk[i] for rk in per_rank], self.dim)
                          for i in range(self.parts)], self.dim)


def even_sizes(units: int, n: int, unit: int = 1) -> tuple:
    """``units`` (heads, or features) over ``n`` ranks as evenly as they
    go, the first ranks one more, times ``unit`` (the head width)."""
    return tuple((units // n + (1 if r < units % n else 0)) * unit
                 for r in range(n))


class GroupRef:
    """A process group held by a module: ``copy.deepcopy`` (the bf16
    working copy of ``train.step``) shares it instead of copying it."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def all_gather_pieces(x: torch.Tensor, group, sizes: tuple,
                      dim: int) -> list:
    """Every rank's ``x`` of ``group`` in rank order, rank r's
    ``sizes[r]`` wide along ``dim``: one collective, each piece padded to
    the widest for it."""
    dim %= x.dim()
    x = x.contiguous()
    if x.shape[dim] < max(sizes):
        buf = x.new_zeros(x.shape[:dim] + (max(sizes),) + x.shape[dim + 1:])
        buf.narrow(dim, 0, x.shape[dim]).copy_(x)
        x = buf
    out = x.new_empty((len(sizes) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return [p.narrow(dim, 0, s)
            for p, s in zip(out.chunk(len(sizes)), sizes)]


def _own_slice(x: torch.Tensor, group, sizes: tuple,
               dim: int) -> torch.Tensor:
    r = dist.get_rank(group)
    return x.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, dim):
        sizes = sizes or (x.shape[dim],) * dist.get_world_size(group)
        ctx.group, ctx.sizes, ctx.dim = group, sizes, dim
        return torch.cat(all_gather_pieces(x, group, sizes, dim), dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.group, ctx.sizes, ctx.dim), None, None, \
            None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, dim):
        ctx.group, ctx.sizes, ctx.dim = group, sizes, dim
        return _own_slice(x, group, sizes, dim)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(all_gather_pieces(grad, ctx.group, ctx.sizes,
                                           ctx.dim), ctx.dim), None, None, \
            None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce over ``group`` backward; ``x``
    itself without a group."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward, identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, sizes: tuple | None = None,
                dim: int = -1) -> torch.Tensor:
    """The ranks' slices along ``dim`` (widths ``sizes``, all ``x``'s
    where None) joined forward, this rank's slice of the gradient
    backward: right where every rank's consumer computes the same thing
    from the whole, so that each rank's gradient is already whole; a
    consumer that reads it for this rank's share only (its heads, its
    rows) takes it through :func:`copy_to` first. ``x`` itself without a
    group."""
    return x if group is None else _GatherFrom.apply(x, group, sizes, dim)


def scatter_to(x: torch.Tensor, group, sizes: tuple,
               dim: int = -1) -> torch.Tensor:
    """This rank's slice (of ``sizes``) of ``dim`` forward, the ranks'
    gradients joined backward."""
    return x if group is None else _ScatterTo.apply(x, group, sizes, dim)


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of an ``nn.Linear`` (``split``, dim 0) and
    of its bias. Its input goes through :func:`copy_to`; with
    ``gather_output`` its output through :func:`gather_from` (then the
    split must be one part), whose backward takes this rank's slice of
    the gradient as it arrives: a consumer that reads the output for
    this rank's heads only puts :func:`copy_to` between them."""

    def __init__(self, linear: nn.Linear, split: Split, group,
                 gather_output: bool = False):
        super().__init__()
        self.split, self.gather_output = split, gather_output
        self.tp = GroupRef(group)
        r = dist.get_rank(group)
        self.weight = nn.Parameter(split.take(linear.weight.detach(), r)
                                   .clone())
        self.bias = (None if linear.bias is None else nn.Parameter(
            split.take(linear.bias.detach(), r).clone()))
        self.in_features = linear.in_features
        self.out_features = (linear.out_features if gather_output
                             else self.weight.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.tp.group
        y = F.linear(copy_to(x, group), self.weight, self.bias)
        if self.gather_output:
            y = gather_from(y, group, self.split.sizes)
        return y


class RowParallelLinear(nn.Module):
    """This rank's input columns of an ``nn.Linear`` (``split``, dim 1),
    the bias whole. The partial products are summed by
    :func:`reduce_from`, then the bias is added. Without
    ``input_is_parallel`` the input is replicated and this rank's
    columns of it are taken by :func:`scatter_to`."""

    def __init__(self, linear: nn.Linear, split: Split, group,
                 input_is_parallel: bool = True):
        super().__init__()
        self.split, self.input_is_parallel = split, input_is_parallel
        self.tp = GroupRef(group)
        r = dist.get_rank(group)
        self.weight = nn.Parameter(split.take(linear.weight.detach(), r)
                                   .clone())
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.detach().clone()))
        self.in_features = (self.weight.shape[1] if input_is_parallel
                            else linear.in_features)
        self.out_features = linear.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.tp.group
        if not self.input_is_parallel:
            x = scatter_to(x, group, self.split.sizes)
        y = reduce_from(F.linear(x, self.weight), group)
        return y if self.bias is None else y + self.bias
