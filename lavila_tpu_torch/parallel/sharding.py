"""Parameter sharding rules (tensor parallelism) and the model's swap to
its parallel layers.

Counterpart of ``lavila_tpu/parallel/sharding.py``: Megatron-style
tensor parallelism over the ``model`` group, by parameter name.

  * column-parallel (:data:`_COL_PARALLEL`): the weight split on its
    output dim, the bias split;
  * row-parallel (:data:`_ROW_PARALLEL`): the weight split on its input
    dim, the bias replicated and added after the reduction;
  * everything else replicated: norms, embeddings, convolutions, the
    scalars and the bare projection matrices.

:func:`param_sharding_rules` is the JAX function on the port's names:
the torch dim a parameter is sharded on (a torch weight is ``(out,
in)``, so column-parallel is dim 0 and row-parallel dim 1), or None. The
JAX package shards each matched kernel by contiguous columns and lets
GSPMD reshard around it. Here each rank computes on whole heads, so the
split follows the layout the attention reads:

  * the packed projections (``qkv``, ``in_proj``, GPT-2's ``c_attn``:
    q|k|v; the cross-attention's ``c_attn``: k|v) are split per head
    inside each part, so that ``c_attn(x).chunk(3)`` still gives this
    rank's q, k and v;
  * the heads go over the ranks as evenly as they go (GPT-2 XL's 25:
    13/12 on two ranks, 7/6/6/6 on four), the MLP's hidden features
    likewise;
  * the attention pooler's ``to_kv`` (one K/V head that every query
    head reads) gathers its output (``gather_output``), and the pooler
    takes the gathered K/V through :func:`tensor.copy_to` into its
    head-parallel attention, so that its gradient is summed over the
    ranks' heads before each rank takes its slice;
  * OpenAI's ``MultiheadAttention`` keeps its packed ``in_proj_weight``
    and ``in_proj_bias`` as bare parameters: they are sliced in place
    and the module runs them behind :func:`tensor.copy_to`.

:func:`shard_model` swaps every matched layer for its parallel layer
holding only this rank's slice; :func:`plan` says what it would shard,
and :func:`gather_state_dict`/:func:`shard_state_dict` go between the
rank layout and the whole layout, as do :func:`gather_train_state` and
:func:`shard_train_state` for a ``TrainState.state_dict()`` with its
optimizer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.parallel.tensor import (ColumnParallelLinear, GroupRef,
                                              RowParallelLinear, Split,
                                              all_gather_pieces, even_sizes)

# names of the Linear layers whose weight's output dim is sharded (column
# parallel) vs input dim (row parallel): the JAX package's lists. 'c_attn'
# covers GPT-2's packed qkv and the cross-attention's packed kv.
_COL_PARALLEL = ("qkv", "in_proj", "fc1", "c_fc", "q_lin", "k_lin", "v_lin",
                 "to_q", "to_kv", "q_attn", "c_attn")
_ROW_PARALLEL = ("proj", "out_proj", "fc2", "c_proj", "out_lin", "to_out")

# packed projections: (module class, layer) → parts along the output dim
_PACKED = {("DividedAttentionBlock", "qkv"): 3,
           ("MultiheadAttention", "in_proj"): 3,
           ("SelfAttention", "c_attn"): 3,
           ("CrossAttention", "c_attn"): 2}
# column layers whose consumer reads every output: their output gathered
_GATHERED = {("AttentionPooler", "to_kv")}
# OpenAI's packed in-projection, bare parameters → the JAX module's name
_BARE = {"in_proj_weight": ("in_proj", "weight"),
         "in_proj_bias": ("in_proj", "bias")}


def _layer_and_leaf(name: str) -> tuple[str, str]:
    parts = name.split(".")
    if parts[-1] in _BARE:
        return _BARE[parts[-1]]
    return (parts[-2] if len(parts) >= 2 else ""), parts[-1]


def param_sharding_rules(name: str, shape) -> int | None:
    """The torch dim the parameter ``name`` (of ``shape``) is sharded on
    over the model group, or None where it is replicated
    (``lavila_tpu/parallel/sharding.py:param_sharding_rules``)."""
    layer, leaf = _layer_and_leaf(name)
    if len(shape) < 2 and leaf != "bias":
        return None
    if layer in _COL_PARALLEL:
        if leaf == "weight" and len(shape) == 2:
            return 0
        if leaf == "bias":
            return 0
    if layer in _ROW_PARALLEL and leaf == "weight" and len(shape) == 2:
        return 1
    return None


def _col_split(module: nn.Module, layer: str, width: int, n: int) -> Split:
    """The split of a column layer ``layer`` of ``module`` (``width``
    outputs) over ``n`` ranks."""
    cls = type(module).__name__
    if (cls, layer) in _GATHERED:
        return Split(0, 1, even_sizes(width, n))
    parts = _PACKED.get((cls, layer), 1)
    unit = getattr(module, "head_dim", 1)
    return Split(0, parts, even_sizes(width // parts // unit, n, unit))


def _row_split(module: nn.Module, width: int, n: int) -> Split:
    unit = getattr(module, "head_dim", 1)
    return Split(1, 1, even_sizes(width // unit, n, unit))


def _layers(module: nn.Module, n: int) -> list:
    """The layers of ``module`` that are sharded over ``n`` ranks:
    ``(layer, split, kind)``, kind ``bare`` (OpenAI's packed
    in-projection, bare parameters), ``col``, ``gather`` (a column layer
    whose output is gathered) or ``row``."""
    cls = type(module).__name__
    out = []
    if hasattr(module, "in_proj_weight"):
        out.append(("in_proj", _col_split(module, "in_proj",
                                          module.in_proj_weight.shape[0], n),
                    "bare"))
    for layer, child in module.named_children():
        if not isinstance(child, nn.Linear):
            continue
        if layer in _COL_PARALLEL:
            out.append((layer, _col_split(module, layer, child.out_features,
                                          n),
                        "gather" if (cls, layer) in _GATHERED else "col"))
        elif layer in _ROW_PARALLEL:
            out.append((layer, _row_split(module, child.in_features, n),
                        "row"))
    return out


def plan(model: nn.Module, n: int) -> dict[str, Split]:
    """What :func:`shard_model` shards over ``n`` ranks: each sharded
    parameter's name and :class:`Split`."""
    out = {}
    for prefix, module in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        for layer, split, kind in _layers(module, n):
            if kind == "bare":
                out[pre + "in_proj_weight"] = out[pre + "in_proj_bias"] = split
                continue
            out[f"{pre}{layer}.weight"] = split
            if kind != "row" and getattr(module, layer).bias is not None:
                out[f"{pre}{layer}.bias"] = split
    return out


def shard_model(model: nn.Module, group=None) -> nn.Module:
    """Swap each matched layer of ``model`` (whole, the same weights on
    every rank of ``group``, default the model group) for its parallel
    layer holding this rank's slice, in place; returns ``model``. Every
    sharded parameter carries its :class:`Split` as ``tp_split``
    (:func:`layout`). A no-op without a group."""
    group = mesh.model_group() if group is None else group
    if group is None:
        return model
    n, r = dist.get_world_size(group), dist.get_rank(group)
    for _, module in list(model.named_modules()):
        layers = _layers(module, n)
        # a row layer reads its column layers' local heads, else a
        # replicated input it slices
        parallel_in = any(kind in ("bare", "col") for _, _, kind in layers)
        for layer, split, kind in layers:
            if kind == "bare":
                with torch.no_grad():
                    for name in ("in_proj_weight", "in_proj_bias"):
                        p = nn.Parameter(split.take(getattr(module, name),
                                                    r).clone())
                        p.tp_split = split
                        setattr(module, name, p)
                module.tp = GroupRef(group)
                continue
            child = getattr(module, layer)
            if kind == "gather":
                # its consumer reads the whole output for this rank's
                # heads: the module takes it through copy_to
                module.tp = GroupRef(group)
            if kind == "row":
                new = RowParallelLinear(child, split, group,
                                        input_is_parallel=parallel_in)
            else:
                new = ColumnParallelLinear(child, split, group,
                                           gather_output=kind == "gather")
                if new.bias is not None:
                    new.bias.tp_split = split
            new.weight.tp_split = split
            setattr(module, layer, new)
    return model


def layout(params: dict) -> dict[str, Split]:
    """The sharded ones of ``params`` (name → parameter; a sharded
    model's, or a ``TrainState``'s masters) and their splits."""
    return {n: p.tp_split for n, p in params.items()
            if getattr(p, "tp_split", None) is not None}


def _gather(t: torch.Tensor, split: Split, group) -> torch.Tensor:
    """The whole tensor from every rank's slice ``t`` of it."""
    return split.join(all_gather_pieces(
        t, group, tuple(s * split.parts for s in split.sizes), split.dim))


@torch.no_grad()
def gather_state_dict(sd: dict, splits: dict[str, Split],
                      group=None) -> dict:
    """The whole layout of a rank's state dict ``sd``: each of
    ``splits`` gathered over ``group`` (default the model group, every
    rank of which calls this), the rest as it is."""
    group = mesh.model_group() if group is None else group
    return {k: _gather(v, splits[k], group) if k in splits else v
            for k, v in sd.items()}


@torch.no_grad()
def shard_state_dict(sd: dict, splits: dict[str, Split], rank: int) -> dict:
    """Rank ``rank``'s layout of the whole state dict ``sd``."""
    return {k: splits[k].take(v, rank).clone() if k in splits else v
            for k, v in sd.items()}


def _map_optimizer(tree: dict, state, fn) -> dict:
    """``fn(tensor, name)`` over every tensor of a ``TrainState``
    checkpoint that follows a parameter: the masters, the optimizer's
    per-parameter state (its moments) and the running mean of
    ``update_freq`` > 1; the rest as it is."""
    out = dict(tree)
    out["state_dict"] = {k: fn(v, k) for k, v in tree["state_dict"].items()}
    opts = getattr(state.optimizer, "optimizers", None)
    for label, opt in (opts.items() if opts else [(None, state.optimizer)]):
        sub = dict(tree[label] if label is not None else out)
        names = opt.index_names
        inner = dict(sub["optimizer"])
        inner["state"] = {i: {k: fn(v, names[i]) if isinstance(
            v, torch.Tensor) and v.dim() > 0 else v for k, v in st.items()}
            for i, st in inner["state"].items()}
        sub["optimizer"] = inner
        if "accumulate" in sub:
            acc = dict(sub["accumulate"])
            acc["mean_grads"] = [fn(v, n) for v, n in zip(
                acc["mean_grads"], opt.names)]
            sub["accumulate"] = acc
        if label is None:
            out.update(sub)
        else:
            out[label] = sub
    return out


@torch.no_grad()
def gather_train_state(tree: dict, state, group=None) -> dict:
    """A ``TrainState.state_dict()`` of a sharded model in the whole
    layout: the sharded masters, their optimizer moments and running
    means gathered over ``group`` (default the model group; every rank
    of it calls this). ``tree`` itself outside tensor parallelism."""
    group = mesh.model_group() if group is None else group
    splits = layout(state.params)
    if group is None or not splits:
        return tree
    return _map_optimizer(tree, state, lambda v, n: _gather(
        v, splits[n], group) if n in splits else v)


@torch.no_grad()
def shard_train_state(tree: dict, state, rank: int | None = None) -> dict:
    """A whole-layout ``TrainState`` checkpoint as this model rank's
    (``rank``, default :func:`mesh.model_rank`) slices of
    ``state``'s sharded model; ``tree`` itself where nothing is
    sharded."""
    splits = layout(state.params)
    if not splits:
        return tree
    r = mesh.model_rank() if rank is None else rank
    return _map_optimizer(tree, state, lambda v, n: splits[n].take(
        v, r).clone() if n in splits else v)
