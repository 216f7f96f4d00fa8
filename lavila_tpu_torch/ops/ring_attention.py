"""Ring attention: sequence-parallel attention over a process group.

Counterpart of ``lavila_tpu/ops/ring_attention.py``. Each rank holds a
shard of the sequence; its queries stay, while the key/value shards go
round the ring of the group's ranks, one hop a step, and the partial
results are merged by an online softmax in fp32, so that no rank holds
every key (Liu et al. 2023, blockwise ring attention). The JAX package
rotates the shards with ``ppermute`` inside ``shard_map``; here
:func:`ppermute` is a ``torch.autograd.Function`` over
``dist.batch_isend_irecv`` whose backward sends the gradient the other
way round. The block products are ``torch.matmul`` in fp32, as the JAX
package's are XLA einsums with fp32 results (``_block_attn``): no
kernel of the TPU package runs here.

Over gloo a CUDA tensor travels through host memory (gloo's send and
receive take host tensors); that is the transport, the products stay on
the device. NCCL sends it as it is.

  * :func:`ring_attention`: ``(B, H, L_local, d)`` shards, causal or
    not, differentiable;
  * :func:`divided_time_ring`: the TimeSformer's time phase with the
    frame axis sharded: every patch attends to its position's frames
    plus the CLS key/value, the CLS query to the whole ring. It takes
    the port's CLS-separate layout whole on every rank (as the JAX
    function takes the global tensors), computes this rank's frames and
    returns the whole output, its patches gathered over the ring.
    Wired into ``ops/attention.py``'s time phase by
    :func:`set_ring_group`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lavila_tpu_torch.parallel.tensor import copy_to, gather_from, scatter_to

NEG_INF = torch.finfo(torch.float32).min

# the group whose ranks hold the frame shards of every SpaceTimeTransformer
# time phase, or None (ops/attention.py reads it)
_RING_GROUP = None


def set_ring_group(group) -> None:
    """Run the time phase of every ``SpaceTimeTransformer`` forward over
    the ring of ``group``'s ranks (each of which runs the same forward);
    ``None`` turns it off (``lavila_tpu/ops/attention.py:set_ring_mesh``).
    """
    global _RING_GROUP
    _RING_GROUP = group


def get_ring_group():
    return _RING_GROUP


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places after this one in ``group``."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``x`` sent ``offset`` places along the ring, the tensor from
    ``-offset`` places received."""
    staged = x.contiguous()
    if dist.get_backend(group) == "gloo" and x.is_cuda:
        staged = staged.cpu()  # gloo's send/recv take host tensors
    out = torch.empty_like(staged)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, staged, _peer(group, offset), group),
        dist.P2POp(dist.irecv, out, _peer(group, -offset), group)])
    for req in reqs:
        req.wait()
    return out.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's ``x`` to the next rank of ``group``'s ring (rank i's
    to rank i + 1); differentiable, the gradient sent back."""
    return _PPermute.apply(x, group)


def _block_attn(q, k, v, scale: float, bias=None):
    """Partial attention stats of queries ``q`` ``(R, H, Lq, d)`` over
    one key/value block ``(R, H, Lk, d)``: the unnormalised output
    (fp32), the row max and the row sum of the exponentials."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    # the max is a shift the result does not depend on: no gradient
    m = s.amax(-1, keepdim=True).detach().clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(-1, keepdim=True)


def _combine(acc, m, l, acc2, m2, l2):
    """Merge two online-softmax partial results."""
    mm = torch.maximum(m, m2)
    c1, c2 = torch.exp(m - mm), torch.exp(m2 - mm)
    return acc * c1 + acc2 * c2, mm, l * c1 + l2 * c2


def _empty_stats(q):
    row = q.new_zeros(q.shape[:-1] + (1,), dtype=torch.float32)
    return (torch.zeros_like(q, dtype=torch.float32), row + NEG_INF, row)


def _normalise(acc, l, dtype):
    return (acc / l.clamp_min(1e-30)).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Attention of this rank's queries over every rank's keys: q/k/v
    are the ``(B, H, L_local, d)`` shards of ``group``'s ranks, in rank
    order along the sequence; returns this rank's output shard. With
    ``causal``, global query i attends keys 0..i."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    n, me = dist.get_world_size(group), dist.get_rank(group)
    L = q.shape[2]
    acc, m, l = _empty_stats(q)
    kv = torch.stack([k, v])
    for i in range(n):
        owner = (me - i) % n  # whose shard this rank holds at step i
        bias = None
        if causal:
            qi = me * L + torch.arange(L, device=q.device)[:, None]
            kj = owner * L + torch.arange(L, device=q.device)[None, :]
            bias = torch.where(kj <= qi, 0.0, NEG_INF)
        acc, m, l = _combine(acc, m, l,
                             *_block_attn(q, kv[0], kv[1], scale, bias))
        if i < n - 1:
            kv = ppermute(kv, group)
    return _normalise(acc, l, q.dtype)


class _Shared(torch.autograd.Function):
    """Identity forward on an output every rank computes in full (the
    CLS row after the whole ring); the gradient over the ranks' count
    backward, as the JAX ``pmean`` hands each device its share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def divided_time_ring(cls_q, cls_k, cls_v, qp, kp, vp, group):
    """The time phase of divided attention with the frames sharded over
    ``group``'s ranks (``lavila_tpu/ops/ring_attention.py:
    divided_time_ring``, the semantics of ``ops.attention.
    divided_attention_split(..., 'time')``): every patch attends to the
    frames at its position plus the CLS key/value, the CLS query to
    itself and every patch. Inputs whole and alike on every rank:
    cls_q/cls_k/cls_v ``(B, 1, H, d)``, qp/kp/vp ``(B, F, N, H, d)``,
    F a multiple of the group's size. Returns ``(cls_out, patches_out)``
    whole on every rank; differentiable."""
    B, F, N, H, d = qp.shape
    n = dist.get_world_size(group)
    if F % n:
        raise ValueError(f"num_frames={F} must divide over the ring's {n} "
                         "ranks")
    scale = d ** -0.5
    # replicated inputs: each rank's gradient is its frames' share, summed
    cq, ck, cv = (copy_to(t, group) for t in (cls_q, cls_k, cls_v))
    Fl = F // n
    frames = (Fl,) * n
    # this rank's frames; the gradient of the whole joined over the ring
    qs, ks, vs = (scatter_to(t, group, frames, dim=1) for t in (qp, kp, vp))

    def to_ring(t):  # (B, Fl, N, H, d) → (B·N, H, Fl, d): a row a position
        return t.permute(0, 2, 3, 1, 4).reshape(B * N, H, Fl, d)

    def cls_heads(t):  # (B, 1, H, d) → (B, H, 1, d)
        return t.transpose(1, 2)

    qr = to_ring(qs)
    cqh = cls_heads(cq)
    # the CLS key/value, visible to every temporal group (its own block)
    ckb = cls_heads(ck)[:, None].expand(B, N, H, 1, d).reshape(B * N, H, 1, d)
    cvb = cls_heads(cv)[:, None].expand(B, N, H, 1, d).reshape(B * N, H, 1, d)
    pat = _block_attn(qr, ckb, cvb, scale)
    cls = _block_attn(cqh, cls_heads(ck), cls_heads(cv), scale)
    kv = torch.stack([ks, vs])
    for i in range(n):
        kr, vr = to_ring(kv[0]), to_ring(kv[1])
        pat = _combine(*pat, *_block_attn(qr, kr, vr, scale))
        kl = kv[0].reshape(B, Fl * N, H, d).transpose(1, 2)
        vl = kv[1].reshape(B, Fl * N, H, d).transpose(1, 2)
        cls = _combine(*cls, *_block_attn(cqh, kl, vl, scale))
        if i < n - 1:
            kv = ppermute(kv, group)
    patches = _normalise(pat[0], pat[2], qp.dtype)
    patches = patches.reshape(B, N, H, Fl, d).permute(0, 3, 1, 2, 4)
    cls_out = _normalise(cls[0], cls[2], qp.dtype).transpose(1, 2)
    # the patches joined over the ring, used alike on every rank: each
    # rank's gradient is already whole
    return (_Shared.apply(cls_out, group),
            gather_from(patches, group, frames, dim=1))
