"""The CLS token's global attention row of divided space-time attention,
forward and backward.

Every phase of every TimeSformer block attends the CLS query over
``[cls; all F·N patches]``
(``ops/attention.py:divided_attention_split``). The JAX package writes
that row in XLA ops, not Pallas
(``lavila_tpu/ops/attention.py:_cls_row_attention``, a custom VJP), so
these kernels replace no TPU kernel: they were added because the plain
PyTorch row made fp32 copies of the strided k/v row views, ran batched
GEMVs on them and wrote fp32 gradients of the patches' size, ~10x the
bytes the row needs. ``csrc/cls_row.cu`` reads each row once in the
input dtype (its header says how).

:func:`cls_row` calls the operator ``lavila::cls_row``
(``torch.library.custom_op``), whose autograd formula is the backward
kernel. The forward returns ``(out, lse, o)``: ``o`` is the output in
fp32, ``(B, H, d)``, which the backward's delta = rowsum(g·o) reads, as
autograd of the plain version takes it. The backward saves ``(cls_q,
cls_k, cls_v, kp, vp, lse, o)``: kp/vp are the row views the divided
phase keeps too, so no memory of the patches' size is added. Each
direction takes its plain PyTorch version (:func:`cls_row_fwd_reference`,
:func:`cls_row_bwd_reference`) only for CPU tensors; on a CUDA tensor it
launches the kernels or raises.
"""

from __future__ import annotations

import functools

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, one a call of each direction (the
# kernel and its combine pass); a caller zeroes them to count one run
launches = {"cls_row_fwd": 0, "cls_row_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPLITS = 256  # csrc/cls_row.cu: kMaxSplits
_BLOCKS_AN_SM = 4  # the splits fill each SM this many blocks over
_MIN_ROWS = 32     # rows a split walks at least


def cls_row_fwd_reference(cls_q, cls_k, cls_v, kp, vp):
    """Plain PyTorch forward: scores and softmax in fp32 over
    ``[cls; patches]``. Returns ``(out (B, 1, H, d) in the input dtype,
    lse (B, H) fp32, o (B, H, d) fp32)``."""
    B, F, N, H, d = kp.shape
    scale = d ** -0.5
    q = cls_q[:, 0].float() * scale                          # (B, H, d)
    s_self = (q * cls_k[:, 0].float()).sum(-1)               # (B, H)
    s_pat = torch.einsum("bhd,bfnhd->bhfn", q, kp.float())
    scores = torch.cat([s_self[..., None], s_pat.reshape(B, H, F * N)], -1)
    p = torch.softmax(scores, dim=-1)                        # (B, H, 1+FN)
    out = p[..., 0, None] * cls_v[:, 0].float()
    out = out + torch.einsum("bhl,blhd->bhd", p[..., 1:],
                             vp.reshape(B, F * N, H, d).float())
    # a copy in fp32 too: the operator's outputs may not alias each other
    return (out[:, None].to(kp.dtype, copy=True),
            torch.logsumexp(scores, -1), out)


def cls_row_attention_reference(cls_q, cls_k, cls_v, kp, vp):
    """The plain CLS row, differentiable through autograd: ``(B, 1, H,
    d)`` in the input dtype, as :func:`cls_row` returns it (the version
    ``chip_smoke.py``'s plain path and the kernels' tests compare with)."""
    return cls_row_fwd_reference(cls_q, cls_k, cls_v, kp, vp)[0]


def cls_row_bwd_reference(cls_q, cls_k, cls_v, kp, vp, g, lse, o):
    """Plain PyTorch backward with the kernel's signature, in fp32: the
    probabilities from the saved ``lse``, delta = rowsum(g·o). Returns
    ``(dcls_q, dcls_k, dcls_v)`` as ``(B, 1, H, d)`` and ``(dkp, dvp)`` as
    ``(B, F, N, H, d)``, in the input dtype."""
    B, F, N, H, d = kp.shape
    dt = kp.dtype
    scale = d ** -0.5
    q = cls_q[:, 0].float() * scale                          # (B, H, d)
    k0, v0 = cls_k[:, 0].float(), cls_v[:, 0].float()
    k, v = kp.float(), vp.float()
    g = g[:, 0].float()
    delta = (g * o).sum(-1)                                  # (B, H)
    p0 = torch.exp((q * k0).sum(-1) - lse)
    ds0 = p0 * ((g * v0).sum(-1) - delta)
    p = torch.exp(torch.einsum("bhd,bfnhd->bfnh", q, k) - lse[:, None, None])
    ds = p * (torch.einsum("bhd,bfnhd->bfnh", g, v) - delta[:, None, None])
    dq = ds0[..., None] * k0 + torch.einsum("bfnh,bfnhd->bhd", ds, k)
    dkp = ds[..., None] * q[:, None, None]
    dvp = p[..., None] * g[:, None, None]
    return ((dq * scale)[:, None].to(dt), (ds0[..., None] * q)[:, None].to(dt),
            (p0[..., None] * g)[:, None].to(dt), dkp.to(dt), dvp.to(dt))


def _check(cls_q, cls_k, cls_v, kp, vp):
    if kp.dim() != 5 or vp.shape != kp.shape:
        raise ValueError(f"kp/vp must share one (B, F, N, H, d) shape, got "
                         f"{tuple(kp.shape)} {tuple(vp.shape)}")
    B, F, N, H, d = kp.shape
    for name, t in (("cls_q", cls_q), ("cls_k", cls_k), ("cls_v", cls_v)):
        if t.shape != (B, 1, H, d):
            raise ValueError(f"{name} must be {(B, 1, H, d)}, got "
                             f"{tuple(t.shape)}")
    ts = (cls_q, cls_k, cls_v, kp, vp)
    if any(t.dtype != kp.dtype for t in ts) or kp.dtype not in _DTYPES:
        raise TypeError("cls_q/cls_k/cls_v/kp/vp must all be float32 or all "
                        "bfloat16")
    if any(t.device != kp.device for t in ts):
        raise ValueError("cls_q/cls_k/cls_v/kp/vp must be on one device")


def _rows(cls_q, cls_k, cls_v, kp, vp) -> list[int]:
    """The batch strides of the CLS rows and the row strides of the
    patches, in elements; raises where a tensor is not rows of H·d
    contiguous elements, evenly strided."""
    return [build.row_stride(t, n, row_dims=2) for t, n in (
        (cls_q, "cls_q"), (cls_k, "cls_k"), (cls_v, "cls_v"), (kp, "kp"),
        (vp, "vp"))]


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(B: int, L: int, device: torch.device) -> int:
    """The key splits of a call: as many blocks as fit in one wave of
    ``_BLOCKS_AN_SM`` a SM (a block more would start a second wave), each
    split at least ``_MIN_ROWS`` rows."""
    want = _BLOCKS_AN_SM * _sms(device.index or 0) // B
    return max(1, min(want, -(-L // _MIN_ROWS), _MAX_SPLITS))


def _check_head_dim(d: int) -> None:
    if d % 8 or d > 128:
        raise ValueError(f"the CLS row kernels take head_dim a multiple of 8 "
                         f"up to 128, got {d}")


def _cls_row_fwd(cls_q, cls_k, cls_v, kp, vp):
    """Forward on the tensors' device: (out, lse, o)."""
    if kp.device.type == "cpu":
        return cls_row_fwd_reference(cls_q, cls_k, cls_v, kp, vp)
    if kp.device.type != "cuda":
        raise ValueError(f"no CLS row kernel for {kp.device}")
    B, F, N, H, d = kp.shape
    _check_head_dim(d)
    rs = _rows(cls_q, cls_k, cls_v, kp, vp)
    dev = kp.device
    L, S = F * N, splits(B, F * N, dev)
    out = torch.empty((B, 1, H, d), dtype=kp.dtype, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    o = torch.empty((B, H, d), dtype=torch.float32, device=dev)
    part = torch.empty((B, S, H, d + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().lavila_cls_row_fwd(
            *(t.data_ptr() for t in (cls_q, cls_k, cls_v, kp, vp, out, lse,
                                     o, part)),
            B, L, H, d, S, *rs, float(d ** -0.5), _DTYPES[kp.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "cls_row_fwd")
    launches["cls_row_fwd"] += 1
    return out, lse, o


def cls_row_bwd(cls_q, cls_k, cls_v, kp, vp, g, lse, o):
    """Backward on the tensors' device: ``(dcls_q, dcls_k, dcls_v, dkp,
    dvp)``. The inputs as the forward took them; ``g`` the output's
    gradient ``(B, 1, H, d)`` in their dtype, lse and o fp32 as the
    forward wrote them."""
    _check(cls_q, cls_k, cls_v, kp, vp)
    B, F, N, H, d = kp.shape
    if g.shape != (B, 1, H, d) or lse.shape != (B, H) \
            or o.shape != (B, H, d):
        raise ValueError(f"g must be {(B, 1, H, d)}, lse {(B, H)} and o "
                         f"{(B, H, d)}, got {tuple(g.shape)} "
                         f"{tuple(lse.shape)} {tuple(o.shape)}")
    if g.dtype != kp.dtype or lse.dtype != torch.float32 \
            or o.dtype != torch.float32:
        raise TypeError(f"g must be {kp.dtype} and lse/o float32, got "
                        f"{g.dtype} {lse.dtype} {o.dtype}")
    if kp.device.type == "cpu":
        return cls_row_bwd_reference(cls_q, cls_k, cls_v, kp, vp, g, lse, o)
    if kp.device.type != "cuda":
        raise ValueError(f"no CLS row kernel for {kp.device}")
    _check_head_dim(d)
    rs = _rows(cls_q, cls_k, cls_v, kp, vp)
    g, lse, o = g.contiguous(), lse.contiguous(), o.contiguous()
    dev = kp.device
    L, S = F * N, splits(B, F * N, dev)
    dkp, dvp = (torch.empty(kp.shape, dtype=kp.dtype, device=dev)
                for _ in range(2))
    dcls = [torch.empty((B, 1, H, d), dtype=kp.dtype, device=dev)
            for _ in range(3)]
    part = torch.empty((B, S, H, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().lavila_cls_row_bwd(
            *(t.data_ptr() for t in (cls_q, cls_k, cls_v, kp, vp, g, o, lse,
                                     dkp, dvp, *dcls, part)),
            B, L, H, d, S, *rs, float(d ** -0.5), _DTYPES[kp.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "cls_row_bwd")
    launches["cls_row_bwd"] += 1
    return (*dcls, dkp, dvp)


@torch.library.custom_op("lavila::cls_row", mutates_args=())
def cls_row_op(cls_q: torch.Tensor, cls_k: torch.Tensor, cls_v: torch.Tensor,
               kp: torch.Tensor, vp: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CLS row as an operator: the kernels, or their plain version on
    a CPU tensor."""
    return _cls_row_fwd(cls_q, cls_k, cls_v, kp, vp)


@cls_row_op.register_fake
def _cls_row_fake(cls_q, cls_k, cls_v, kp, vp):
    B, F, N, H, d = kp.shape
    f32 = torch.float32
    return (kp.new_empty((B, 1, H, d)), kp.new_empty((B, H), dtype=f32),
            kp.new_empty((B, H, d), dtype=f32))


def _cls_row_setup(ctx, inputs, output):
    _, lse, o = output
    ctx.save_for_backward(*inputs, lse, o)
    ctx.mark_non_differentiable(lse, o)


def _cls_row_backward(ctx, dout, _dlse, _do):
    *inputs, lse, o = ctx.saved_tensors  # unpacked once, as remat requires
    return cls_row_bwd(*inputs, dout, lse, o)


cls_row_op.register_autograd(_cls_row_backward, setup_context=_cls_row_setup)


def cls_row(cls_q, cls_k, cls_v, kp, vp):
    """The CLS query over ``[cls; all patches]``.

    cls_q/cls_k/cls_v: ``(B, 1, H, d)``; kp/vp: ``(B, F, N, H, d)``, row
    views with any row stride. Returns ``(B, 1, H, d)`` in the input
    dtype; differentiable in all five through the backward kernel."""
    _check(cls_q, cls_k, cls_v, kp, vp)
    return cls_row_op(cls_q, cls_k, cls_v, kp, vp)[0]
