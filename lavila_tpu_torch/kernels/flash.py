"""Flash attention (K7 forward only; K8 forward and backward).

Replaces ``lavila_tpu/ops/pallas/flash_attention.py``: ``flash_attention``
(Pallas body ``_kernel``, K7) and ``fused_attention`` with its custom VJP
(``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``, K8), with the CUDA C++
kernels of ``lavila_tpu_torch/csrc/flash_attention.cu``; its header says
what bounds them on the H100 and how they are laid out. The contract is
the JAX functions', token-major: ``q`` ``(B, Lq, H, d)``, ``k``/``v``
``(B, Lk, H, d)``; key ``j`` is attended by query ``i`` when ``j < Lk``
and, with ``causal``, ``j <= i`` (the Pallas kernels' absolute mask).
Scores, softmax and every sum in fp32; the forward rounds the
unnormalised probabilities ``exp(s - m)`` to v's dtype before P·V and
divides by their sum at the end; the backward recomputes P from the
saved per-row log-sum-exp, takes delta = rowsum(P·dP) over that P (not
the Pallas kernels' rowsum(dO·O): ``csrc/flash_attention.cu``'s header
says why) and rounds dS to k's dtype before dS·K. It does not read the
forward's output.

q/k/v may be views with any row stride (the column blocks of one
``(B, L, 3D)`` in_proj output reshaped to heads), so the attention block
makes no head-major copies; each head's ``d`` values must be contiguous
and the heads adjacent.

:func:`flash_attention` dispatches: when autograd needs it (grad enabled
and an input requires grad), :class:`_FlashAttention` runs K8's forward
(saving the log-sum-exp) and its backward; otherwise K7.
:func:`flash_branch` says which kernels a call takes: bf16 at head_dim
64 on rows that TMA can copy runs the tensor cores ("tc"; the backward
"fused", one launch, up to 128 queries and keys, or "split", dq then
dk/dv, past it), everything else the SIMT kernels ("simt"; fp32 or
bf16, head_dim up to 128; dq then dk/dv). Each direction takes its plain
PyTorch version (:func:`flash_attention_reference`,
:func:`flash_fwd_reference`, :func:`flash_bwd_reference`) only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, a plain int per kernel and branch
# (flash_branch); a caller zeroes them to count one run
launches = {"flash_tc": 0, "flash_simt": 0, "flash_fwd_tc": 0,
            "flash_fwd_simt": 0, "flash_bwd_fused": 0, "flash_dq_split": 0,
            "flash_dkv_split": 0, "flash_dq_simt": 0, "flash_dkv_simt": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128  # the SIMT kernels' limit (four dims a lane)
TC_HEAD_DIM = 64    # the tensor-core kernels' head_dim
FUSED_MAX_LEN = 128  # the fused backward's largest Lq and Lk


def _mask(Lq: int, Lk: int, causal: bool, device) -> torch.Tensor | None:
    """(Lq, Lk) True where query i attends key j; None: every key."""
    if not causal:
        return None
    i = torch.arange(Lq, device=device)[:, None]
    return torch.arange(Lk, device=device)[None, :] <= i


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 scores (B, H, Lq, Lk), masked keys at fp32's lowest value as
    the Pallas kernels mask them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    return s


def _fwd_reference(q, k, v, causal: bool, scale: float | None):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l.clamp_min(1e-30)).transpose(1, 2)
    lse = (m + torch.log(l)).squeeze(-1).transpose(1, 2)
    return out.to(q.dtype), lse.contiguous()


def flash_fwd_reference(q, k, v, causal: bool = False,
                        scale: float | None = None):
    """K8 forward's plain version: ``(out (B, Lq, H, d) in q's dtype,
    lse (B, Lq, H) fp32)``, the Pallas kernel's numerics: fp32 scores
    and row max, ``exp(s - m)`` rounded to v's dtype for P·V, fp32 sums,
    the division by the row sum at the end."""
    return _fwd_reference(q, k, v, causal, scale)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """K7's plain version: the output of :func:`flash_fwd_reference`."""
    return _fwd_reference(q, k, v, causal, scale)[0]


def flash_bwd_reference(q, k, v, do, lse, causal: bool = False,
                        scale: float | None = None):
    """K8 backward's plain version: P recomputed in fp32 from ``lse``,
    dP = dO·Vᵀ in fp32, dS = P·(dP − delta) with delta = rowsum(P·dP),
    dq = dS (rounded to k's dtype)·K·scale, dk = dSᵀ·Q·scale,
    dv = Pᵀ·dO in fp32 (the Pallas kernels' numerics but for delta,
    which they take as rowsum(dO·O)). Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.transpose(1, 2)[..., None].float())
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    g = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q must be (B, Lq, H, d) and k/v (B, Lk, H, d), "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    ts = (q, k, v)
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPES:
        raise TypeError("q/k/v must all be float32 or all bfloat16")
    if any(t.device != q.device for t in ts):
        raise ValueError("q/k/v must be on one device")


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride of a (B, L, H, d) view whose H·d values of a token are
    contiguous and whose rows are evenly spaced; raise otherwise."""
    B, L, H, d = t.shape
    sb, sl, sh, sd = t.stride()
    if d > 1 and sd != 1 or H > 1 and sh != d:
        raise ValueError(f"{name}: the heads of a token must be contiguous "
                         f"(shape {tuple(t.shape)}, stride {t.stride()})")
    rs = sl if L > 1 else sb if B > 1 else H * d
    if B > 1 and L > 1 and sb != L * rs or rs < H * d:
        raise ValueError(f"{name}: rows are not evenly strided or overlap "
                         f"(shape {tuple(t.shape)}, stride {t.stride()})")
    return rs


def _strides(q, k, v) -> list[int]:
    return [_row_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]


def _branch(q, k, strides, tensors, backward: bool) -> str:
    if q.dtype != torch.bfloat16 or q.shape[3] != TC_HEAD_DIM \
            or any(s % 8 for s in strides) \
            or any(t.data_ptr() % 16 for t in tensors):
        return "simt"
    if not backward:
        return "tc"
    return "fused" if max(q.shape[1], k.shape[1]) <= FUSED_MAX_LEN \
        else "split"


def flash_branch(q, k, v, do=None) -> str:
    """The kernels a call takes. Forward (no ``do``): "tc", the TMA
    tensor-core kernel (bf16, head_dim 64, q/k/v rows on 16-byte
    boundaries with row strides of whole 16-byte chunks), else "simt".
    Backward (``do`` given, contiguous; it must sit on a 16-byte boundary
    too): "fused", one tensor-core launch for Lq and Lk up to 128,
    "split" (dq, then dk/dv, on the tensor cores) past it, else "simt"
    (dq, then dk/dv). The C entry points refuse a tensor-core call
    outside these conditions (``tc_fits``, ``fused_fits`` in
    ``csrc/flash_attention.cu``)."""
    tensors = [t for t in (q, k, v, do) if t is not None]
    return _branch(q, k, _strides(q, k, v), tensors, do is not None)


def _tail(q, k, strides) -> list:
    """The launch's arguments after the pointers: shape, row strides."""
    B, Lq, H, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    return [B, H, Lq, k.shape[1], d, *strides]


def _launch(fn, t, *args) -> int:
    """``fn(*args, stream)`` on t's device and its current stream; the
    device is switched only when it is not the current one."""
    if t.device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """K8's forward (``with_lse``: ``(out, lse)``) or K7 (``out``) on the
    tensors' device."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_fwd_reference(q, k, v, causal, scale)
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    strides = _strides(q, k, v)
    tail = _tail(q, k, strides)
    branch = _branch(q, k, strides, (q, k, v), False)
    B, Lq, H, d = q.shape
    out = torch.empty((B, Lq, H, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    flags = [float(scale), int(causal), _DTYPES[q.dtype], int(branch == "tc")]
    if with_lse:
        lse = torch.empty((B, Lq, H), dtype=torch.float32, device=q.device)
        err = _launch(lib.lavila_flash_fwd, q, *ptrs, lse.data_ptr(), *tail,
                      *flags)
    else:
        err = _launch(lib.lavila_flash_attention, q, *ptrs, *tail, *flags)
    name = "flash_fwd" if with_lse else "flash"
    build.check(err, name)
    launches[f"{name}_{branch}"] += 1
    return (out, lse) if with_lse else out


def flash_bwd(q, k, v, do, lse, causal: bool = False,
              scale: float | None = None):
    """K8's backward on the tensors' device: ``(dq, dk, dv)``, contiguous.
    q/k/v as the forward took them; do ``(B, Lq, H, d)`` contiguous in
    the inputs' dtype, lse ``(B, Lq, H)`` fp32 as the forward wrote it.
    On CUDA the branch of :func:`flash_branch`: one launch ("fused"), or
    dq (which also writes delta = rowsum(P·dP)) then dk/dv (which reads
    it)."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Lq, H, d = q.shape
    if do.shape != q.shape or lse.shape != (B, Lq, H):
        raise ValueError(f"do must be {tuple(q.shape)} and lse "
                         f"{(B, Lq, H)}, got {tuple(do.shape)} "
                         f"{tuple(lse.shape)}")
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"do must be {q.dtype} and lse float32, got "
                        f"{do.dtype} {lse.dtype}")
    if any(t.device != q.device for t in (do, lse)):
        raise ValueError("do/lse must be on the inputs' device")
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if not (do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("do/lse must be contiguous")
    strides = _strides(q, k, v)
    tail = _tail(q, k, strides) + [float(scale), int(causal),
                                   _DTYPES[q.dtype]]
    branch = _branch(q, k, strides, (q, k, v, do), True)
    lib = build.library()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=q.device)
              for _ in range(2))
    if branch == "fused":
        err = _launch(lib.lavila_flash_bwd_fused, q, *(t.data_ptr() for t in (
            q, k, v, do, lse, dq, dk, dv)), *tail)
        build.check(err, "flash_bwd_fused")
        launches["flash_bwd_fused"] += 1
        return dq, dk, dv
    tc = int(branch == "split")
    delta = torch.empty_like(lse)
    err = _launch(lib.lavila_flash_bwd_dq, q, *(t.data_ptr() for t in (
        q, k, v, do, lse, delta, dq)), *tail, tc)
    build.check(err, "flash_dq")
    launches[f"flash_dq_{branch}"] += 1
    err = _launch(lib.lavila_flash_bwd_dkv, q, *(t.data_ptr() for t in (
        q, k, v, do, lse, delta, dk, dv)), *tail, tc)
    build.check(err, "flash_dkv")
    launches[f"flash_dkv_{branch}"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K8: the forward with the log-sum-exp and its backward kernels
    (the Pallas custom VJP, which also saves the output)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.attn = (causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        grads = flash_bwd(q, k, v, dout.contiguous(), lse, *ctx.attn)
        return (*grads, None, None)


def flash_attention(q, k, v, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of ``q`` ``(B, Lq, H, d)`` over ``k``/``v`` ``(B, Lk, H,
    d)``, scaled by ``scale`` (default ``d ** -0.5``), with the absolute
    causal mask when ``causal``. Returns ``(B, Lq, H, d)`` in the inputs'
    dtype; differentiable through K8 when autograd needs it, K7
    otherwise."""
    _check(q, k, v)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, with_lse=False)
