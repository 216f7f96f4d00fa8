"""LayerNorm (K3) and the fused add + LayerNorm (K4, K5), forward and
backward, Triton kernels.

Replaces ``lavila_tpu/ops/pallas/layernorm.py``: ``fused_layernorm``
(K3), ``fused_add_layernorm`` (K4: ``(LN(a + b), a + b)``) and
``fused_add_layernorm_nosum`` (K5: ``LN(a + b)``, the sum never stored),
with their custom VJPs (Pallas bodies ``_fwd_kernel`` and
``_bwd_kernel``, whose ``two_inputs``/``emit_sum``/``has_dsum`` flags
become the kernels' constexpr flags here). Each is a per-row reduction
around an elementwise pass, fused with the residual add for K4/K5: the
case Triton is allowed for in this port. On the H100 each is bound by
device memory.

* Forward: one program per row holds the whole row in registers (D in
  {512, 768, 1024, 1600} masked to a power-of-two block), takes fp32
  statistics with the one-pass variance ``max(E[x²] − E[x]², 0)`` of
  ``lavila_tpu/ops/basic.py:150-153``, and writes y in the input dtype.
  K3 reads x and writes y, 2·R·D·itemsize bytes (19.3 MB for the TSF-B
  tower's (8·4·196, 768) bf16 rows). K4/K5 read a and b and normalise
  their fp32 sum x = a + b (not the sum rounded to the dtype, as the
  Pallas kernel does); K4 also writes the sum rounded to the dtype, the
  residual carry: 4·R·D·itemsize bytes for K4, 3 for K5. No statistics
  land in device memory.
* Backward: the statistics are recomputed from x in fp32 (nothing was
  saved), then ``dx = rstd·(g − mean(g) − x̂·mean(g·x̂))`` with g = dy·γ.
  K3 reads x; K4 reads its saved sum and adds the sum's own gradient
  d(sum) into dx; K5 re-adds a + b in fp32. K4/K5 return the same dx for
  a and b. dγ = Σ dy·x̂ and dβ = Σ dy are sums over every row: blocks run
  in no order on the card, so each program walks a fixed run of rows and
  writes fp32 partials, and a second kernel adds the partials in a fixed
  order, 64 partials x 64 columns per step. No atomics, so two calls give
  the same bits.

When autograd needs it, :func:`layer_norm` runs through
:class:`_LayerNorm` (saves x and γ) and :func:`add_layer_norm` through
:class:`_AddLayerNorm` (K4: saves the sum; K5: saves a and b). Each
direction takes its plain PyTorch version (:func:`layer_norm_reference`,
:func:`add_layer_norm_reference`, :func:`layer_norm_bwd_reference`,
:func:`add_layer_norm_bwd_reference`) only for CPU tensors; on a CUDA
tensor it launches the kernel or raises. ``triton`` is imported when a
kernel is first launched, so the module imports where triton is absent.
"""

from __future__ import annotations

import functools

import torch

# kernel launches in this process, a plain int per kernel; a caller
# zeroes them to count one run
launches = {"layernorm": 0, "layernorm_bwd": 0, "add_layernorm": 0,
            "add_layernorm_bwd": 0, "add_layernorm_nosum": 0,
            "add_layernorm_nosum_bwd": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def _normalise32(x32, weight, bias, eps: float):
    """LN of fp32 rows with one-pass statistics, in fp32."""
    mean = x32.mean(dim=-1, keepdim=True)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    var = (ms - mean * mean).clamp_min(0.0)
    return (x32 - mean) * torch.rsqrt(var + eps) * weight.float() \
        + bias.float()


def layer_norm_reference(x, weight, bias, eps: float):
    """Plain PyTorch LayerNorm over the last axis with fp32 one-pass
    statistics; the output takes the input dtype."""
    return _normalise32(x.float(), weight, bias, eps).to(x.dtype)


def add_layer_norm_reference(a, b, weight, bias, eps: float,
                             return_sum: bool = True):
    """Plain K4 (``return_sum``: ``(LN(a + b), a + b)``) or K5
    (``LN(a + b)``): the sum taken and normalised in fp32, as the Pallas
    kernel does (the XLA path rounds it first); y and the sum in a's
    dtype."""
    x32 = a.float() + b.float()
    y = _normalise32(x32, weight, bias, eps).to(a.dtype)
    return (y, x32.to(a.dtype)) if return_sum else y


def _bwd32(x32, weight, dy, eps: float):
    """fp32 ``(dx, dweight, dbias)`` of LN at fp32 rows ``x32``: one-pass
    statistics recomputed from x (``lavila_tpu/ops/pallas/layernorm.py:
    56-61``)."""
    mean = x32.mean(dim=-1, keepdim=True)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((ms - mean * mean).clamp_min(0.0) + eps)
    xhat = (x32 - mean) * rstd
    dy32 = dy.float()
    g = dy32 * weight.float()
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    D = x32.shape[-1]
    return dx, (dy32 * xhat).reshape(-1, D).sum(0), dy32.reshape(-1, D).sum(0)


def layer_norm_bwd_reference(x, weight, dy, eps: float):
    """Plain K3 backward. Returns ``(dx, dweight, dbias)``: dx in x's
    dtype, dweight/dbias in weight's."""
    dx, dw, db = _bwd32(x.float(), weight, dy, eps)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def add_layer_norm_bwd_reference(x, residual, weight, dy, dsum, eps: float):
    """Plain K4/K5 backward, the dx that both summands receive. K4: ``x``
    the saved sum, ``residual`` None, ``dsum`` the sum's gradient, added
    to dx in fp32. K5: ``x`` and ``residual`` the pair, re-added in fp32,
    ``dsum`` None. Returns ``(dx, dweight, dbias)`` as
    :func:`layer_norm_bwd_reference`."""
    x32 = x.float() if residual is None else x.float() + residual.float()
    dx, dw, db = _bwd32(x32, weight, dy, eps)
    if dsum is not None:
        dx = dx + dsum.float()
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


@functools.cache
def _kernel():
    # the kernel body resolves ``tl`` among this module's globals
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(x_ptr, r_ptr, w_ptr, b_ptr, y_ptr, s_ptr, D, eps,
               BLOCK_D: tl.constexpr, HAS_RESIDUAL: tl.constexpr,
               EMIT_SUM: tl.constexpr):
        # K3: y = LN(x); K5: y = LN(x + r); K4: also s = x + r
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
        x = x.to(tl.float32)
        if HAS_RESIDUAL:
            r = tl.load(r_ptr + row * D + cols, mask=mask, other=0.0)
            x += r.to(tl.float32)
        if EMIT_SUM:
            tl.store(s_ptr + row * D + cols, x.to(s_ptr.dtype.element_ty),
                     mask=mask)
        mean = tl.sum(x, axis=0) / D
        ms = tl.sum(x * x, axis=0) / D
        var = tl.maximum(ms - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean) * rstd * w + b
        tl.store(y_ptr + row * D + cols, y.to(y_ptr.dtype.element_ty),
                 mask=mask)

    return ln_fwd


@functools.cache
def _bwd_kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_bwd(x_ptr, r_ptr, w_ptr, dy_ptr, dsum_ptr, dx_ptr, dw_part_ptr,
               db_part_ptr, R, D, rows_per_program, eps,
               BLOCK_D: tl.constexpr, HAS_RESIDUAL: tl.constexpr,
               HAS_DSUM: tl.constexpr):
        # K3: x read; K5: x + r re-added; K4: x the saved sum, its
        # gradient dsum folded into dx
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK_D], dtype=tl.float32)
        db = tl.zeros([BLOCK_D], dtype=tl.float32)
        first = pid * rows_per_program
        last = tl.minimum(first + rows_per_program, R)
        for row in range(first, last):
            off = row.to(tl.int64) * D
            x = tl.load(x_ptr + off + cols, mask=mask, other=0.0)
            x = x.to(tl.float32)
            if HAS_RESIDUAL:
                r = tl.load(r_ptr + off + cols, mask=mask, other=0.0)
                x += r.to(tl.float32)
            dy = tl.load(dy_ptr + off + cols, mask=mask, other=0.0)
            dy = dy.to(tl.float32)
            mean = tl.sum(x, axis=0) / D
            ms = tl.sum(x * x, axis=0) / D
            rstd = 1.0 / tl.sqrt(tl.maximum(ms - mean * mean, 0.0) + eps)
            xhat = tl.where(mask, (x - mean) * rstd, 0.0)
            g = dy * w
            gm = tl.sum(g, axis=0) / D
            gxm = tl.sum(g * xhat, axis=0) / D
            dx = rstd * (g - gm - xhat * gxm)
            if HAS_DSUM:
                ds = tl.load(dsum_ptr + off + cols, mask=mask, other=0.0)
                dx += ds.to(tl.float32)
            tl.store(dx_ptr + off + cols, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)
            dw += dy * xhat
            db += dy
        tl.store(dw_part_ptr + pid * D + cols, dw, mask=mask)
        tl.store(db_part_ptr + pid * D + cols, db, mask=mask)

    @triton.jit
    def ln_bwd_sum(dw_part_ptr, db_part_ptr, dw_ptr, db_ptr, P, D,
                   BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # (BLOCK_P partials x BLOCK_C columns) tiles, each reduced over
        # its rows in a fixed order: deterministic, and P / BLOCK_P
        # dependent steps instead of P
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < D
        dw = tl.zeros([BLOCK_C], dtype=tl.float32)
        db = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, P, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            mask = (rows < P)[:, None] & cmask[None, :]
            off = rows[:, None] * D + cols[None, :]
            dw += tl.sum(tl.load(dw_part_ptr + off, mask=mask, other=0.0), 0)
            db += tl.sum(tl.load(db_part_ptr + off, mask=mask, other=0.0), 0)
        tl.store(dw_ptr + cols, dw.to(dw_ptr.dtype.element_ty), mask=cmask)
        tl.store(db_ptr + cols, db.to(db_ptr.dtype.element_ty), mask=cmask)

    return ln_bwd, ln_bwd_sum


def _check_kernel_inputs(*ts):
    x = ts[0]
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm kernel for {x.device}")
    if any(t.dtype not in _DTYPES for t in ts):
        raise TypeError(f"LayerNorm kernel takes float32/bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("LayerNorm tensors must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("LayerNorm kernel takes contiguous tensors")


def _check_pair(x, residual):
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(f"the summands must share shape and dtype, got "
                         f"{tuple(x.shape)} {x.dtype} and "
                         f"{tuple(residual.shape)} {residual.dtype}")


@functools.cache
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _block(D: int) -> int:
    return 1 << (D - 1).bit_length()  # D masked to a power of two


def _fwd(x, residual, weight, bias, eps, emit_sum: bool, counter: str):
    """The forward kernel on CUDA tensors: y, and the sum when
    ``emit_sum``."""
    ts = (x, weight, bias) if residual is None else (x, residual, weight,
                                                     bias)
    _check_kernel_inputs(*ts)
    D = x.shape[-1]
    y = torch.empty_like(x)
    s = torch.empty_like(x) if emit_sum else y
    rows = x.numel() // D
    if rows:
        block = _block(D)
        with torch.cuda.device(x.device):
            _kernel()[(rows,)](
                x, x if residual is None else residual, weight, bias, y, s,
                D, eps, BLOCK_D=block, HAS_RESIDUAL=residual is not None,
                EMIT_SUM=emit_sum, num_warps=4 if block <= 1024 else 8)
        launches[counter] += 1
    return (y, s) if emit_sum else y


def _bwd(x, residual, weight, dy, dsum, eps, counter: str):
    """The backward kernels on CUDA tensors: ``(dx, dweight, dbias)``."""
    ts = [x, weight, dy] + [t for t in (residual, dsum) if t is not None]
    _check_kernel_inputs(*ts)
    D = x.shape[-1]
    rows = x.numel() // D
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    # a few programs per SM, each over a fixed run of rows
    sms = _sm_count(x.device.index)
    per = -(-rows // min(rows, 4 * sms))
    programs = -(-rows // per)
    parts = torch.empty((2, programs, D), dtype=torch.float32,
                        device=x.device)
    ln_bwd, ln_bwd_sum = _bwd_kernels()
    block = _block(D)
    with torch.cuda.device(x.device):
        ln_bwd[(programs,)](
            x, x if residual is None else residual, weight, dy,
            dy if dsum is None else dsum, dx, parts[0], parts[1], rows, D,
            per, eps, BLOCK_D=block, HAS_RESIDUAL=residual is not None,
            HAS_DSUM=dsum is not None, num_warps=4 if block <= 1024 else 8)
        ln_bwd_sum[(-(-D // 64),)](parts[0], parts[1], dw, db, programs, D,
                                   BLOCK_P=64, BLOCK_C=64, num_warps=4)
    launches[counter] += 1
    return dx, dw, db


def _check_weight(x, weight, *others):
    D = x.shape[-1]
    if weight.shape != (D,) or any(t.shape != x.shape for t in others):
        raise ValueError(f"weight must be ({D},) and dy {tuple(x.shape)}, "
                         f"got {tuple(weight.shape)} "
                         f"{[tuple(t.shape) for t in others]}")


def layer_norm_bwd(x, weight, dy, eps: float):
    """K3 backward on the tensors' device: ``(dx, dweight, dbias)``, dx in
    x's dtype and dweight/dbias in weight's."""
    _check_weight(x, weight, dy)
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, weight, dy, eps)
    return _bwd(x, None, weight, dy, None, eps, "layernorm_bwd")


def add_layer_norm_bwd(x, residual, weight, dy, dsum, eps: float):
    """K4 backward (``residual`` None: ``x`` the saved sum, ``dsum`` its
    gradient) or K5 backward (``x``, ``residual`` the pair, ``dsum``
    None) on the tensors' device: ``(dx, dweight, dbias)``, dx the
    gradient of each summand."""
    _check_weight(x, weight, dy, *(t for t in (residual, dsum)
                                   if t is not None))
    if (residual is None) == (dsum is None):
        raise ValueError("pass the saved sum with dsum (K4) or the pair "
                         "without it (K5)")
    if x.device.type == "cpu":
        return add_layer_norm_bwd_reference(x, residual, weight, dy, dsum,
                                            eps)
    counter = ("add_layernorm_bwd" if residual is None
               else "add_layernorm_nosum_bwd")
    return _bwd(x, residual, weight, dy, dsum, eps, counter)


class _LayerNorm(torch.autograd.Function):
    """K3 with its backward kernel (the Pallas custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, db.to(ctx.bias_dtype), None


class _AddLayerNorm(torch.autograd.Function):
    """K4 (``return_sum``) or K5 with its backward kernel (the Pallas
    custom VJPs): K4 saves the sum it wrote, K5 the pair."""

    @staticmethod
    def forward(ctx, a, b, weight, bias, eps, return_sum):
        out = _add_layer_norm_fwd(a, b, weight, bias, eps, return_sum)
        ctx.eps, ctx.bias_dtype, ctx.return_sum = eps, bias.dtype, return_sum
        if return_sum:
            ctx.save_for_backward(out[1], weight)
        else:
            ctx.save_for_backward(a, b, weight)
        return out

    @staticmethod
    def backward(ctx, dy, dsum=None):
        if ctx.return_sum:
            s, weight = ctx.saved_tensors
            dx, dw, db = add_layer_norm_bwd(s, None, weight, dy.contiguous(),
                                            dsum.contiguous(), ctx.eps)
        else:
            a, b, weight = ctx.saved_tensors
            dx, dw, db = add_layer_norm_bwd(a, b, weight, dy.contiguous(),
                                            None, ctx.eps)
        return dx, dx, dw, db.to(ctx.bias_dtype), None, None


def _layer_norm_fwd(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    return _fwd(x, None, weight, bias, eps, False, "layernorm")


def _add_layer_norm_fwd(a, b, weight, bias, eps, return_sum):
    if a.device.type == "cpu":
        return add_layer_norm_reference(a, b, weight, bias, eps, return_sum)
    _check_pair(a, b)
    return _fwd(a, b, weight, bias, eps, return_sum,
                "add_layernorm" if return_sum else "add_layernorm_nosum")


def _check_call(x, weight, bias):
    D = x.shape[-1]
    if weight.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"weight/bias must be ({D},), got "
                         f"{tuple(weight.shape)} {tuple(bias.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LayerNorm kernel for {x.device}")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def layer_norm(x, weight, bias, eps: float):
    """K3: LayerNorm over the last axis of ``x`` (any leading shape) with
    fp32 statistics; ``weight``/``bias`` are (D,). Returns ``x.dtype``;
    differentiable through the backward kernel."""
    _check_call(x, weight, bias)
    if _needs_grad(x, weight, bias):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _layer_norm_fwd(x, weight, bias, eps)


def add_layer_norm(a, b, weight, bias, eps: float, return_sum: bool = True):
    """K4 (``return_sum``): ``(LN(a + b), a + b)``; K5: ``LN(a + b)``,
    the sum never stored. ``a``/``b`` share a shape (any leading dims) and
    a dtype; the sum is normalised in fp32 and returned in a's dtype.
    Differentiable through the backward kernels."""
    _check_call(a, weight, bias)
    if _needs_grad(a, b, weight, bias):
        return _AddLayerNorm.apply(a, b, weight, bias, eps, return_sum)
    return _add_layer_norm_fwd(a, b, weight, bias, eps, return_sum)
