"""LayerNorm (K3), forward and backward, Triton kernels.

Replaces ``lavila_tpu/ops/pallas/layernorm.py:fused_layernorm`` and its
custom VJP (Pallas bodies ``_fwd_kernel`` and ``_bwd_kernel``).
LayerNorm is a per-row reduction followed by an elementwise pass (the
case Triton is allowed for in this port), so on the H100 it is bound by
device memory.

* Forward: one read of x and one write of y, 2·R·D·itemsize bytes (19.3
  MB for the video tower's (8·4·196, 768) bf16 rows). One program per row
  holds the whole row in registers (D in {512, 768, 1600} masked to a
  power-of-two block), takes fp32 statistics with the one-pass variance
  ``max(E[x²] − E[x]², 0)`` of ``lavila_tpu/ops/basic.py:150-153``, and
  writes y in the input dtype. No statistics land in device memory.
* Backward: reads x and dy once and writes dx, 3·R·D·itemsize bytes.
  The statistics are recomputed from x in fp32 (nothing was saved), then
  ``dx = rstd·(g − mean(g) − x̂·mean(g·x̂))`` with g = dy·γ. dγ = Σ dy·x̂
  and dβ = Σ dy are sums over every row: blocks run in no order on the
  card, so each program walks a fixed run of rows and writes fp32
  partials, and a second kernel adds the partials in a fixed order, 64
  partials x 64 columns per step. No atomics, so two calls give the same
  bits.

When autograd needs it, :func:`layer_norm` runs through
:class:`_LayerNorm`, which saves x and γ. Each direction takes its plain
PyTorch version (:func:`layer_norm_reference`,
:func:`layer_norm_bwd_reference`) only for CPU tensors; on a CUDA tensor
it launches the kernel or raises. ``triton`` is imported when a kernel
is first launched, so the module imports where triton is absent.
"""

from __future__ import annotations

import functools

import torch

# kernel launches in this process, a plain int; a caller zeroes it to
# count one run
launches = {"layernorm": 0, "layernorm_bwd": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm_reference(x, weight, bias, eps: float):
    """Plain PyTorch LayerNorm over the last axis with fp32 one-pass
    statistics; the output takes the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    var = (ms - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x, weight, dy, eps: float):
    """Plain PyTorch backward: fp32 one-pass statistics recomputed from x
    (``lavila_tpu/ops/pallas/layernorm.py:56-61``). Returns ``(dx,
    dweight, dbias)``: dx in x's dtype, dweight/dbias in weight's."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((ms - mean * mean).clamp_min(0.0) + eps)
    xhat = (x32 - mean) * rstd
    dy32 = dy.float()
    g = dy32 * weight.float()
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    D = x.shape[-1]
    dw = (dy32 * xhat).reshape(-1, D).sum(0)
    db = dy32.reshape(-1, D).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


@functools.cache
def _kernel():
    # the kernel body resolves ``tl`` among this module's globals
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(x_ptr, w_ptr, b_ptr, y_ptr, D, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
        x = x.to(tl.float32)
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
    def ln_bwd(x_ptr, w_ptr, dy_ptr, dx_ptr, dw_part_ptr, db_part_ptr, R, D,
               rows_per_program, eps, BLOCK_D: tl.constexpr):
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


@functools.cache
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _block(D: int) -> int:
    return 1 << (D - 1).bit_length()  # D masked to a power of two


def _layer_norm_fwd(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    _check_kernel_inputs(x, weight, bias)
    D = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    kernel = _kernel()
    block = _block(D)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, weight, bias, y, D, eps, BLOCK_D=block,
                        num_warps=4 if block <= 1024 else 8)
    launches["layernorm"] += 1
    return y


def layer_norm_bwd(x, weight, dy, eps: float):
    """Backward on the tensors' device: ``(dx, dweight, dbias)``, dx in
    x's dtype and dweight/dbias in weight's."""
    D = x.shape[-1]
    if weight.shape != (D,) or dy.shape != x.shape:
        raise ValueError(f"weight must be ({D},) and dy {tuple(x.shape)}, "
                         f"got {tuple(weight.shape)} {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, weight, dy, eps)
    _check_kernel_inputs(x, weight, dy)
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
        ln_bwd[(programs,)](x, weight, dy, dx, parts[0], parts[1], rows, D,
                            per, eps, BLOCK_D=block,
                            num_warps=4 if block <= 1024 else 8)
        ln_bwd_sum[(-(-D // 64),)](parts[0], parts[1], dw, db, programs, D,
                                   BLOCK_P=64, BLOCK_C=64, num_warps=4)
    launches["layernorm_bwd"] += 1
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    """LayerNorm with its backward kernel (the Pallas custom VJP)."""

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


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last axis of ``x`` (any leading shape) with fp32
    statistics; ``weight``/``bias`` are (D,). Returns ``x.dtype``;
    differentiable through the backward kernel."""
    D = x.shape[-1]
    if weight.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"weight/bias must be ({D},), got "
                         f"{tuple(weight.shape)} {tuple(bias.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LayerNorm kernel for {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _layer_norm_fwd(x, weight, bias, eps)
