"""LayerNorm (K3) and the fused add + LayerNorm (K4, K5), forward and
backward: Triton forward kernels, one CUDA C++ backward kernel.

Replaces ``lavila_tpu/ops/pallas/layernorm.py``: ``fused_layernorm``
(K3), ``fused_add_layernorm`` (K4: ``(LN(a + b), a + b)``) and
``fused_add_layernorm_nosum`` (K5: ``LN(a + b)``, the sum never stored),
with their custom VJPs (Pallas bodies ``_fwd_kernel`` and
``_bwd_kernel``, whose ``two_inputs``/``emit_sum``/``has_dsum`` flags
become the forward kernel's constexpr flags and the backward kernel's
template flags here). Each is a per-row reduction around an elementwise
pass, fused with the residual add for K4/K5: the case Triton is allowed
for in this port. On the H100 each is bound by device memory.

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
* Backward: one hand-written CUDA C++ kernel for sm_90a,
  ``csrc/layernorm_bwd.cu`` (its source note has the design). The
  statistics are recomputed from x in fp32 (nothing was saved), then
  ``dx = rstd·(g − mean(g) − x̂·mean(g·x̂))`` with g = dy·γ. K3 reads
  x; K4 reads its saved sum and adds the sum's own gradient d(sum) into dx;
  K5 re-adds a + b in fp32. K4/K5 return the same dx for a and b. A warp
  owns a row, a persistent grid of blocks walks contiguous runs of rows
  through per-warp rings of bulk-copied rows, and dγ = Σ dy·x̂, dβ = Σ dy
  are summed in a fixed order inside the same launch (each block's
  partial row, one grid barrier, then the columns over the partials):
  no atomics, so two calls give the same bits. :func:`bwd_shape` and
  :func:`bwd_plan` are its launch plan (warps, ring slots, shared
  memory, grid, rows per block); a call whose rows all fit in one block's
  ring at once runs one block, without partials or barrier.

When autograd needs it, :func:`layer_norm` runs through
:class:`_LayerNorm` (saves x and γ) and :func:`add_layer_norm` through
:class:`_AddLayerNorm` (K4: saves the sum; K5: saves a and b). Each
direction takes its plain PyTorch version (:func:`layer_norm_reference`,
:func:`add_layer_norm_reference`, :func:`layer_norm_bwd_reference`,
:func:`add_layer_norm_bwd_reference`) only for CPU tensors; on a CUDA
tensor it launches the kernel or raises. ``triton`` is imported, and the
CUDA library built (``kernels/build.py``), when a kernel is first
launched, so the module imports where neither is present.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, a plain int per kernel; a caller
# zeroes them to count one run. The backward's also by branch:
# "ln_bwd_grid" (a cooperative grid, dγ/dβ behind its barrier) and
# "ln_bwd_block" (one block holds every row)
launches = {"layernorm": 0, "layernorm_bwd": 0, "add_layernorm": 0,
            "add_layernorm_bwd": 0, "add_layernorm_nosum": 0,
            "add_layernorm_nosum_bwd": 0, "ln_bwd_grid": 0,
            "ln_bwd_block": 0}

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


# ---- the backward kernel's launch plan (csrc/layernorm_bwd.cu)

SMEM_MAX = 232448  # shared memory a block may use: 227 KB
# per block: two blocks an SM (the system keeps 1 KB a block), or one
_SMEM_BUDGETS = (SMEM_MAX // 2 - 1024, SMEM_MAX)
WARPS = 8  # a block's warps, one row each at a time (4 for large rows)
SLOTS = 2  # rows a warp's ring holds (kSlots in the source)
# the 16-byte chunks (vector path) or values (scalar path) a lane may
# own: the kernel's instantiations
_VEC_CHUNKS = (1, 2, 3, 4, 6, 8, 16)
_SCALAR_VALUES = (8, 32)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def bwd_smem(D: int, itemsize: int, tensors: int, warps: int,
             vec: bool) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source):
    γ in fp32; on the vector path an mbarrier a ring slot and each warp's
    ring of ``SLOTS`` rows of ``tensors`` tensors, which then holds each
    warp's dγ/dβ row (on the scalar path that row alone)."""
    ring = warps * SLOTS * tensors * D * itemsize if vec else 0
    sums = 4 * warps * max(2 * D, 32)
    return (_pad16(4 * D) + (_pad16(8 * warps * SLOTS) if vec else 0)
            + max(ring, sums))


@dataclasses.dataclass(frozen=True)
class BwdShape:
    """What a backward call's kernel is, whatever its rows: ``vec``, the
    16-byte ring path (else scalar), ``per_lane`` the chunks (values)
    a lane may own, ``warps`` a block, ``smem`` a block's dynamic shared
    memory in bytes."""
    vec: bool
    per_lane: int
    warps: int
    smem: int

    @property
    def slots(self) -> int:
        """Rows a warp's ring holds (none on the scalar path)."""
        return SLOTS if self.vec else 0


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """A call's launch: ``grid`` blocks of ``rows_per_block`` contiguous
    rows (the last block fewer)."""
    shape: BwdShape
    grid: int
    rows_per_block: int

    @property
    def single(self) -> bool:
        """One block: no partials, no grid barrier."""
        return self.grid == 1


@functools.cache  # a pure function, on every call's host path
def bwd_shape(D: int, itemsize: int, tensors: int,
              aligned: bool = True) -> BwdShape:
    """The kernel for rows of ``D`` elements of ``itemsize`` bytes and
    ``tensors`` row tensors read (2 for K3, 3 for K4/K5): the vector path
    where a row is whole 16-byte chunks and every pointer is 16-byte
    ``aligned``, with ``WARPS`` warps a block where two blocks share an
    SM or one fits, else half as many (K4/K5 rows over 4.6 KB, as fp32
    at D = 1600). Raises ValueError for a row the kernel does not
    take."""
    if D < 1:
        raise ValueError(f"LayerNorm backward needs D >= 1, got {D}")
    if aligned and D * itemsize % 16 == 0:
        chunks = D * itemsize // 16
        per_lane = next((n for n in _VEC_CHUNKS if 32 * n >= chunks), None)
        if per_lane is not None:
            for budget, warps in ((_SMEM_BUDGETS[0], WARPS),
                                  (_SMEM_BUDGETS[1], WARPS),
                                  (_SMEM_BUDGETS[1], WARPS // 2)):
                smem = bwd_smem(D, itemsize, tensors, warps, True)
                if smem <= budget:
                    return BwdShape(True, per_lane, warps, smem)
    else:
        per_lane = next((n for n in _SCALAR_VALUES if 32 * n >= D), None)
        if per_lane is not None:
            return BwdShape(False, per_lane, WARPS,
                            bwd_smem(D, itemsize, tensors, WARPS, False))
    raise ValueError(f"no LayerNorm backward kernel for rows of {D} "
                     f"elements of {itemsize} bytes")


@functools.cache
def bwd_plan(rows: int, shape: BwdShape, blocks_per_sm: int,
             sms: int) -> BwdPlan:
    """Rows that one block's rings hold at once go to one block;
    otherwise at most the resident blocks (``blocks_per_sm`` x ``sms``),
    each over a contiguous run of at least one row a warp."""
    if rows < 1 or blocks_per_sm < 1 or sms < 1:
        raise ValueError(f"no plan for {rows} rows on {sms} SMs x "
                         f"{blocks_per_sm} blocks")
    if rows <= shape.warps * max(shape.slots, 1):
        return BwdPlan(shape, 1, rows)
    per = max(-(-rows // (blocks_per_sm * sms)), shape.warps)
    return BwdPlan(shape, -(-rows // per), per)


_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _blocks_per_sm(device_index, D: int, dtype, residual: bool, dsum: bool,
                   shape: BwdShape) -> int:
    """Resident blocks an SM of the kernel for ``shape``, by the CUDA
    occupancy calculator."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = build.library().lavila_ln_bwd_occupancy(
            D, _CODES[dtype], int(residual), int(dsum), int(shape.vec),
            shape.per_lane, shape.warps, ctypes.byref(blocks),
            ctypes.byref(smem))
    build.check(err, "layernorm_bwd occupancy")
    if smem.value != shape.smem or blocks.value < 1:
        raise RuntimeError(f"layernorm_bwd: {blocks.value} blocks an SM at "
                           f"{smem.value} bytes of shared memory (plan "
                           f"{shape.smem})")
    return blocks.value


def _bwd(x, residual, weight, dy, dsum, eps, counter: str):
    """The backward kernel on CUDA tensors: ``(dx, dweight, dbias)``."""
    rows_in = [x, dy] + [t for t in (residual, dsum) if t is not None]
    _check_kernel_inputs(weight, *rows_in)
    if any(t.dtype != x.dtype for t in rows_in):
        raise TypeError(f"the rows must share one dtype, got "
                        f"{[t.dtype for t in rows_in]}")
    D = x.shape[-1]
    rows = x.numel() // D
    dx = torch.empty_like(x)
    dwb = torch.empty((2, D), dtype=weight.dtype, device=x.device)
    if rows == 0:
        dwb.zero_()
        return dx, dwb[0], dwb[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in rows_in)  # dx is fresh
    shape = bwd_shape(D, x.element_size(), len(rows_in), aligned)
    dev = x.device.index
    plan = bwd_plan(rows, shape,
                    _blocks_per_sm(dev, D, x.dtype, residual is not None,
                                   dsum is not None, shape), _sm_count(dev))
    part = None if plan.single else torch.empty(
        (plan.grid, 2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().lavila_ln_bwd(
            *(None if t is None else t.data_ptr()
              for t in (x, residual, weight, dy, dsum, dx, dwb, part)),
            rows, D, plan.rows_per_block, plan.grid,
            shape.warps, int(shape.vec), shape.per_lane, eps,
            _CODES[x.dtype], _CODES[weight.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "layernorm_bwd")
    launches[counter] += 1
    launches["ln_bwd_block" if plan.single else "ln_bwd_grid"] += 1
    return dx, dwb[0], dwb[1]


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
