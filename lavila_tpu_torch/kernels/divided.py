"""Divided space-time attention phases (K1 spatial, K2 temporal, K6
spatial over large frames), forward and backward.

Replaces ``lavila_tpu/ops/pallas/divided.py:divided_phase`` and
``spatial_phase_big`` with their custom VJPs (Pallas bodies
``_space_fwd_kernel``/``_time_fwd_kernel``/``_space_big_fwd_kernel`` and
``_space_bwd_kernel``/``_time_bwd_kernel``/``_space_big_bwd_kernel``)
with the CUDA C++ kernels of ``lavila_tpu_torch/csrc/divided_fwd.cu``,
``divided_bwd.cu`` and ``divided_big.cu``; the headers there say what
bounds each phase on the H100 and how the kernels are laid out for it.
A spatial phase over frames of more than 256 patches (the 336px towers'
576) goes to K6's entry points, as ``lavila_tpu/ops/attention.py:359-377``
routes it; in bf16 at head_dim 64 K1 and K6 run the same tensor-core
kernels (:func:`space_branch` picks them, one rule for both), and only
their SIMT kernels (fp32, other head sizes, unaligned rows) differ. K2
(the temporal phase) takes its slab kernels on the tensor cores in bf16
at head_dim 64 up to 16 frames (:func:`time_branch`: tiles of 16 // F
positions x every frame, read once into shared memory), and its SIMT
kernels otherwise. Every launch counts under its kernel and branch
(``launches["time_tc"]``, ``["space_bwd_simt"]``, ...). K1, K2 and K6
share one contract, the JAX function's: patch tokens
token-major ``(B, F, N, D = heads * head_dim)``, the CLS token's
key/value rows ``(B, D)`` folded into every group's softmax, outputs
``(B, F, N, D)`` and the per-row log-sum-exp ``(B, F, N, heads)`` in
fp32.

q/k/v may be row views with any row stride (the column blocks of one
``(B, F, N, 3D)`` qkv projection output), so the attention block makes
no ``.contiguous()`` copies.

:func:`divided_phase` calls the operator ``lavila::divided_phase``
(``torch.library.custom_op``), whose autograd formula is the backward
kernel: it saves ``(q, k, v, ck, cv, out, lse)`` and recomputes the
probabilities from ``lse``, as the Pallas VJP does, returning contiguous
``dq/dk/dv`` and the CLS rows' ``dck/dcv`` summed over every group. The
backward's delta is rowsum(P·dP) over the P it recomputes in bf16, and
the Pallas kernels' rowsum(dO·O) in fp32 (``csrc/divided_bwd.cu`` says
why); only the fp32 kernels read the forward's output. The phase is an
operator, not an
``autograd.Function``, so that a selective-checkpoint policy sees it: the
remat policies ``save_attn`` and ``dots_attn``
(``models/timesformer.py``) keep its outputs instead of launching it
again in the recompute.

Each direction takes its plain PyTorch version
(:func:`divided_phase_reference`, :func:`divided_phase_bwd_reference`)
only for CPU tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, a plain int per kernel and branch
# ("tc": the tensor cores, "simt"); a caller zeroes them to count one run
launches = {f"{name}_{branch}": 0
            for name in ("space", "time", "space_big", "space_bwd",
                         "time_bwd", "space_big_bwd")
            for branch in ("tc", "simt")}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPACE_TOKENS = 256  # larger frames go to K6 (spatial_phase_big)
_TC_TILE = 64  # the spatial tensor-core kernels' tiles: 64 queries (keys)
_TIME_ROWS = 16  # K2's slab: 16 // F positions x F frames, one mma.sync m16


def divided_phase_reference(qp, kp, vp, ck, cv, axis: str, heads: int,
                            scale: float):
    """Plain PyTorch version: the grouped formulation with the CLS
    key/value prepended to every group (lavila_tpu/ops/attention.py:
    430-455), scores and softmax in fp32. Returns ``(out, lse)``."""
    B, F, N, D = qp.shape
    d = D // heads

    def grouped(t):
        t = t.reshape(B, F, N, heads, d)
        return t.transpose(1, 2) if axis == "time" else t  # (B, G, S, H, d)

    q, k, v = grouped(qp), grouped(kp), grouped(vp)
    G = q.shape[1]
    kg = torch.cat([ck.reshape(B, 1, 1, heads, d).expand(B, G, 1, heads, d),
                    k], dim=2)
    vg = torch.cat([cv.reshape(B, 1, 1, heads, d).expand(B, G, 1, heads, d),
                    v], dim=2)
    scores = torch.einsum("bgqhd,bgkhd->bhgqk", q.float(), kg.float()) * scale
    lse = torch.logsumexp(scores, dim=-1)                   # (B, H, G, S)
    probs = torch.softmax(scores, dim=-1).to(qp.dtype)
    out = torch.einsum("bhgqk,bgkhd->bgqhd", probs, vg)     # (B, G, S, H, d)
    if axis == "time":
        out = out.transpose(1, 2)
        lse = lse.permute(0, 3, 2, 1)                       # (B, F, N, H)
    else:
        lse = lse.permute(0, 2, 3, 1)
    return out.reshape(B, F, N, D).contiguous(), lse.contiguous()


def divided_phase_bwd_reference(qp, kp, vp, ck, cv, do, out, lse,
                                axis: str, heads: int, scale: float):
    """Plain PyTorch backward with the kernel's signature: P recomputed in
    fp32 from the saved ``lse`` (as the Pallas kernel does), dS = P·(dP −
    delta), delta as the kernels take it: rowsum(dO·O) from an fp32
    ``out``, rowsum(P·dP) over the CLS key and the group's from a bf16
    one. Returns ``(dq, dk, dv)`` in the input dtype and ``(dck, dcv)``
    summed over the groups, in ck's."""
    B, F, N, D = qp.shape
    d = D // heads

    def grouped(t):
        t = t.float().reshape(B, F, N, heads, d)
        return t.transpose(1, 2) if axis == "time" else t  # (B, G, S, H, d)

    q, k, v, g, o = map(grouped, (qp, kp, vp, do, out))
    G = q.shape[1]

    def with_cls(c, t):
        c = c.float().reshape(B, 1, 1, heads, d).expand(B, G, 1, heads, d)
        return torch.cat([c, t], dim=2)

    kg, vg = with_cls(ck, k), with_cls(cv, v)
    # lse (B, F, N, H) → (B, H, G, S), the layout of the scores
    lse_g = lse.permute(0, 3, 2, 1) if axis == "time" else \
        lse.permute(0, 3, 1, 2)
    s = torch.einsum("bgqhd,bgkhd->bhgqk", q, kg) * scale
    p = torch.exp(s - lse_g[..., None])
    dp = torch.einsum("bgqhd,bgkhd->bhgqk", g, vg)
    if out.dtype == torch.float32:
        delta = (g * o).sum(-1).permute(0, 3, 1, 2)[..., None]
    else:
        delta = (p * dp).sum(-1, keepdim=True)              # (B, H, G, S, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bgkhd->bgqhd", ds, kg) * scale
    dkg = torch.einsum("bhgqk,bgqhd->bgkhd", ds, q) * scale
    dvg = torch.einsum("bhgqk,bgqhd->bgkhd", p, g)

    def ungrouped(t):
        t = t.transpose(1, 2) if axis == "time" else t
        return t.reshape(B, F, N, D).to(qp.dtype).contiguous()

    return (ungrouped(dq), ungrouped(dkg[:, :, 1:]), ungrouped(dvg[:, :, 1:]),
            dkg[:, :, 0].sum(1).reshape(B, D).to(ck.dtype),
            dvg[:, :, 0].sum(1).reshape(B, D).to(cv.dtype))


def _check(qp, kp, vp, ck, cv, axis, heads):
    if axis not in ("space", "time"):
        raise ValueError(f"axis must be 'space' or 'time', got {axis!r}")
    if qp.dim() != 4 or kp.shape != qp.shape or vp.shape != qp.shape:
        raise ValueError(f"q/k/v must share one (B, F, N, D) shape, got "
                         f"{tuple(qp.shape)} {tuple(kp.shape)} "
                         f"{tuple(vp.shape)}")
    B, F, N, D = qp.shape
    if ck.shape != (B, D) or cv.shape != (B, D):
        raise ValueError(f"ck/cv must be ({B}, {D}), got {tuple(ck.shape)} "
                         f"{tuple(cv.shape)}")
    if D % heads:
        raise ValueError(f"D={D} is not a multiple of heads={heads}")
    ts = (qp, kp, vp, ck, cv)
    if any(t.dtype != qp.dtype for t in ts) or qp.dtype not in _DTYPES:
        raise TypeError("q/k/v/ck/cv must all be float32 or all bfloat16")
    if any(t.device != qp.device for t in ts):
        raise ValueError("q/k/v/ck/cv must be on one device")


def _kernel_name(qp, axis: str, heads: int) -> str:
    """The kernel of this phase: 'space' (K1), 'space_big' (K6, frames of
    more than 256 patches) or 'time' (K2); raises on what none takes."""
    N, D = qp.shape[2], qp.shape[3]
    if D // heads > 128:
        raise ValueError(f"head_dim {D // heads} > 128 is not supported")
    if axis == "space" and N > _MAX_SPACE_TOKENS:
        return "space_big"
    return axis


def _strides(qp, kp, vp, ck, cv) -> list[int]:
    return [build.row_stride(t, n) for t, n in
            ((qp, "q"), (kp, "k"), (vp, "v"), (ck, "ck"), (cv, "cv"))]


def _tc_rows_fit(qp, kp, vp, ck, cv, heads: int, do, rs=None) -> bool:
    """bf16 at head_dim 64 with q/k/v rows (and dO where given) on
    16-byte boundaries and ck/cv readable as bf16 pairs: what every
    tensor-core kernel of the divided phases copies. ``rs``: the five
    row strides, where the caller has them."""
    D = qp.shape[3]
    if qp.dtype != torch.bfloat16 or D // heads != 64 or qp.shape[2] < 1:
        return False
    rs = rs or _strides(qp, kp, vp, ck, cv)
    wide = [t for t in (qp, kp, vp, do) if t is not None]
    return not (any(t.data_ptr() % 16 for t in wide)
                or any(s % 8 for s in rs[:3])
                or any(t.data_ptr() % 4 for t in (ck, cv))
                or any(s % 2 for s in rs[3:]))


def space_branch(qp, kp, vp, ck, cv, heads: int, do=None, rs=None) -> str:
    """The spatial-phase kernels a call takes, K1's and K6's alike: "tc",
    the tensor-core ones (bf16, head_dim 64, q/k/v rows and dO on 16-byte
    boundaries for TMA, ck/cv read as bf16 pairs), or "simt". The C entry
    points refuse a "tc" call outside these conditions (``space_tc_fits``,
    ``space_bwd_tc_fits`` in ``csrc/``); pass ``do`` for the
    backward's."""
    return "tc" if _tc_rows_fit(qp, kp, vp, ck, cv, heads, do, rs) \
        else "simt"


def time_branch(qp, kp, vp, ck, cv, heads: int, do=None, rs=None) -> str:
    """The temporal-phase (K2) kernels a call takes: "tc", the slab
    kernels on the tensor cores (the spatial ones' row conditions, for
    cp.async, and at most 16 frames: a tile's 16 rows hold every frame of
    16 // F positions), or "simt" (fp32, other head sizes, unaligned
    rows, more frames). The C entry points refuse a "tc" call outside
    these conditions (``time_tc_fits`` in ``csrc/common.cuh``); pass
    ``do`` for the backward's."""
    fits = qp.shape[1] <= _TIME_ROWS and _tc_rows_fit(qp, kp, vp, ck, cv,
                                                      heads, do, rs)
    return "tc" if fits else "simt"


def phase_branch(qp, kp, vp, ck, cv, axis: str, heads: int, do=None,
                 rs=None) -> str:
    """:func:`space_branch` or :func:`time_branch` by ``axis`` (``rs``:
    the row strides, where the caller has them)."""
    pick = space_branch if axis == "space" else time_branch
    return pick(qp, kp, vp, ck, cv, heads, do, rs)


def _partials_shape(name: str, branch: str, B: int, F: int, N: int,
                    D: int) -> tuple:
    """The fp32 partials of dck/dcv, ``(B, groups, D)``, summed over the
    groups in a fixed order: one per (frame, 64-query tile) for the
    spatial phase's tensor-core kernels (K1 and K6), per frame for its
    SIMT ones; for K2 one per slab tile (16 // F positions, every frame,
    summed over the tile inside the block) on the tensor cores, per
    position on SIMT."""
    if name == "time":
        span = _TIME_ROWS // F if branch == "tc" else 1
        return (B, -(-N // span), D)
    if branch == "tc":
        return (B, F * -(-N // _TC_TILE), D)
    return (B, F, D)


def _stats_shape(name: str, branch, B: int, F: int, N: int,
                 H: int) -> tuple | None:
    """The fp32 scratch a spatial backward hands between its kernels, or
    None where no kernel reads one: on the tensor cores per (frame, head,
    64-query tile) the tile's 64 lse (log2 domain) then its 64 delta =
    rowsum(P·dP), written by the dq kernel and read by the dk/dv kernel in
    one copy; for the SIMT kernels (K1's and K6's) delta per (row, head),
    written by the dq kernel (in fp32 K6's by a pass over dO and O of its
    own); K2 computes delta where it uses it."""
    if name == "time":
        return None
    if branch == "tc":
        return (B, F, H, -(-N // _TC_TILE), 2, _TC_TILE)
    return (B, F, N, H)


def _phase_fwd(qp, kp, vp, ck, cv, axis, heads, scale):
    """Forward on the tensors' device: (out, lse)."""
    if qp.device.type == "cpu":
        return divided_phase_reference(qp, kp, vp, ck, cv, axis, heads,
                                       scale)
    if qp.device.type != "cuda":
        raise ValueError(f"no divided-attention kernel for {qp.device}")
    name = _kernel_name(qp, axis, heads)
    rs = _strides(qp, kp, vp, ck, cv)
    branch = phase_branch(qp, kp, vp, ck, cv, axis, heads, rs=rs)
    B, F, N, D = qp.shape
    fn = getattr(build.library(), f"lavila_divided_{name}_fwd")
    out = torch.empty((B, F, N, D), dtype=qp.dtype, device=qp.device)
    lse = torch.empty((B, F, N, heads), dtype=torch.float32,
                      device=qp.device)
    with torch.cuda.device(qp.device):
        err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), ck.data_ptr(),
                 cv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, F, N,
                 heads, D // heads, *rs,
                 float(scale), _DTYPES[qp.dtype], int(branch == "tc"),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, f"divided_{name}_fwd")
    launches[f"{name}_{branch}"] += 1
    return out, lse


def divided_phase_bwd(qp, kp, vp, ck, cv, do, out, lse, axis: str,
                      heads: int, scale: float):
    """Backward of one phase on the tensors' device: ``(dq, dk, dv, dck,
    dcv)``. q/k/v/ck/cv as the forward took them (row views); do, out and
    lse contiguous, out/do in the inputs' dtype and lse (B, F, N, heads)
    fp32 as the forward wrote it."""
    _check(qp, kp, vp, ck, cv, axis, heads)
    B, F, N, D = qp.shape
    if do.shape != qp.shape or out.shape != qp.shape \
            or lse.shape != (B, F, N, heads):
        raise ValueError(f"do/out must be {tuple(qp.shape)} and lse "
                         f"{(B, F, N, heads)}, got {tuple(do.shape)} "
                         f"{tuple(out.shape)} {tuple(lse.shape)}")
    if do.dtype != qp.dtype or out.dtype != qp.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"do/out must be {qp.dtype} and lse float32, got "
                        f"{do.dtype} {out.dtype} {lse.dtype}")
    if any(t.device != qp.device for t in (do, out, lse)):
        raise ValueError("do/out/lse must be on the inputs' device")
    if qp.device.type == "cpu":
        return divided_phase_bwd_reference(qp, kp, vp, ck, cv, do, out, lse,
                                           axis, heads, scale)
    if qp.device.type != "cuda":
        raise ValueError(f"no divided-attention kernel for {qp.device}")
    name = _kernel_name(qp, axis, heads)
    if not (do.is_contiguous() and out.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("do/out/lse must be contiguous")
    rs = _strides(qp, kp, vp, ck, cv)
    branch = phase_branch(qp, kp, vp, ck, cv, axis, heads, do, rs)
    fn = getattr(build.library(), f"lavila_divided_{name}_bwd")
    grads = [torch.empty((B, F, N, D), dtype=qp.dtype, device=qp.device)
             for _ in range(3)]
    grads += [torch.empty((B, D), dtype=ck.dtype, device=qp.device)
              for _ in range(2)]
    # fp32 per-group partials of dck/dcv, summed by a second pass
    parts = [torch.empty(_partials_shape(name, branch, B, F, N, D),
                         dtype=torch.float32, device=qp.device)
             for _ in range(2)]
    # the spatial kernels take one scratch tensor
    stats = _stats_shape(name, branch, B, F, N, heads)
    scratch = [] if stats is None else [
        torch.empty(stats, dtype=torch.float32, device=qp.device)]
    with torch.cuda.device(qp.device):
        err = fn(*(t.data_ptr() for t in (
            qp, kp, vp, ck, cv, do, out, lse, *scratch, *grads, *parts)),
                 B, F, N, heads, D // heads, *rs,
                 float(scale), _DTYPES[qp.dtype], int(branch == "tc"),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, f"divided_{name}_bwd")
    launches[f"{name}_bwd_{branch}"] += 1
    return tuple(grads)


@torch.library.custom_op("lavila::divided_phase", mutates_args=())
def phase_op(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
             ck: torch.Tensor, cv: torch.Tensor, axis: str, heads: int,
             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The phase as an operator (the Pallas custom VJP): the kernel, or
    its plain version on a CPU tensor."""
    return _phase_fwd(qp, kp, vp, ck, cv, axis, heads, scale)


def _phase_setup(ctx, inputs, output):
    qp, kp, vp, ck, cv, axis, heads, scale = inputs
    ctx.save_for_backward(qp, kp, vp, ck, cv, *output)
    ctx.phase = (axis, heads, scale)
    ctx.mark_non_differentiable(output[1])


def _phase_backward(ctx, dout, _dlse):
    qp, kp, vp, ck, cv, out, lse = ctx.saved_tensors
    grads = divided_phase_bwd(qp, kp, vp, ck, cv, dout.contiguous(), out,
                              lse, *ctx.phase)
    return (*grads, None, None, None)


phase_op.register_autograd(_phase_backward, setup_context=_phase_setup)


def divided_phase(qp, kp, vp, ck, cv, axis: str, heads: int, scale: float):
    """One divided-attention phase over the patch tokens.

    qp/kp/vp: (B, F, N, D) token-major; ck/cv: (B, D). ``axis`` is
    'space' (group = frame, N+1 keys) or 'time' (group = position, F+1
    keys). Returns ``(out (B, F, N, D), lse (B, F, N, heads) fp32)``;
    differentiable in q/k/v/ck/cv through the backward kernel.
    """
    _check(qp, kp, vp, ck, cv, axis, heads)
    return phase_op(qp, kp, vp, ck, cv, axis, heads, float(scale))
