"""The expert layer of a mixture-of-experts decoder (DeepSeek-V3's, at
the Moonlight narrator's sizes): routing and the routed plus shared
SwiGLU experts.

Replaces no TPU kernel (the JAX package has no mixture-of-experts
model); ``csrc/moe_experts.cu`` says what bounds it on the H100 and how
it is laid out. Two dispatch sites, each the kernels on a CUDA tensor
and the plain PyTorch version on a CPU tensor:

  * :func:`route`: ``s = sigmoid(x W_r^T)`` in fp32 over the ``E``
    routed experts, the top ``k`` of ``s + bias`` (a tie to the lower
    index), weights ``s_k / Σ s_k × scale`` → ``(weights (T, k) fp32,
    idx (T, k) int32)``;
  * :func:`experts`: ``y_t = Σ_k w_tk E_{idx_tk}(x_t) + Σ_s S_s(x_t)``
    with ``E_e(x) = W2_e (silu(W_gate,e x) ⊙ W_up,e x)``, the gate and up
    rows stacked in ``w1 (E, 2I, D)`` (gate first), ``w2 (E, D, I)``, and
    the ``S`` shared experts of the same shape in ``w1s``, ``w2s``
    (every token takes each with weight 1). Four launches: the sort of
    the routed rows by expert, the grouped gate/up product, the grouped
    down product and the combine.

Numerics of both versions: every product sums in fp32 over the bf16
operands; ``h = silu(g) ⊙ u`` and each expert's output row are rounded
to the input dtype; the combine adds a token's ``k`` weighted rows, then
its shared rows, in that order in fp32, and rounds once. The kernels
take bfloat16 only.

No host sync: the groups' offsets stay on the device and the launches
are the same whatever the routing. The kernels have no backward: on a
CUDA tensor that needs a gradient :func:`experts` raises.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, one a call of each kernel, and one a
# layer call by shape ("moe_layer_<tokens>x<k>"); a caller zeroes them to
# count one run
launches = {"moe_route": 0, "moe_sort": 0, "moe_gate_up": 0, "moe_down": 0,
            "moe_combine": 0}

MAX_EXPERTS = 64   # csrc/moe_experts.cu: kMaxExperts
MAX_TOP_K = 8      # kMaxTopK
MAX_ROUTER_D = 2048  # kMaxD


def route_reference(x, weight, bias, top_k: int, scale: float):
    """Plain PyTorch routing of ``x (T, D)``; see the module docstring."""
    s = torch.sigmoid(x.float() @ weight.float().T)
    idx = torch.topk(s + bias.float(), top_k, dim=-1).indices
    picked = s.gather(-1, idx)
    return picked / picked.sum(-1, keepdim=True) * scale, idx.int()


def sort_reference(idx, num_experts: int, num_shared: int):
    """The routed rows grouped by expert (stable in token order), then
    the shared groups: ``(src (N,), pos (T, k), offsets (E + S + 1,))``,
    int32, ``N = T·k + S·T``."""
    T, k = idx.shape
    flat = idx.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=idx.device)
    counts = torch.zeros(num_experts, dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0),
                         T * k + T * torch.arange(1, num_shared + 1,
                                                  device=idx.device)])
    shared = torch.arange(T, device=idx.device).repeat(num_shared)
    src = torch.cat([order // k, shared])
    return src.int(), pos.view(T, k).int(), offsets.int()


def _swiglu_rows(x, w1):
    """``silu(x W_gate^T) ⊙ (x W_up^T)`` of rows ``x (n, D)`` through one
    expert's ``w1 (2I, D)``, fp32 products, rounded to x's dtype."""
    I = w1.shape[0] // 2
    gu = x.float() @ w1.float().T
    return (torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]).to(x.dtype)


def experts_reference(x, weights, idx, w1, w2, w1s, w2s):
    """Plain PyTorch version of :func:`experts`, step for step: the sort,
    the grouped products as a loop over the groups, the combine."""
    T, k = idx.shape
    E, S = w1.shape[0], w1s.shape[0]
    src, pos, offsets = sort_reference(idx, E, S)
    bounds = offsets.tolist()
    y = x.new_empty((src.numel(), x.shape[1]))
    for g in range(E + S):
        a, b = bounds[g], bounds[g + 1]
        if a == b:
            continue
        up, down = (w1[g], w2[g]) if g < E else (w1s[g - E], w2s[g - E])
        h = _swiglu_rows(x[src[a:b].long()], up)
        y[a:b] = (h.float() @ down.float().T).to(x.dtype)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out += weights[:, j, None].float() * y[pos[:, j].long()].float()
    for s in range(S):
        out += y[T * k + s * T:T * k + (s + 1) * T].float()
    return out.to(x.dtype)


def _count(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def _rows(x, name: str) -> int:
    """The row stride of a (T, D) bf16 tensor whose rows the kernels copy
    in 16-byte chunks."""
    rs = build.row_stride(x, name)
    if rs % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    return rs


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"no expert kernel for {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError("the expert kernels' tensors must be on one "
                             "device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the expert kernels take bfloat16, got "
                            f"{t.dtype}")


def route(x, weight, bias, top_k: int, scale: float):
    """Routing of ``x (T, D)`` over ``weight (E, D)`` and ``bias (E,)``;
    see the module docstring."""
    T, D = x.shape
    E = weight.shape[0]
    if weight.shape != (E, D) or bias.shape != (E,) or not 0 < top_k <= E:
        raise ValueError(f"route: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, "
                         f"top_k {top_k}")
    if x.device.type == "cpu":
        return route_reference(x, weight, bias, top_k, scale)
    _check_cuda(x, weight, bias)
    if D % 256 or D > MAX_ROUTER_D or E > MAX_EXPERTS or top_k > MAX_TOP_K:
        raise ValueError(f"the routing kernel takes D a multiple of 256 up "
                         f"to {MAX_ROUTER_D}, E <= {MAX_EXPERTS}, k <= "
                         f"{MAX_TOP_K}; got D {D}, E {E}, k {top_k}")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("route: weight and bias must be contiguous")
    rs = _rows(x, "x")
    idx = torch.empty((T, top_k), dtype=torch.int32, device=x.device)
    wts = torch.empty((T, top_k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().lavila_moe_route(
            x.data_ptr(), rs, weight.data_ptr(), bias.data_ptr(),
            idx.data_ptr(), wts.data_ptr(), T, D, E, top_k, float(scale),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "moe_route")
    _count("moe_route")
    return wts, idx


def experts(x, weights, idx, w1, w2, w1s, w2s):
    """The routed and shared experts of ``x (T, D)``, weighted by
    ``weights (T, k)`` at ``idx (T, k)``; see the module docstring.
    Returns ``(T, D)`` in x's dtype."""
    T, D = x.shape
    E, two_i, _ = w1.shape
    S, I = w1s.shape[0], two_i // 2
    k = idx.shape[1]
    if (w1.shape != (E, 2 * I, D) or w2.shape != (E, D, I)
            or w1s.shape != (S, 2 * I, D) or w2s.shape != (S, D, I)
            or idx.shape != (T, k) or weights.shape != (T, k)):
        raise ValueError(f"experts: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, weights "
                         f"{tuple(weights.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}, w1s {tuple(w1s.shape)}, "
                         f"w2s {tuple(w2s.shape)}")
    if x.device.type == "cpu":
        return experts_reference(x, weights, idx, w1, w2, w1s, w2s)
    _check_cuda(x, w1, w2, w1s, w2s)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weights, w1, w2, w1s, w2s)):
        raise NotImplementedError(
            "the grouped expert kernels have no backward: training through "
            "the expert layer on the card is not implemented")
    if E > MAX_EXPERTS or D % 128 or I % 64:
        raise ValueError(f"the expert kernels take E <= {MAX_EXPERTS}, D a "
                         f"multiple of 128, I of 64; got E {E}, D {D}, I {I}")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("experts: idx must be int32 and weights float32, as "
                        "route gives them")
    if not all(t.is_contiguous() for t in (idx, weights, w1, w2, w1s, w2s)):
        raise ValueError("experts: idx, weights and the weights must be "
                         "contiguous")
    rs = _rows(x, "x")
    dev, N = x.device, T * k + S * T
    src = torch.empty(N, dtype=torch.int32, device=dev)
    pos = torch.empty((T, k), dtype=torch.int32, device=dev)
    offsets = torch.empty(E + S + 1, dtype=torch.int32, device=dev)
    h = torch.empty((N, I), dtype=x.dtype, device=dev)
    y = torch.empty((N, D), dtype=x.dtype, device=dev)
    out = torch.empty((T, D), dtype=x.dtype, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(dev):
        build.check(lib.lavila_moe_sort(
            idx.data_ptr(), src.data_ptr(), pos.data_ptr(),
            offsets.data_ptr(), T, k, E, S, stream), "moe_sort")
        build.check(lib.lavila_moe_gate_up(
            x.data_ptr(), rs, src.data_ptr(), offsets.data_ptr(),
            w1.data_ptr(), w1s.data_ptr(), h.data_ptr(), E, S, D, I, T,
            stream), "moe_gate_up")
        build.check(lib.lavila_moe_down(
            h.data_ptr(), offsets.data_ptr(), w2.data_ptr(), w2s.data_ptr(),
            y.data_ptr(), E, S, D, I, T, stream), "moe_down")
        build.check(lib.lavila_moe_combine(
            y.data_ptr(), pos.data_ptr(), weights.data_ptr(), out.data_ptr(),
            T, k, S, D, stream), "moe_combine")
    for name in ("moe_sort", "moe_gate_up", "moe_down", "moe_combine",
                 f"moe_layer_{T}x{k}"):
        _count(name)
    return out
