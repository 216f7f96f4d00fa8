"""Single-query decode attention over a flat KV cache (K9).

Replaces ``lavila_tpu/ops/pallas/decode_attention.py:
decode_attention_fused`` (Pallas body ``_kernel``) with the CUDA C++
kernel of ``lavila_tpu_torch/csrc/decode_attention.cu``; its header says
what bounds it on the H100 and how it is laid out. The contract is the
JAX function's, with the current token's term computed inside the
kernel: ``q``, ``k_new``, ``v_new`` ``(B, D)``; ``k_cache``, ``v_cache``
``(B, Kmax, D)`` flat, head h in columns ``[h·d, (h+1)·d)``; the cache
positions ``< num_valid`` are attended, plus the current token. Scores
and softmax in fp32, the probabilities rounded to the input dtype before
p·v, the output ``(B, D)`` in the input dtype. Inference only: there is
no backward.

q/k_new/v_new may be row views with any row stride (the column blocks
of one ``c_attn`` output), so the decoder makes no copies for the call.

:func:`decode_attention` takes its plain PyTorch version
(:func:`decode_attention_reference`) only for CPU tensors; on a CUDA
tensor it launches the kernel (head_dim 64, fp32 or bf16) or raises.
"""

from __future__ import annotations

import torch

from lavila_tpu_torch.kernels import build

# kernel launches in this process, a plain int; a caller zeroes it to
# count one run
launches = {"decode": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the kernel's only head width (every GPT-2 preset)


def decode_attention_reference(q, k_cache, v_cache, k_new, v_new,
                               num_valid: int, heads: int):
    """Plain PyTorch version, per head by reshape: fp32 scores over the
    ``num_valid`` cache rows and the current token, fp32 softmax, the
    probabilities rounded to ``q.dtype`` before p·v (as the JAX package
    does), fp32 sums. Returns ``(B, D)`` in ``q.dtype``."""
    B, D = q.shape
    d = D // heads
    nv = num_valid
    scale = d ** -0.5
    qh = q.float().reshape(B, heads, d)
    kc = k_cache[:, :nv].float().reshape(B, nv, heads, d)
    vc = v_cache[:, :nv].float().reshape(B, nv, heads, d)
    s_old = torch.einsum("bhd,bkhd->bhk", qh, kc) * scale
    s_new = (qh * k_new.float().reshape(B, heads, d)).sum(-1) * scale
    p = torch.softmax(torch.cat([s_old, s_new[..., None]], -1), dim=-1)
    p = p.to(q.dtype).float()
    out = torch.einsum("bhk,bkhd->bhd", p[..., :nv], vc)
    out = out + p[..., nv, None] * v_new.float().reshape(B, heads, d)
    return out.reshape(B, D).to(q.dtype)


def _row_stride(t: torch.Tensor, name: str) -> int:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must have stride 1")
    return t.stride(0)


def _check(q, k_cache, v_cache, k_new, v_new, num_valid, heads):
    B, D = q.shape if q.dim() == 2 else (None, None)
    if B is None or k_new.shape != (B, D) or v_new.shape != (B, D):
        raise ValueError(f"q/k_new/v_new must be (B, D), got "
                         f"{tuple(q.shape)} {tuple(k_new.shape)} "
                         f"{tuple(v_new.shape)}")
    if k_cache.dim() != 3 or k_cache.shape[0] != B \
            or k_cache.shape[2] != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"k_cache/v_cache must be (B, Kmax, D) = "
                         f"({B}, Kmax, {D}), got {tuple(k_cache.shape)} "
                         f"{tuple(v_cache.shape)}")
    if D % heads:
        raise ValueError(f"D={D} is not a multiple of heads={heads}")
    if not 0 <= num_valid <= k_cache.shape[1]:
        raise ValueError(f"num_valid={num_valid} outside [0, "
                         f"{k_cache.shape[1]}]")
    ts = (q, k_cache, v_cache, k_new, v_new)
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"decode attention takes one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("decode attention tensors must be on one device")


def decode_attention(q, k_cache, v_cache, k_new, v_new, num_valid: int,
                     heads: int):
    """One decode step's attention; see the module docstring. On a CUDA
    tensor the kernel reads only the ``num_valid`` valid cache rows."""
    num_valid = int(num_valid)
    _check(q, k_cache, v_cache, k_new, v_new, num_valid, heads)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, k_new, v_new,
                                          num_valid, heads)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    B, D = q.shape
    if D // heads != HEAD_DIM:
        raise ValueError(f"the decode kernel takes head_dim 64, got "
                         f"{D // heads}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the decode kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("k_cache/v_cache must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("k_cache/v_cache must be 16-byte aligned")
    strides = [_row_stride(t, n) for t, n in
               ((q, "q"), (k_new, "k_new"), (v_new, "v_new"))]
    lib = build.library()
    out = torch.empty((B, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.lavila_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), B, heads,
            k_cache.shape[1], num_valid, *strides, HEAD_DIM ** -0.5,
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention")
    launches["decode"] += 1
    return out
