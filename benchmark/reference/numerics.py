"""How the reference multiplies.

``Numerics("fp32")`` computes every product in float32 (the caller turns
TF32 off with :func:`strict_fp32`). ``Numerics("fp8")`` is the control
one precision step below the configurations' bf16: each operand of every
linear layer, projection and the patch embedding is rounded to fp8 e4m3
under one per-tensor scale (its largest magnitude onto 448, e4m3's
largest value), and the product of the rounded operands is taken in
float32, which is what an fp8 GEMM with per-tensor scaling computes; the
backward's two products round their operands alike (the incoming
gradient under a scale of its own). Attention, norms, softmax and the
loss stay float32 in both. ``Numerics("fp8attn")`` is the control of the
attention alone: the linear layers stay float32, and each attention's
q, k, v and probabilities P are rounded to fp8 e4m3 under per-tensor
scales before their two products (the gradient passes the rounding
unchanged). The patch embedding (a conv whose stride is its kernel) is
the product of the patches with the kernel.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
MODES = ("fp32", "fp8", "fp8attn")


def strict_fp32() -> None:
    """Float32 products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def matmul(self, a, b):
        """``a @ b`` (b a matrix), float32."""
        if self.mode != "fp8":
            return torch.matmul(a.float(), b.float())
        return _Fp8MatMul.apply(a.float(), b.float())

    def attend(self, q, k, v, keep=None):
        """``softmax(q k^T / sqrt(d)) v`` over the last two axes, float32;
        ``keep`` (broadcast to the scores) masks the keys it holds False."""
        lower = _fp8_ste if self.mode == "fp8attn" else _same
        scores = torch.matmul(lower(q.float()), lower(k.float()).transpose(
            -1, -2)) * q.shape[-1] ** -0.5
        if keep is not None:
            scores = scores.masked_fill(~keep, float("-inf"))
        return torch.matmul(lower(torch.softmax(scores, dim=-1)),
                            lower(v.float()))

    def linear(self, x, w, b=None):
        """``x @ w.T + b`` for a weight ``w`` (out, in)."""
        y = self.matmul(x, w.T)
        return y if b is None else y + b.float()

    def project(self, x, w):
        """``x @ w`` for a projection matrix ``w`` (in, out)."""
        return self.matmul(x, w)

    def patch_embed(self, x, w):
        """Frames ``(n, H, W, C)`` → ``(n, N, D)`` through the patch
        kernel ``w`` (D, C, P, P): each patch's values, channel-major as
        the kernel's, times the kernel."""
        n, H, W, C = x.shape
        D, _, P, _ = w.shape
        patches = x.reshape(n, H // P, P, W // P, P, C).permute(
            0, 1, 3, 5, 2, 4).reshape(n, (H // P) * (W // P), C * P * P)
        return self.linear(patches, w.reshape(D, C * P * P))


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under its per-tensor scale."""
    scale = E4M3_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _fp8_ste(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 in the forward; the gradient passes as is."""
    return t + (fp8(t.detach()) - t).detach()


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8(a), fp8(b)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8(g)
        ga = torch.matmul(g8, b8.T)
        gb = torch.matmul(a8.reshape(-1, a8.shape[-1]).T,
                          g8.reshape(-1, g8.shape[-1]))
        return ga, gb
