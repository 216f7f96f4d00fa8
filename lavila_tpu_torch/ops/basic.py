"""Numerics building blocks shared by the model towers.

Counterpart of ``lavila_tpu/ops/basic.py``:

  * :class:`LayerNorm` takes fp32 statistics with the one-pass variance
    ``max(E[x²] − E[x]², 0)`` and returns the input dtype. Every
    LayerNorm of the port goes through :func:`kernels.layernorm.
    layer_norm` (K3) or, with a residual, :func:`kernels.layernorm.
    add_layer_norm` (K4, or K5 without the sum), its dispatch sites: the
    Triton kernels on a CUDA tensor, the plain versions on a CPU tensor,
    for any shape. :class:`BiasFreeLayerNorm` (CoCa's, ``use_bias=False``
    in the JAX package) goes through K3 with a zero bias.
  * :func:`quick_gelu` is CLIP's ``x · sigmoid(1.702 x)``;
    :func:`gelu_new` GPT-2's tanh-approximated GELU; :func:`squared_relu`
    Primer's ``relu(x)²`` (the narrator's cross-attention MLP).
  * :class:`Mlp` is fc1 → QuickGELU → fc2.
  * :func:`drop_path` is timm's stochastic depth, ``x / keep · mask``
    with one 0/1 draw per sample (:func:`drop_path_mask`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lavila_tpu_torch.kernels.layernorm import add_layer_norm, layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU (HF 'gelu_new')."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics.

    ``eps`` depends on the call site, as in the JAX package: 1e-6 for the
    video tower's block and final norms, 1e-5 (the default) for its
    ``ln_pre`` and for every text-tower norm."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                return_sum: bool = True):
        """``LN(x)``; with a ``residual``, the pair ``(LN(x + residual),
        x + residual)``, or ``LN(x + residual)`` alone when not
        ``return_sum`` (the JAX ``LayerNorm``'s contract). The residual is
        cast to x's dtype and the sum normalised in fp32."""
        if residual is None:
            return layer_norm(x, self.weight, self.bias, self.eps)
        return add_layer_norm(x, residual.to(x.dtype), self.weight,
                              self.bias, self.eps, return_sum)


class BiasFreeLayerNorm(nn.Module):
    """LayerNorm with a learned scale and no bias, named as the
    reference's CoCa LayerNorm (``gamma``). Its ``beta`` is a zero buffer
    outside the state dict, handed to :func:`layer_norm` as the bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.register_buffer("beta", torch.zeros(dim), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta, self.eps)


class Mlp(nn.Module):
    """Transformer MLP: fc1 → QuickGELU → fc2."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


def drop_path_mask(batch: int, rate: float,
                   generator: torch.Generator | None, device,
                   dtype) -> torch.Tensor:
    """One keep (1) / drop (0) draw per sample, kept with probability
    ``1 - rate``, from ``generator`` (torch's default generator when
    None), returned on ``device`` in ``dtype``."""
    where = generator.device if generator is not None else device
    u = torch.rand(batch, generator=generator, device=where)
    return (u < 1.0 - rate).to(device=device, dtype=dtype)


def drop_path(x: torch.Tensor, rate: float,
              mask: torch.Tensor) -> torch.Tensor:
    """Stochastic depth on the batch dim (timm DropPath semantics,
    ``lavila_tpu/ops/basic.py:drop_path``): ``x / keep · mask`` with
    ``mask`` (B,) from :func:`drop_path_mask`."""
    return x / (1.0 - rate) * mask.reshape((-1,) + (1,) * (x.dim() - 1))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at ±2σ, rescaled so
    its standard deviation is ``1/sqrt(fan_in)``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """lecun-normal weight, zero bias (flax ``nn.Dense`` defaults)."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        layer.bias.zero_()
