"""CLIP's ModifiedResNet image tower (RN50, RN101).

Counterpart of ``lavila_tpu/models/resnet_clip.py`` (the reference's
lavila/models/openai_model.py:21-165), under OpenAI's state-dict names
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``attnpool.q_proj``, ...), so a released RN checkpoint's ``visual.*``
loads through ``convert.import_resnet_clip``. No zoo entry or CLI of the
JAX package reaches it; it is here for the zoo's completeness, as there.

  * The input is channel-last ``(B, H, W, 3)``, as the JAX module's and
    the port's TimeSformer's; the convolutions run channel-first.
  * The stem is three 3x3 convolutions (the first strided) then a 2x2
    average pool; a strided :class:`Bottleneck` average-pools before its
    last 1x1 convolution and on its shortcut (anti-aliased strides).
  * :class:`BatchNorm` always normalises with the running statistics,
    as the JAX ``BatchNorm`` does with the imported ones: the RN towers
    run frozen. ``nn.BatchNorm2d`` in ``train()`` mode would use the
    batch's instead.
  * :class:`AttentionPool2d`: the tokens' mean first, the positional
    embedding, one query (the mean token's) over every token, through
    ``ops/attention.full_attention`` (K7 under inference, K8 in
    training, on a CUDA tensor; scaled by d^-0.5, fp32 scores), then
    ``c_proj``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from lavila_tpu_torch.ops.attention import full_attention
from lavila_tpu_torch.ops.basic import init_linear_, lecun_normal_


class BatchNorm(nn.Module):
    """BatchNorm2d's parameters and running statistics, always applied as
    in eval mode, in fp32: ``(x − mean) · rsqrt(var + eps) · weight +
    bias`` over the channel axis of ``(B, C, H, W)``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def channel(t):
            return t.float()[None, :, None, None]
        scale = torch.rsqrt(channel(self.running_var) + self.eps) \
            * channel(self.weight)
        y = (x.float() - channel(self.running_mean)) * scale \
            + channel(self.bias)
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            # OpenAI's names: "-1" the pool, "0" the conv, "1" the norm
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1
                 else nn.Identity()),
                ("0", _conv(inplanes, out, 1)), ("1", BatchNorm(out))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(self.avgpool(y)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C, H, W)`` → ``(B, output_dim)``."""
        B, C = x.shape[:2]
        H = self.num_heads
        toks = x.flatten(2).transpose(1, 2)                  # (B, HW, C)
        toks = torch.cat([toks.mean(1, keepdim=True), toks], 1)
        toks = toks + self.positional_embedding.to(toks.dtype)
        q = self.q_proj(toks[:, :1]).reshape(B, 1, H, C // H)
        k = self.k_proj(toks).reshape(B, -1, H, C // H)
        v = self.v_proj(toks).reshape(B, -1, H, C // H)
        return self.c_proj(full_attention(q, k, v).reshape(B, C))


class ModifiedResNet(nn.Module):
    """RN50 by default: stages of (3, 4, 6, 3) bottlenecks, width 64,
    224² input, a 32-head attention pool to 1024."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        w = width
        self.conv1 = _conv(3, w // 2, 3, stride=2)
        self.bn1 = BatchNorm(w // 2)
        self.conv2 = _conv(w // 2, w // 2, 3)
        self.bn2 = BatchNorm(w // 2)
        self.conv3 = _conv(w // 2, w, 3)
        self.bn3 = BatchNorm(w)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = w
        for stage, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes = w << stage
            stack = []
            for b in range(blocks):
                stack.append(Bottleneck(inplanes, planes,
                                        stride if b == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stack))
        self.attnpool = AttentionPool2d(input_resolution // 32, inplanes,
                                        heads, output_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``:
        lecun-normal convolutions and Linears, zero biases, the norms at
        scale 1, shift 0, mean 0, variance 1, the positional embedding
        normal with std C^-0.5."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        pe = self.attnpool.positional_embedding
        pe.normal_(0.0, pe.shape[1] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images ``(B, H, W, 3)`` → ``(B, output_dim)``."""
        dtype = self.conv1.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = torch.relu(bn(conv(x)))
        x = self.avgpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)
