"""Weights drawn from the seed on the device, by parameter name and shape.

One generator on the device draws one flat normal tensor for the whole
model in the dtype it is held in; each parameter is a slice of it, scaled
by a rule on its name and shape:

  * a matrix ``(out, in)`` named ``*.weight`` (linear layers, embedding
    tables): std ``in ** -0.5``; a conv kernel: std ``fan_in ** -0.5``;
  * any other matrix (``image_projection`` (in, out), the image queries):
    std ``shape[0] ** -0.5``; other tensors of three dims (class and
    position embeddings): std 0.02;
  * a vector named ``weight`` or ``gamma`` (a LayerNorm's scale): 1 ±
    0.1; any other vector (biases): std 0.02;
  * a scalar: the value the configuration's ``scalars`` gives for its
    last name component (``logit_scale``, the narrator's gates).

Every weight is random, the time attention and the narrator's gates
included, so no branch of the model is the identity or zero. The same
seed, spec and device give the same values, so a run draws them again
for the reference instead of keeping a copy.
"""

from __future__ import annotations

import math
import zlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one stream of the run (weights, traffic, sampling)."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % 2 ** 63


def rule(name: str, shape: tuple, scalars: dict) -> tuple[float, float]:
    """(mean, std) of a parameter."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 0:
        return float(scalars[leaf]), 0.0
    if len(shape) == 1:
        return (1.0, 0.1) if leaf in ("weight", "gamma") else (0.0, 0.02)
    if len(shape) == 2:
        return 0.0, (shape[1] if leaf == "weight" else shape[0]) ** -0.5
    if len(shape) == 4:
        return 0.0, math.prod(shape[1:]) ** -0.5
    return 0.0, 0.02


@torch.no_grad()
def draw(spec: list[tuple[str, tuple]], seed: int, device, dtype,
         scalars: dict) -> dict[str, torch.Tensor]:
    """The parameters of ``spec``, as views into one flat draw."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        mean, std = rule(name, tuple(shape), scalars)
        t = flat[at:at + n].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
        at += n
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, which must have the
    same names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: not in the program {missing}, not "
                         f"in the reference {extra}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the program holds {tuple(p.shape)}, "
                             f"the reference {tuple(weights[name].shape)}")
        p.copy_(weights[name])
