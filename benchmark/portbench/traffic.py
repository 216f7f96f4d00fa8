"""The one generator of the benchmark's inputs, from a traffic file's
parameters and the seed, on the device.

Every cell's inputs are a small pool of batches made during set-up and
cycled through the window, so making them costs nothing inside it:

  * clips: ``pool × batch`` clips of ``frames`` frames at the tower's
    image size, standard normal values (frames already normalised), in
    the dtype the program takes;
  * captions (``captions``): WordPiece ids, ``[CLS]`` first and ``[SEP]``
    last, padded with ``pad_id`` to ``text_len``, with their {0, 1}
    mask. The lengths (both special tokens counted) are a fixed set,
    the quantiles of a log-normal of the given median and sigma clipped
    to [min, max], so every seed has the same lengths in another order
    and the work does not change with the seed.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.portbench.weights import sub_seed


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def clips(t: dict, tower: dict, seed: int, device, dtype) -> torch.Tensor:
    """``(pool, batch, frames, H, W, 3)``."""
    size = tower["img_size"]
    return torch.randn(t["pool"], t["batch"], t["frames"], size, size, 3,
                       generator=generator(seed, "clips", device),
                       device=device, dtype=dtype)


def caption_lengths(c: dict, n: int) -> list[int]:
    """``n`` lengths: the log-normal's quantiles at (i + 0.5) / n."""
    dist = statistics.NormalDist()
    lo, hi = c["min"], c["max"]
    out = []
    for i in range(n):
        z = dist.inv_cdf((i + 0.5) / n)
        x = round(c["median"] * 2.718281828459045 ** (c["sigma"] * z))
        out.append(min(max(x, lo), hi))
    return out


def captions(t: dict, seed: int, device) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``ids`` and ``mask``, each ``(pool, batch, text_len)`` int64."""
    c = t["captions"]
    P, B, L = t["pool"], t["batch"], c["text_len"]
    gen = generator(seed, "captions", device)
    lengths = torch.tensor(caption_lengths(c, P * B), device=device)
    lengths = lengths[torch.randperm(P * B, generator=gen, device=device)]
    ids = torch.randint(c["vocab_low"], c["vocab_high"], (P * B, L),
                        generator=gen, device=device)
    pos = torch.arange(L, device=device)[None]
    mask = (pos < lengths[:, None]).long()
    ids = torch.where(mask > 0, ids, c["pad_id"])
    ids[:, 0] = c["cls_id"]
    ids.scatter_(1, (lengths - 1)[:, None], c["sep_id"])
    return ids.reshape(P, B, L), mask.reshape(P, B, L)
