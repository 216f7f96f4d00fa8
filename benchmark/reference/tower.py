"""TimeSformer video tower (divided space-time attention, frozen-in-time
block order), plain.

The tokens are one joint sequence ``[cls, frame 0's N patches, ...,
frame F-1's]`` of ``1 + F·N`` rows. In each block:

  * time attention on ``norm3(x)``: each patch attends to its own
    position in every frame and to the CLS token; the CLS token attends
    to every token;
  * ``y = norm1(x + time_out)``; space attention on ``y``: each patch
    attends to the patches of its own frame and to the CLS token; the
    CLS token to every token;
  * ``x = x + space_out`` (the residual skips the time branch);
    ``x = x + mlp(norm2(x))``, the MLP fc1 → QuickGELU → fc2.

Before the blocks: the patch embedding (a bias-free conv of stride =
patch), the spatial position embedding tiled over the frames plus the
temporal one, the CLS token plus position 0, then ``ln_pre`` (eps 1e-5).
Block norms and the final norm take eps 1e-6. The output is the normed
CLS row, or every normed token (the narrator's encoder).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.numerics import Numerics


def spec(cfg: dict, prefix: str = "visual.") -> list[tuple[str, tuple]]:
    """The tower's parameters, (name, shape), in the port's naming."""
    D, P = cfg["embed_dim"], cfg["patch_size"]
    N = (cfg["img_size"] // P) ** 2
    out = [("cls_token", (1, 1, D)), ("pos_embed", (1, N + 1, D)),
           ("temporal_embed", (1, cfg["num_frames"], D)),
           ("patch_embed.proj.weight", (D, 3, P, P))]
    if cfg.get("ln_pre", True):
        out += [("ln_pre.weight", (D,)), ("ln_pre.bias", (D,))]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm3.weight", (D,)), (b + "norm3.bias", (D,))]
        for a in ("timeattn", "attn"):
            out += [(b + a + ".qkv.weight", (3 * D, D)),
                    (b + a + ".qkv.bias", (3 * D,)),
                    (b + a + ".proj.weight", (D, D)),
                    (b + a + ".proj.bias", (D,))]
            if a == "timeattn":
                out += [(b + "norm1.weight", (D,)), (b + "norm1.bias", (D,))]
        out += [(b + "norm2.weight", (D,)), (b + "norm2.bias", (D,)),
                (b + "mlp.fc1.weight", (4 * D, D)),
                (b + "mlp.fc1.bias", (4 * D,)),
                (b + "mlp.fc2.weight", (D, 4 * D)),
                (b + "mlp.fc2.bias", (D,))]
    out += [("norm.weight", (D,)), ("norm.bias", (D,))]
    return [(prefix + n, s) for n, s in out]


def layer_norm(x, w, b, eps: float):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * w.float()
    return y if b is None else y + b.float()


def divided_attention(x, p, pre, F, N, H, axis, num: Numerics):
    """One divided phase over the joint sequence ``x`` (B, 1+F·N, D)."""
    B, L, D = x.shape
    d = D // H
    qkv = num.linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"])
    q, k, v = qkv.reshape(B, L, 3, H, d).permute(2, 0, 3, 1, 4)  # B,H,L,d
    cls_out = num.attend(q[:, :, :1], k, v)                       # B,H,1,d

    def groups(t):  # the patches, (B, H, F, N, d) → (B, H, G, S, d)
        t = t[:, :, 1:].reshape(B, H, F, N, d)
        return t if axis == "space" else t.transpose(2, 3)

    G = F if axis == "space" else N
    ck = k[:, :, :1, None].expand(B, H, G, 1, d)
    cv = v[:, :, :1, None].expand(B, H, G, 1, d)
    out = num.attend(groups(q), torch.cat([ck, groups(k)], 3),
                     torch.cat([cv, groups(v)], 3))
    if axis == "time":
        out = out.transpose(2, 3)
    out = torch.cat([cls_out, out.reshape(B, H, F * N, d)], 2)
    out = out.permute(0, 2, 1, 3).reshape(B, L, D)
    return num.linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"])


def block(x, p, b, F, N, H, num: Numerics):
    def ln(name, t):
        return layer_norm(t, p[b + name + ".weight"], p[b + name + ".bias"],
                          1e-6)
    t = divided_attention(ln("norm3", x), p, b + "timeattn.", F, N, H,
                          "time", num)
    s = divided_attention(ln("norm1", x + t), p, b + "attn.", F, N, H,
                          "space", num)
    x = x + s
    h = num.linear(ln("norm2", x), p[b + "mlp.fc1.weight"],
                   p[b + "mlp.fc1.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + num.linear(h, p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"])


def forward(p: dict, frames: torch.Tensor, cfg: dict, num: Numerics,
            cls_at_last: bool = True, remat: bool = False,
            prefix: str = "visual.") -> torch.Tensor:
    """Frames ``(B, T, H, W, C)`` → the normed CLS feature ``(B, D)``, or
    every normed token ``(B, 1 + T·N, D)``. ``remat`` recomputes each
    block in the backward (memory only: the values are the same)."""
    p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    B, T, Hh, W, C = frames.shape
    D, P, H = cfg["embed_dim"], cfg["patch_size"], cfg["num_heads"]
    N = (Hh // P) * (W // P)
    pat = num.patch_embed(frames.float().reshape(B * T, Hh, W, C),
                          p["patch_embed.proj.weight"]).reshape(B, T, N, D)
    pat = pat + p["pos_embed"][:, None, 1:] + p["temporal_embed"][:, :T, None]
    cls = (p["cls_token"] + p["pos_embed"][:, :1]).expand(B, 1, D)
    x = torch.cat([cls, pat.reshape(B, T * N, D)], 1)
    if "ln_pre.weight" in p:
        x = layer_norm(x, p["ln_pre.weight"], p["ln_pre.bias"], 1e-5)
    for i in range(cfg["depth"]):
        args = (p, f"blocks.{i}.", T, N, H, num)
        x = (checkpoint(block, x, *args, use_reentrant=False) if remat
             else block(x, *args))
    if cls_at_last:
        x = x[:, 0]
    return layer_norm(x, p["norm.weight"], p["norm.bias"], 1e-6)
