"""LaViLa's two models, plain, and what trains the dual encoder.

  * The dual encoder (TSF tower + DistilBERT): the video feature times
    ``image_projection`` (in, out), the ``[CLS]`` row of DistilBERT
    times ``text_projection``, both L2-normalised when the recipe says
    so, and ``exp(logit_scale)``.
  * The CLIP loss: symmetric InfoNCE over the batch, diagonal labels.
  * AdamW as PyTorch defines it (decoupled weight decay, bias-corrected
    moments) over LaViLa's groups (no decay where ndim < 2 or the name
    holds ``bias``, ``ln`` or ``bn``), ``logit_scale`` clamped into
    [0, log 100] after each update.
  * The narrator (VCLM): the tower's normed tokens pooled onto 256
    learned queries by multi-query attention (bias-free LayerNorm on the
    queries and on the tokens, one shared K/V head), a bias-free
    LayerNorm, then the gated GPT-2 over them.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import distilbert, gpt2, tower
from benchmark.reference.numerics import Numerics
from benchmark.reference.tower import layer_norm

LOGIT_SCALE_MAX = math.log(100.0)


# ---- the dual encoder

def dual_encoder_spec(cfg: dict) -> list[tuple[str, tuple]]:
    E = cfg["project_embed_dim"]
    return (tower.spec(cfg["tower"]) + distilbert.spec(cfg["text"])
            + [("image_projection", (cfg["tower"]["embed_dim"], E)),
               ("text_projection", (cfg["text"]["dim"], E)),
               ("logit_scale", ())])


def encode_image(p, frames, cfg, num: Numerics, remat: bool = False):
    x = tower.forward(p, frames, cfg["tower"], num, remat=remat)
    return num.project(x, p["image_projection"])


def encode_text(p, ids, mask, cfg, num: Numerics):
    x = distilbert.forward(p, ids, mask, cfg["text"], num)[:, 0]
    return num.project(x, p["text_projection"])


def l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def clip_loss(p, batch, cfg, num: Numerics, remat: bool = False):
    """The symmetric InfoNCE loss of one batch (float32 scalar)."""
    ie = encode_image(p, batch["frames"], cfg, num, remat)
    te = encode_text(p, batch["text"], batch["mask"], cfg, num)
    if cfg["norm_embed"]:
        ie, te = l2_normalize(ie), l2_normalize(te)
    logits = p["logit_scale"].float().exp() * ie @ te.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(logits, labels) + ce(logits.T, labels))


def decays(name: str, shape) -> bool:
    """LaViLa's weight-decay groups (main_pretrain.py): decay only the
    tensors of two or more dims whose name holds none of bias/ln/bn."""
    return len(shape) >= 2 and not any(t in name.lower()
                                       for t in ("bias", "ln", "bn"))


class AdamW:
    """``torch.optim.AdamW``'s arithmetic over a dict of float32
    tensors, written out."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            if decays(k, p.shape):
                p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            if k.rsplit(".", 1)[-1] == "logit_scale":
                p.clamp_(0.0, LOGIT_SCALE_MAX)


# ---- the narrator

def narrator_spec(cfg: dict) -> list[tuple[str, tuple]]:
    tw, D = cfg["tower"]["embed_dim"], cfg["gpt2"]["n_embd"]
    pool = cfg["pooler"]
    inner = pool["heads"] * pool["dim_head"]
    return (tower.spec(cfg["tower"])
            + [("img_queries", (pool["num_queries"], D)),
               ("img_attn_pool.norm.gamma", (D,)),
               ("img_attn_pool.context_norm.gamma", (tw,)),
               ("img_attn_pool.to_q.weight", (inner, D)),
               ("img_attn_pool.to_kv.weight", (2 * pool["dim_head"], tw)),
               ("img_attn_pool.to_out.weight", (D, inner)),
               ("img_attn_pool_norm.gamma", (D,))]
            + gpt2.spec(cfg["gpt2"]))


def narrator_visual(p, frames, cfg, num: Numerics) -> torch.Tensor:
    """Frames → the pooled, normed image queries ``(B, Nq, D)``."""
    tokens = tower.forward(p, frames, cfg["tower"], num, cls_at_last=False)
    B = tokens.shape[0]
    pool = cfg["pooler"]
    H, d = pool["heads"], pool["dim_head"]
    q = layer_norm(p["img_queries"], p["img_attn_pool.norm.gamma"], None,
                   1e-5)
    q = num.linear(q, p["img_attn_pool.to_q.weight"])
    q = q.reshape(1, -1, H, d).transpose(1, 2).expand(B, H, -1, d)
    ctx = layer_norm(tokens, p["img_attn_pool.context_norm.gamma"], None,
                     1e-5)
    k, v = num.linear(ctx, p["img_attn_pool.to_kv.weight"]).chunk(2, -1)
    out = num.attend(q, k[:, None], v[:, None])   # B,H,Nq,d
    out = out.transpose(1, 2).reshape(B, -1, H * d)
    out = num.linear(out, p["img_attn_pool.to_out.weight"])
    return layer_norm(out, p["img_attn_pool_norm.gamma"], None, 1e-5)


def narrator_logits(p, frames, ids, cfg, num: Numerics) -> torch.Tensor:
    """Teacher-forced logits ``(B, L, V)`` of ``ids`` given the clips."""
    return gpt2.forward(p, ids, narrator_visual(p, frames, cfg, num),
                        cfg["gpt2"], num)
