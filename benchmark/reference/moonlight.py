"""Moonlight-16B-A3B with LaViLa's gated cross-attention, plain,
teacher-forced over whole sequences (no cache, no kernels), from
DeepSeek-V3's published equations at the sizes of the configuration file
(its catalog keys: ``hidden_size``, ``kv_lora_rank``, ...).

  * RMSNorm in float32 (``rms_norm_eps``; the latent's ``kv_a_layernorm``
    at the configuration's ``kv_norm_eps``).
  * MLA without query compression, k and v decompressed: ``q = W_q x``
    (``qk_nope_head_dim`` + ``qk_rope_head_dim`` a head), ``[c; k_rope] =
    W_kva x``, ``[k_nope; v] = W_kvb RMSNorm(c)``; RoPE (``rope_theta``)
    on q's rope part and on the one shared ``k_rope``, rotated as
    DeepSeek-V3's code does (interleaved pairs permuted to halves, then
    rotate-half); causal softmax of ``q·k / sqrt(nope + rope)``.
  * The FFN: the first ``first_k_dense_replace`` layers a SwiGLU of
    ``intermediate_size``; the others the expert layer, written as a loop
    over the routed experts: ``s = sigmoid(W_router x)``, the top
    ``num_experts_per_tok`` of ``s + e_score_correction_bias``, weights
    ``s`` of the chosen over their sum × ``routed_scaling_factor``, plus
    the shared SwiGLU of ``n_shared_experts × moe_intermediate_size``
    (the two stacked halves the port holds, joined into one).
  * Before every ``cross.freq``-th layer, LaViLa's gated block: LayerNorm
    → cross-attention over the visual tokens → × tanh(alpha_cattn), then
    LayerNorm → squared-ReLU MLP → × tanh(alpha_dense).

The weights may be held in bf16: every product upcasts its operands
(``Numerics``), so a 16 B-parameter model's reference fits the card.

Routing may follow the program's: ``routes[layer]`` holds the program's
chosen experts ``(B, L, k')`` for each position, and the reference takes
them, filled up to ``num_experts_per_tok`` by its own ranking of the
others, with its own scores and weights. Either way :func:`forward`
returns the largest route gap: over positions and expert layers, the
reference's best biased score outside the experts it used less its worst
biased score among those the program chose (below 0 where the program's
choice is the reference's top set; above 0 only where the two part,
which rounding does only at near-ties).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import tower
from benchmark.reference.models import narrator_visual
from benchmark.reference.numerics import Numerics
from benchmark.reference.tower import layer_norm


def spec(cfg: dict, prefix: str = "text_decoder.") -> list[tuple[str, tuple]]:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    C, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    E, S, I = (cfg["n_routed_experts"], cfg["n_shared_experts"],
               cfg["moe_intermediate_size"])
    cross = cfg["cross"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], D))]
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}."
        if i % cross["freq"] == 0:
            out += [(b + "alpha_cattn", ()), (b + "alpha_dense", ()),
                    (b + "ln_cross_attn.weight", (D,)),
                    (b + "ln_cross_attn.bias", (D,)),
                    (b + "crossattention.q_attn.weight", (D, D)),
                    (b + "crossattention.q_attn.bias", (D,)),
                    (b + "crossattention.c_attn.weight", (2 * D, D)),
                    (b + "crossattention.c_attn.bias", (2 * D,)),
                    (b + "crossattention.c_proj.weight", (D, D)),
                    (b + "crossattention.c_proj.bias", (D,)),
                    (b + "ln_2_crossattention.weight", (D,)),
                    (b + "ln_2_crossattention.bias", (D,)),
                    (b + "mlp_crossattention.c_fc.weight", (4 * D, D)),
                    (b + "mlp_crossattention.c_fc.bias", (4 * D,)),
                    (b + "mlp_crossattention.c_proj.weight", (D, 4 * D)),
                    (b + "mlp_crossattention.c_proj.bias", (D,))]
        out += [(b + "self_attn.q_proj.weight", (H * (dn + dr), D)),
                (b + "self_attn.kv_a_proj_with_mqa.weight", (C + dr, D)),
                (b + "self_attn.kv_a_layernorm.weight", (C,)),
                (b + "self_attn.kv_b_proj.weight", (H * (dn + dv), C)),
                (b + "self_attn.o_proj.weight", (D, H * dv)),
                (b + "input_layernorm.weight", (D,)),
                (b + "post_attention_layernorm.weight", (D,))]
        if i < cfg["first_k_dense_replace"]:
            Id = cfg["intermediate_size"]
            out += [(b + "mlp.gate_proj.weight", (Id, D)),
                    (b + "mlp.up_proj.weight", (Id, D)),
                    (b + "mlp.down_proj.weight", (D, Id))]
        else:
            out += [(b + "mlp.gate.weight", (E, D)),
                    (b + "mlp.gate.e_score_correction_bias", (E,)),
                    (b + "mlp.experts.gate_up", (E, 2 * I, D)),
                    (b + "mlp.experts.down", (E, D, I)),
                    (b + "mlp.shared_experts.gate_up", (S, 2 * I, D)),
                    (b + "mlp.shared_experts.down", (S, D, I))]
    out += [("model.norm.weight", (D,)),
            ("lm_head.weight", (cfg["vocab_size"], D))]
    return [(prefix + n, s) for n, s in out]


def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta: float):
    """DeepSeek-V3's rotation of the last dim; positions on dim -2."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = positions.double()[:, None] * inv[None]
    cos = torch.cat([ang, ang], -1).cos().float()
    sin = torch.cat([ang, ang], -1).sin().float()
    x = x.float()
    perm = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    rot = torch.cat([-perm[..., d // 2:], perm[..., :d // 2]], -1)
    return perm * cos + rot * sin


def swiglu(x, gate, up, down, num: Numerics):
    return num.linear(torch.nn.functional.silu(num.linear(x, gate))
                      * num.linear(x, up), down)


def expert_layer(p, b, x, cfg, num: Numerics, chosen=None):
    """The expert layer over ``x (n, D)``; ``chosen (n, k')`` the
    program's experts or None. Returns ``(y, route gap)``."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    I = cfg["moe_intermediate_size"]
    s = torch.sigmoid(num.linear(x, p[b + "gate.weight"]))
    z = s + p[b + "gate.e_score_correction_bias"].float()
    if chosen is None:
        used = torch.topk(z, k, dim=-1).indices
        chosen = used
    else:
        chosen = chosen.long()
        rest = z.scatter(-1, chosen, float("-inf"))
        used = torch.cat([chosen, torch.topk(rest, k - chosen.shape[-1],
                                             dim=-1).indices], -1)
    outside = z.scatter(-1, used, float("-inf")).amax(-1)
    gap = float((outside - z.gather(-1, chosen).amin(-1)).max())
    w = s.gather(-1, used)
    w = w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    gu, dn = p[b + "experts.gate_up"], p[b + "experts.down"]
    for e in range(E):
        rows, slot = (used == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], gu[e][:I], gu[e][I:], dn[e], num)
        y.index_add_(0, rows, w[rows, slot, None] * out)
    sg, sd = p[b + "shared_experts.gate_up"], p[b + "shared_experts.down"]
    shared = swiglu(x, torch.cat([g[:I] for g in sg]),
                    torch.cat([g[I:] for g in sg]),
                    torch.cat(list(sd), dim=1), num)
    return y + shared, gap


def forward(p: dict, ids: torch.Tensor, visual: torch.Tensor, cfg: dict,
            num: Numerics, routes: dict | None = None,
            prefix: str = "text_decoder.") -> tuple[torch.Tensor, float]:
    """Ids ``(B, L)`` and the visual tokens ``(B, S, D)`` → ``(logits
    (B, L, V) float32, the largest route gap)``; ``routes`` as the module
    docstring says."""
    p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    B, L = ids.shape
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    C, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    eps, cross = cfg["rms_norm_eps"], cfg["cross"]
    pos = torch.arange(L, device=ids.device)
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    x = p["model.embed_tokens.weight"][ids].float()
    gap = -math.inf
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}."
        if i % cross["freq"] == 0:
            x = cross_block(p, b, x, visual, cross, num)
        h = rms_norm(x, p[b + "input_layernorm.weight"], eps)
        q = num.linear(h, p[b + "self_attn.q_proj.weight"]).view(
            B, L, H, dn + dr).transpose(1, 2)
        c, k_rope = num.linear(
            h, p[b + "self_attn.kv_a_proj_with_mqa.weight"]).split([C, dr],
                                                                   -1)
        c = rms_norm(c, p[b + "self_attn.kv_a_layernorm.weight"],
                     cfg["kv_norm_eps"])
        kv = num.linear(c, p[b + "self_attn.kv_b_proj.weight"]).view(
            B, L, H, dn + dv).transpose(1, 2)
        k_rope = rope(k_rope, pos, cfg["rope_theta"])[:, None].expand(
            B, H, L, dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos,
                                         cfg["rope_theta"])], -1)
        k = torch.cat([kv[..., :dn], k_rope], -1)
        a = num.attend(q, k, kv[..., dn:], causal)
        x = x + num.linear(a.transpose(1, 2).reshape(B, L, H * dv),
                           p[b + "self_attn.o_proj.weight"])
        h = rms_norm(x, p[b + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            f = swiglu(h, p[b + "mlp.gate_proj.weight"],
                       p[b + "mlp.up_proj.weight"],
                       p[b + "mlp.down_proj.weight"], num)
        else:
            chosen = None if routes is None else routes[i].reshape(
                B * L, -1)
            f, g = expert_layer(p, b + "mlp.", h.reshape(B * L, D), cfg,
                                num, chosen)
            f = f.view(B, L, D)
            gap = max(gap, g)
        x = x + f
    x = rms_norm(x, p["model.norm.weight"], eps)
    return num.linear(x, p["lm_head.weight"]), gap


def cross_block(p, b, x, visual, cross: dict, num: Numerics):
    """LaViLa's gated cross-attention and MLP on the residual stream."""
    H, eps = cross["heads"], cross["eps"]
    B, L, D = x.shape
    d = D // H

    def lin(name, t):
        return num.linear(t, p[b + name + ".weight"], p[b + name + ".bias"])

    def ln(name, t):
        return layer_norm(t, p[b + name + ".weight"], p[b + name + ".bias"],
                          eps)

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, d).transpose(1, 2)

    q = heads(lin("crossattention.q_attn", ln("ln_cross_attn", x)))
    k, v = lin("crossattention.c_attn", visual).chunk(2, -1)
    a = num.attend(q, heads(k), heads(v)).transpose(1, 2).reshape(B, L, D)
    x = x + torch.tanh(p[b + "alpha_cattn"].float()) * lin(
        "crossattention.c_proj", a)
    f = torch.relu(lin("mlp_crossattention.c_fc",
                       ln("ln_2_crossattention", x))).square()
    return x + torch.tanh(p[b + "alpha_dense"].float()) * lin(
        "mlp_crossattention.c_proj", f)


# ---- the narrator: the TSF tower, LaViLa's pooler, the decoder above


def narrator_spec(cfg: dict) -> list[tuple[str, tuple]]:
    tw, D = cfg["tower"]["embed_dim"], cfg["hidden_size"]
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
            + spec(cfg))


def narrator_logits(p, frames, ids, cfg, num: Numerics,
                    routes: dict | None = None):
    """Teacher-forced ``(logits (B, L, V), route gap)`` of ``ids`` given
    the clips ``frames``."""
    return forward(p, ids, narrator_visual(p, frames, cfg, num), cfg, num,
                   routes)
