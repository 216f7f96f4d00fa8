"""Model FLOPs of a Moonlight narrator batch from the configuration's
sizes, frozen with the benchmark: 2 operations a multiply-add of the
forward's products over the active parameters (the 6 routed and the 2
shared experts a token takes, not all 64), the attention's products
included, elementwise work, routing and sampling left out. A decode step
of one row at position i (i + 1 cached latents) is counted as the
program computes it, with ``W_kvb`` absorbed: q, the latent and its rope
part, q's latent (nope × 512 a head), the scores over the latents and
the rope keys, the latent output, its value map (512 × 128 a head) and
``W_o``; the FFN; the cross blocks' query, output and MLP products and
their attention over the 256 pooled tokens; the LM head. Per batch: the
tower over every clip, the pooler, and the cross K/V once a clip."""

from __future__ import annotations

from benchmark.roofline.model_flops import tower_forward


def decode_row_step(cfg: dict, i: int) -> float:
    """One row's decode step at position ``i``."""
    D, H, V = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    C, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    I, Id = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    Q = cfg["pooler"]["num_queries"]
    n = i + 1
    attn = (D * H * (dn + dr) + D * (C + dr) + H * dn * C
            + H * (C + dr) * n + H * C * n + H * C * dv + H * dv * D)
    moe = D * cfg["n_routed_experts"] + (
        cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * 3 * D * I
    cross = sum(1 for j in range(L) if j % cfg["cross"]["freq"] == 0)
    macs = (L * attn + dense * 3 * D * Id + (L - dense) * moe
            + cross * (10 * D * D + 2 * Q * D) + D * V)
    return 2.0 * macs


def narrate(cfg: dict, clips: int, rows: int, steps: int) -> float:
    """Encode ``clips``, pool, the cross K/V once a clip, then ``steps``
    decode steps of ``rows`` rows."""
    t, pool = cfg["tower"], cfg["pooler"]
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    S = 1 + t["num_frames"] * (t["img_size"] // t["patch_size"]) ** 2
    Q, inner, dh = pool["num_queries"], pool["heads"] * pool["dim_head"], \
        pool["dim_head"]
    cross = sum(1 for j in range(L) if j % cfg["cross"]["freq"] == 0)
    pooler = clips * (2 * S * t["embed_dim"] * 2 * dh + 2 * Q * D * inner
                      + 4 * pool["heads"] * Q * S * dh + 2 * Q * inner * D)
    cross_kv = clips * cross * 2 * Q * D * 2 * D
    decode = rows * sum(decode_row_step(cfg, i) for i in range(steps))
    return tower_forward(t, clips) + pooler + cross_kv + decode
