"""Model FLOPs from the configuration's sizes: the products of the
forward pass (2 operations a multiply-add), the attention's two products
included, elementwise work and the optimizer left out. A train step is
3 × the forward (the backward's two products per forward product);
remat's recompute is not counted, nor a program's redundant work (the
narrator's cross K/V is counted once per clip, not once per row)."""

from __future__ import annotations


def tower_forward(t: dict, clips: int) -> float:
    """The TimeSformer tower over ``clips`` clips of ``num_frames``."""
    D, P, F = t["embed_dim"], t["patch_size"], t["num_frames"]
    N = (t["img_size"] // P) ** 2
    L = 1 + F * N
    per_block = (32 * D * D * L                 # qkv, proj ×2; mlp 4D
                 + 4 * F * N * (N + 1) * D       # space phase
                 + 4 * F * N * (F + 1) * D       # time phase
                 + 2 * 4 * L * D)                # the CLS rows, both phases
    embed = 2 * F * N * 3 * P * P * D
    return clips * (t["depth"] * per_block + embed)


def distilbert_forward(c: dict, captions: int, length: int) -> float:
    D, Hd, L = c["dim"], c["hidden_dim"], length
    per_layer = 2 * L * (4 * D * D + 2 * D * Hd) + 4 * L * L * D
    return captions * c["n_layers"] * per_layer


def dual_encoder_forward(cfg: dict, clips: int, length: int) -> float:
    E = cfg["project_embed_dim"]
    proj = 2 * clips * (cfg["tower"]["embed_dim"] + cfg["text"]["dim"]) * E
    return (tower_forward(cfg["tower"], clips)
            + distilbert_forward(cfg["text"], clips, length) + proj
            + 2 * clips * clips * E)


def train_step(cfg: dict, batch: int, length: int) -> float:
    return 3 * dual_encoder_forward(cfg, batch, length)


def encode(cfg: dict, clips: int) -> float:
    return (tower_forward(cfg["tower"], clips)
            + 2 * clips * cfg["tower"]["embed_dim"] * cfg["project_embed_dim"])


def narrate(cfg: dict, clips: int, rows: int, steps: int) -> float:
    """Encode ``clips``, pool, cross K/V once a clip, then ``steps``
    cached decode steps of ``rows`` rows (step i attends i + 1 keys)."""
    t, g, pool = cfg["tower"], cfg["gpt2"], cfg["pooler"]
    D, V, Ld = g["n_embd"], g["vocab_size"], g["n_layer"]
    S = 1 + t["num_frames"] * (t["img_size"] // t["patch_size"]) ** 2
    Q, inner, dh = pool["num_queries"], pool["heads"] * pool["dim_head"], \
        pool["dim_head"]
    cross = sum(1 for i in range(Ld) if i % g["cross_attn_freq"] == 0)
    pooler = clips * (2 * S * t["embed_dim"] * 2 * dh + 2 * Q * D * inner
                      + 4 * pool["heads"] * Q * S * dh + 2 * Q * inner * D)
    cross_kv = clips * cross * 2 * Q * D * 2 * D
    per_row_step = (Ld * 24 * D * D + cross * (20 * D * D + 4 * Q * D)
                    + 2 * D * V)
    self_attn = rows * Ld * sum(4 * (i + 1) * D for i in range(steps))
    return (tower_forward(t, clips) + pooler + cross_kv
            + rows * steps * per_row_step + self_attn)
