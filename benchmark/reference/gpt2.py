"""LaViLa's gated GPT-2 decoder, plain, teacher-forced over whole
sequences (no cache): learned position embeddings, pre-LN blocks with
causal self-attention and a tanh-approximated GELU MLP, the LM head tied
to the token embedding. Every ``cross_attn_freq``-th layer (0, k, 2k,
...) first runs, on the same residual stream, LayerNorm →
cross-attention over the visual tokens → × tanh(alpha_cattn), then
LayerNorm → squared-ReLU MLP → × tanh(alpha_dense)."""

from __future__ import annotations

import torch

from benchmark.reference.numerics import Numerics
from benchmark.reference.tower import layer_norm


def spec(cfg: dict, prefix: str = "text_decoder.transformer."
         ) -> list[tuple[str, tuple]]:
    D = cfg["n_embd"]
    out = [("wte.weight", (cfg["vocab_size"], D)),
           ("wpe.weight", (cfg["n_positions"], D))]
    for i in range(cfg["n_layer"]):
        b = f"h.{i}."
        if i % cfg["cross_attn_freq"] == 0:
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
        out += [(b + "ln_1.weight", (D,)), (b + "ln_1.bias", (D,)),
                (b + "attn.c_attn.weight", (3 * D, D)),
                (b + "attn.c_attn.bias", (3 * D,)),
                (b + "attn.c_proj.weight", (D, D)),
                (b + "attn.c_proj.bias", (D,)),
                (b + "ln_2.weight", (D,)), (b + "ln_2.bias", (D,)),
                (b + "mlp.c_fc.weight", (4 * D, D)),
                (b + "mlp.c_fc.bias", (4 * D,)),
                (b + "mlp.c_proj.weight", (D, 4 * D)),
                (b + "mlp.c_proj.bias", (D,))]
    out += [("ln_f.weight", (D,)), ("ln_f.bias", (D,))]
    return [(prefix + n, s) for n, s in out]


def forward(p: dict, ids: torch.Tensor, visual: torch.Tensor, cfg: dict,
            num: Numerics, prefix: str = "text_decoder.transformer."
            ) -> torch.Tensor:
    """Ids ``(B, L)`` and the visual tokens ``(B, S, D)`` → logits
    ``(B, L, V)`` (float32)."""
    p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    B, L = ids.shape
    D, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    d = D // H

    def lin(name, t):
        return num.linear(t, p[name + ".weight"], p[name + ".bias"])

    def ln(name, t):
        return layer_norm(t, p[name + ".weight"], p[name + ".bias"], eps)

    def heads(t):  # (B, S, D) → (B, H, S, d)
        return t.reshape(t.shape[0], t.shape[1], H, d).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], D)

    x = p["wte.weight"][ids].float() + p["wpe.weight"][:L].float()
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    for i in range(cfg["n_layer"]):
        b = f"h.{i}."
        if i % cfg["cross_attn_freq"] == 0:
            q = heads(lin(b + "crossattention.q_attn",
                          ln(b + "ln_cross_attn", x)))
            k, v = lin(b + "crossattention.c_attn", visual).chunk(2, -1)
            a = lin(b + "crossattention.c_proj",
                    merge(num.attend(q, heads(k), heads(v))))
            x = x + torch.tanh(p[b + "alpha_cattn"].float()) * a
            f = torch.relu(lin(b + "mlp_crossattention.c_fc",
                               ln(b + "ln_2_crossattention", x))).square()
            x = x + torch.tanh(p[b + "alpha_dense"].float()) * lin(
                b + "mlp_crossattention.c_proj", f)
        q, k, v = (heads(t) for t in lin(b + "attn.c_attn",
                                         ln(b + "ln_1", x)).chunk(3, -1))
        x = x + lin(b + "attn.c_proj", merge(num.attend(q, k, v, causal)))
        f = torch.nn.functional.gelu(lin(b + "mlp.c_fc", ln(b + "ln_2", x)),
                                     approximate="tanh")
        x = x + lin(b + "mlp.c_proj", f)
    x = ln("ln_f", x)
    return num.linear(x, p["wte.weight"])
