"""DistilBERT (``distilbert-base-uncased``'s layout), plain: word plus
learned position embeddings, LayerNorm (eps 1e-12), then post-LN blocks
of masked self-attention → add → LayerNorm → FFN (erf GELU) → add →
LayerNorm. Padded keys are masked out; every position is computed."""

from __future__ import annotations

import torch

from benchmark.reference.numerics import Numerics
from benchmark.reference.tower import layer_norm

EPS = 1e-12


def spec(cfg: dict, prefix: str = "textual.") -> list[tuple[str, tuple]]:
    D, Hd = cfg["dim"], cfg["hidden_dim"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], D)),
           ("embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], D)),
           ("embeddings.LayerNorm.weight", (D,)),
           ("embeddings.LayerNorm.bias", (D,))]
    for i in range(cfg["n_layers"]):
        b = f"transformer.layer.{i}."
        for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
            out += [(b + f"attention.{lin}.weight", (D, D)),
                    (b + f"attention.{lin}.bias", (D,))]
        out += [(b + "sa_layer_norm.weight", (D,)),
                (b + "sa_layer_norm.bias", (D,)),
                (b + "ffn.lin1.weight", (Hd, D)), (b + "ffn.lin1.bias", (Hd,)),
                (b + "ffn.lin2.weight", (D, Hd)), (b + "ffn.lin2.bias", (D,)),
                (b + "output_layer_norm.weight", (D,)),
                (b + "output_layer_norm.bias", (D,))]
    return [(prefix + n, s) for n, s in out]


def forward(p: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: dict,
            num: Numerics, prefix: str = "textual.") -> torch.Tensor:
    """Ids ``(B, L)`` and their {0, 1} mask → the last hidden state
    ``(B, L, D)``."""
    p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    B, L = ids.shape
    D, H = cfg["dim"], cfg["n_heads"]
    d = D // H
    x = (p["embeddings.word_embeddings.weight"][ids].float()
         + p["embeddings.position_embeddings.weight"][:L].float())
    x = layer_norm(x, p["embeddings.LayerNorm.weight"],
                   p["embeddings.LayerNorm.bias"], EPS)
    keep = (mask > 0)[:, None, None, :]                     # B,1,1,L

    def lin(name, t):
        return num.linear(t, p[name + ".weight"], p[name + ".bias"])

    for i in range(cfg["n_layers"]):
        b = f"transformer.layer.{i}."
        q, k, v = (lin(b + f"attention.{n}", x).reshape(B, L, H, d)
                   .transpose(1, 2) for n in ("q_lin", "k_lin", "v_lin"))
        a = num.attend(q, k, v, keep)
        a = lin(b + "attention.out_lin", a.transpose(1, 2).reshape(B, L, D))
        x = layer_norm(a + x, p[b + "sa_layer_norm.weight"],
                       p[b + "sa_layer_norm.bias"], EPS)
        f = torch.nn.functional.gelu(lin(b + "ffn.lin1", x))
        x = layer_norm(lin(b + "ffn.lin2", f) + x,
                       p[b + "output_layer_norm.weight"],
                       p[b + "output_layer_norm.bias"], EPS)
    return x

