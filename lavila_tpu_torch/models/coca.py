"""CoCa-style attention pooler: visual tokens → learned image queries.

Counterpart of ``lavila_tpu/models/coca.py:AttentionPooler``, with the
reference state-dict names (``norm.gamma``, ``context_norm.gamma``,
``to_q``, ``to_kv``, ``to_out``). Multi-query attention: ``to_kv``
projects the context to one shared K/V head of ``dim_head`` that every
query head attends to. Bias-free pre-LN on the queries and the context,
a max-subtracted softmax in fp32. Plain PyTorch, as in the JAX package
(no Pallas there). The optional SwiGLU branch (``parallel_ff``) is used
by no zoo entry and is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from lavila_tpu_torch.ops.basic import BiasFreeLayerNorm
from lavila_tpu_torch.parallel.tensor import copy_to


class AttentionPooler(nn.Module):
    def __init__(self, dim: int, context_dim: int, dim_head: int = 64,
                 heads: int = 8, norm_context: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.head_dim = dim_head
        inner = heads * dim_head
        self.norm = BiasFreeLayerNorm(dim)
        self.context_norm = (BiasFreeLayerNorm(context_dim) if norm_context
                             else nn.Identity())
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, 2 * dim_head, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        # the model group under tensor parallelism (parallel/sharding.py)
        self.tp = None

    def forward(self, queries: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """queries ``(B, Nq, dim)``, context ``(B, S, context_dim)`` →
        ``(B, Nq, dim)``."""
        B, Nq, _ = queries.shape
        d = self.dim_head
        H = self.to_q.out_features // d  # the heads held here
        q = self.to_q(self.norm(queries)).reshape(B, Nq, H, d) * d ** -0.5
        kv = self.to_kv(self.context_norm(context))
        if self.tp is not None:
            # tensor parallel: every rank's heads read the one K/V head,
            # so its gradient is the sum of the ranks'
            kv = copy_to(kv, self.tp.group)
        k, v = kv.chunk(2, dim=-1)
        sim = torch.einsum("bqhd,bkd->bhqk", q.float(), k.float())
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkd->bqhd", attn, v).reshape(B, Nq, H * d)
        return self.to_out(out)
