"""SpaceTimeTransformer (TimeSformer, frozen-in-time order) video tower.

Counterpart of ``lavila_tpu/models/timesformer.py``; parameter names are
the reference LaViLa state-dict keys (``blocks.{i}.timeattn.qkv.weight``,
``blocks.{i}.norm3.weight``, ``patch_embed.proj.weight``, ...).

  * The public input is channel-last ``(B, T, H, W, C)``, as in the JAX
    package.
  * The tower carries the tokens CLS-separate, a ``(cls (B, 1, D),
    patches (B, F, N, D))`` pair, so the patch tensor reaches the
    divided-attention kernels in its natural token-major layout and no
    CLS concatenation or slice is made around them.
  * Block order (frozen-in-time): time attention on ``norm3``;
    ``norm1(time_out + x)``; spatial attention, whose residual goes back
    to the block input ``x``; then the MLP on ``norm2``. On the patch
    half the two residual norms are fused with their adds, as in the
    JAX block: ``norm1`` is K5 (the time residual feeds only the norm, so
    its sum is never stored) and ``norm2`` is K4 (the sum is the residual
    carry). The CLS half adds and then normalises with K3.
  * Positional embedding: the spatial PE tiled over frames plus the
    temporal PE; the CLS row takes ``pos_embed[0]``.
  * Time attention starts at zero: qkv weight and bias 0, proj weight 1,
    so a fresh block is a pure ViT block.
  * The configuration of the CLIP-initialised LaViLa TimeSformers (the
    defaults): ``ln_pre`` after the embeddings and a bias-free
    patch-embed conv, qkv bias, MLP ratio 4 with QuickGELU, RGB input.
    The CLIP_HF towers (``ln_pre=False``, ``act="gelu"``) have no
    ``ln_pre``, a patch-embed bias and the erf GELU, as the JAX
    ``SpaceTimeTransformer`` with ``ln_pre=False`` (its conv takes a bias
    exactly when there is no ``ln_pre``).
  * Stochastic depth (``drop_path_rate``, linear rule ``rate·i/(depth−1)``
    over the blocks) on the spatial-attention and the MLP residual, in
    ``train()`` mode only. Each of the two draws one mask per sample that
    the CLS row and the patches share, from the ``generator`` given to
    ``forward``; a block's masks are drawn before it runs and handed in.
  * Remat (``remat=True``, the JAX package's ``--use-checkpoint``): each
    block runs under ``torch.utils.checkpoint`` (non-reentrant), so only
    its inputs are kept and the backward runs its forward again, the
    JAX ``nn.remat`` per block with policy ``full``. The recompute
    reuses the masks drawn before the block (the checkpoint restores
    only torch's default generators, not the explicit one), so remat
    changes no gradient. The JAX policies that save some of the block
    (``dots``, ``save_attn``, ``dots_attn``) are not ported: the
    pretraining CLI refuses them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lavila_tpu_torch.ops.attention import divided_attention_split
from lavila_tpu_torch.ops.basic import (LayerNorm, Mlp, drop_path,
                                        drop_path_mask, init_linear_,
                                        lecun_normal_)


class DividedAttentionBlock(nn.Module):
    """QKV projection, divided attention of one phase, output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, cls, patches, axis: str):
        B, F, N, D = patches.shape
        H = self.num_heads
        d = D // H
        # chunks of the qkv output are row views with a row stride of 3D;
        # the kernels take the stride, so no copies are made
        qc, kc, vc = (t.reshape(B, 1, H, d)
                      for t in self.qkv(cls).chunk(3, dim=-1))
        qp, kp, vp = (t.reshape(B, F, N, H, d)
                      for t in self.qkv(patches).chunk(3, dim=-1))
        cls_out, p_out = divided_attention_split(qc, kc, vc, qp, kp, vp,
                                                 axis)
        return (self.proj(cls_out.reshape(B, 1, D)),
                self.proj(p_out.reshape(B, F, N, D)))


class SpaceTimeBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, drop_path_rate: float = 0.0,
                 act: str = "quick_gelu"):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.timeattn = DividedAttentionBlock(dim, num_heads)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = DividedAttentionBlock(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, act)

    def draw_masks(self, batch: int, generator, device, dtype):
        """The block's two stochastic-depth masks (spatial attention, then
        MLP), one draw per sample each, from ``generator``; None in eval
        mode or at rate 0."""
        rate = self.drop_path_rate
        if rate == 0.0 or not self.training:
            return None
        return tuple(drop_path_mask(batch, rate, generator, device, dtype)
                     for _ in range(2))

    def _drop_path(self, pair, mask):
        """Stochastic depth on a (CLS, patches) residual pair: one mask per
        sample for both halves (the JAX block's ``dp``)."""
        if mask is None:
            return pair
        return tuple(drop_path(y, self.drop_path_rate, mask) for y in pair)

    def forward(self, cls, patches, masks=None):
        """``masks``: :meth:`draw_masks`' pair, or None."""
        space_mask, mlp_mask = masks if masks is not None else (None, None)
        t_cls, t_pat = self.timeattn(self.norm3(cls), self.norm3(patches),
                                     "time")
        # the time residual feeds only norm1: K5 on the patch half
        s_cls, s_pat = self._drop_path(
            self.attn(self.norm1(cls + t_cls),
                      self.norm1(t_pat, residual=patches, return_sum=False),
                      "space"), space_mask)
        # frozen-in-time: the spatial residual reconnects to the block
        # input; on the patch half the sum is also norm2's input (K4)
        cls = cls + s_cls
        y2_pat, patches = self.norm2(s_pat, residual=patches)
        m_cls, m_pat = self._drop_path(
            (self.mlp(self.norm2(cls)), self.mlp(y2_pat)), mlp_mask)
        return cls + m_cls, patches + m_pat


class PatchEmbed(nn.Module):
    """Per-frame patch embedding, a strided conv (key
    ``patch_embed.proj``), bias-free unless ``bias``."""

    def __init__(self, patch_size: int, dim: int, bias: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size,
                              bias=bias)

    def forward(self, x):
        """``(B·T, H, W, C)`` channel-last → ``(B·T, N, D)``."""
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class SpaceTimeTransformer(nn.Module):
    """Video tower: frames ``(B, T, H, W, C)`` (already normalised) →
    the final-normed CLS feature ``(B, D)`` when ``cls_at_last``, else the
    normed joint sequence ``(B, 1 + T·N, D)``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_frames: int = 8, drop_path_rate: float = 0.0,
                 remat: bool = False, ln_pre: bool = True,
                 act: str = "quick_gelu"):
        super().__init__()
        D = embed_dim
        self.remat = remat
        self.num_frames = num_frames
        self.embed_dim = D
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, D, bias=not ln_pre)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1,
                                                  D))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames, D))
        self.ln_pre = LayerNorm(D) if ln_pre else None
        # stochastic depth decay rule: linear 0 → drop_path_rate
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(D, num_heads,
                           drop_path_rate * i / max(depth - 1, 1), act)
            for i in range(depth))
        self.norm = LayerNorm(D, eps=1e-6)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator``."""
        conv = self.patch_embed.proj
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        if conv.bias is not None:
            conv.bias.zero_()
        self.cls_token.zero_()
        nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04,
                              generator=generator)
        self.temporal_embed.zero_()
        for blk in self.blocks:
            init_linear_(blk.attn.qkv, generator)
            init_linear_(blk.attn.proj, generator)
            init_linear_(blk.mlp.fc1, generator)
            init_linear_(blk.mlp.fc2, generator)
            # zero-init time attention: the block starts as a pure ViT
            blk.timeattn.qkv.weight.zero_()
            blk.timeattn.qkv.bias.zero_()
            blk.timeattn.proj.weight.fill_(1.0)
            blk.timeattn.proj.bias.zero_()

    def forward(self, x: torch.Tensor, cls_at_last: bool = True,
                generator: torch.Generator | None = None):
        B, T, H, W, C = x.shape
        if T > self.num_frames:
            raise ValueError(f"{T} frames > num_frames={self.num_frames}")
        D, N = self.embed_dim, self.num_patches
        dtype = self.cls_token.dtype
        patches = self.patch_embed(x.reshape(B * T, H, W, C).to(dtype))
        patches = patches.reshape(B, T, N, D)
        # spatial PE tiled over frames, temporal PE over positions
        pe = self.pos_embed[:, None, 1:] + self.temporal_embed[:, :T, None]
        patches = patches + pe
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(
            B, 1, D).contiguous()
        if self.ln_pre is not None:
            cls, patches = self.ln_pre(cls), self.ln_pre(patches)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            masks = blk.draw_masks(B, generator, cls.device, cls.dtype)
            if remat:
                # the block draws no random numbers itself: nothing of
                # torch's generators needs stashing for the recompute
                cls, patches = checkpoint(blk, cls, patches, masks,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                cls, patches = blk(cls, patches, masks)
        if cls_at_last:
            return self.norm(cls)[:, 0]
        return self.norm(torch.cat([cls, patches.reshape(B, T * N, D)], 1))
