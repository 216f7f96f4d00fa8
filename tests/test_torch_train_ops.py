"""The pieces of the port's train step against the JAX package on the same
numpy inputs (fp32): the CLS row's gradient, ``clip_loss`` and its
gradient, the cosine schedule, the weight-decay mask leaf for leaf,
``clamp_logit_scale``; and stochastic depth, which has no JAX
counterpart to compare draws with (the two frameworks' random streams
differ), against its contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu import losses as JL
from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.ops import attention as JA
from lavila_tpu.train import optim as JO
from lavila_tpu_torch import losses as L
from lavila_tpu_torch.kernels.cls_row import (cls_row,
                                              cls_row_attention_reference)
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import torch_key
from lavila_tpu_torch.models.timesformer import SpaceTimeBlock
from lavila_tpu_torch.ops.basic import drop_path, drop_path_mask
from lavila_tpu_torch.train import optim as O

torch.set_num_threads(1)


# (B, F, N, H, d, packed): packed gives kp/vp as row views of one
# (B, F, N, 3D) projection output, as the attention block passes them
CLS_ROW_SHAPES = [
    (2, 4, 6, 3, 16, False),
    (2, 4, 5, 12, 64, False),   # TSF-B's heads at a small N
    (1, 16, 3, 3, 16, False),   # the fine-tunes' 16 frames
    (2, 4, 6, 4, 16, True),     # a tensor-parallel rank's 4 local heads
]


def _cls_row_inputs(B, F, N, H, d, packed, seed=0):
    rng = np.random.default_rng(seed)
    cls = [rng.normal(size=(B, 1, H, d)).astype(np.float32)
           for _ in range(3)]
    if packed:
        qkv = rng.normal(size=(B, F, N, 3 * H * d)).astype(np.float32)
        pat = [np.ascontiguousarray(a).reshape(B, F, N, H, d)
               for a in np.split(qkv, 3, axis=-1)[1:]]
    else:
        qkv = None
        pat = [rng.normal(size=(B, F, N, H, d)).astype(np.float32)
               for _ in range(2)]
    g = rng.normal(size=(B, 1, H, d)).astype(np.float32)
    return cls, pat, qkv, g


@pytest.mark.parametrize("B,F,N,H,d,packed", CLS_ROW_SHAPES)
def test_cls_row_grad_matches_jax_vjp(B, F, N, H, d, packed):
    """The port's fp32 CLS row (the operator ``lavila::cls_row``, its CPU
    path) against the JAX package's hand-written VJP
    (``_cls_row_vjp_fwd``, ``_cls_row_vjp_bwd``): value and every
    gradient, atol 1e-5; packed cases take kp/vp as strided row views.
    Autograd of the plain row (``cls_row_attention_reference``, which
    the kernels' tests and the chip's plain path compare with) too."""
    cls, pat, qkv, g = _cls_row_inputs(B, F, N, H, d, packed)
    want_out, res = JA._cls_row_vjp_fwd(*map(jnp.asarray, cls + pat))
    want = JA._cls_row_vjp_bwd(res, jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in cls]
    if packed:
        full = torch.from_numpy(qkv).requires_grad_()
        kp, vp = (t.reshape(B, F, N, H, d) for t in full.chunk(3, -1)[1:])
        assert kp.stride(2) == 3 * H * d  # a row view, not a copy
    else:
        full = None
        kp, vp = (torch.from_numpy(a).requires_grad_() for a in pat)
    wrt = leaves + ([full] if packed else [kp, vp])
    for fn in (cls_row, cls_row_attention_reference):
        out = fn(*leaves, kp, vp)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want_out), atol=1e-5, rtol=0)
        got = list(torch.autograd.grad(out, wrt, torch.from_numpy(g)))
        if packed:
            dq, dk, dv = got.pop().chunk(3, -1)
            assert not dq.any()
            got += [t.reshape(B, F, N, H, d) for t in (dk, dv)]
        for name, a, w in zip(("dcls_q", "dcls_k", "dcls_v", "dkp", "dvp"),
                              got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=f"{fn.__name__} "
                                                       f"{name}")


def test_cls_row_opcheck():
    """``torch.library.opcheck`` of ``lavila::cls_row`` on the CPU: its
    schema, autograd registration, fake tensor and AOT dispatch, on
    contiguous inputs and on row views."""
    from lavila_tpu_torch.kernels.cls_row import cls_row_op
    for shape in (CLS_ROW_SHAPES[0], CLS_ROW_SHAPES[3]):
        cls, pat, qkv, _ = _cls_row_inputs(*shape, seed=1)
        B, F, N, H, d, packed = shape
        args = [torch.from_numpy(a).requires_grad_() for a in cls]
        if packed:
            kv = torch.from_numpy(qkv).chunk(3, -1)[1:]
            args += [t.reshape(B, F, N, H, d).requires_grad_() for t in kv]
        else:
            args += [torch.from_numpy(a).requires_grad_() for a in pat]
        torch.library.opcheck(cls_row_op, args)


def test_clip_loss_value_and_grad_match_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(6, 16)).astype(np.float32)
    txt = rng.normal(size=(6, 16)).astype(np.float32)
    txt[2] = img[2]  # one clear match, so the accuracy is not all-or-none
    scale = np.float32(3.0)
    want = JL.clip_loss(jnp.asarray(img), jnp.asarray(txt),
                        jnp.asarray(scale))
    jgrads = jax.grad(lambda a, b, s: JL.clip_loss(a, b, s)["loss"],
                      argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(txt),
                                         jnp.asarray(scale))
    leaves = [torch.from_numpy(img).requires_grad_(),
              torch.from_numpy(txt).requires_grad_(),
              torch.tensor(scale, requires_grad=True)]
    got = L.clip_loss(*leaves)
    for k in ("loss", "clip_loss", "clip_acc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    for a, w in zip(torch.autograd.grad(got["loss"], leaves), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_other_losses_raise():
    """The local losses no longer raise: at a world of one (no process
    group) each is its global loss, values and gradients within 1e-6
    (their multi-rank parity is tests/test_torch_distributed.py's)."""
    rng = np.random.default_rng(2)
    img = rng.normal(size=(6, 16)).astype(np.float32)
    txt = rng.normal(size=(6, 16)).astype(np.float32)
    txt[1] = img[1]
    ind = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    cases = ((L.clip_loss, L.clip_loss_local, ()),
             (L.ssl_clip_loss, L.ssl_clip_loss_local,
              (torch.tensor(2.0), ind)))
    for glob, local, extra in cases:
        outs = []
        for fn in (glob, local):
            leaves = [torch.from_numpy(img).requires_grad_(),
                      torch.from_numpy(txt).requires_grad_(),
                      torch.tensor(4.0, requires_grad=True)]
            m = fn(*leaves, *extra)
            outs.append((m, torch.autograd.grad(m["loss"], leaves)))
        (gm, gg), (lm, lg) = outs
        assert lm.keys() == gm.keys()
        for k in gm:
            assert lm[k].item() == pytest.approx(gm[k].item(), rel=1e-6), k
        for a, b in zip(lg, gg):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 25, 39, 40])
def test_cosine_schedule_matches_jax(step):
    """Warm-up (steps 0-9), the boundary (10) and the cosine to the end
    (40 = epochs · steps_per_epoch)."""
    args = (3e-4, 1e-5, 4, 10)
    kw = dict(warmup_epochs=1, start_warmup_lr=1e-6)
    want = float(JO.cosine_schedule(*args, **kw)(step))
    assert O.cosine_schedule(*args, **kw)(step) == pytest.approx(
        want, rel=1e-6)


def _mini_jax_params():
    jm = jax_build_model("CLIP_OPENAI_TIMESFORMER_MINI")
    return jm.init(jax.random.key(0), jnp.zeros((1, 4, 64, 64, 3)),
                   jnp.zeros((1, 77), jnp.int32))["params"]


def test_wd_mask_matches_jax_leaf_for_leaf():
    params = _mini_jax_params()
    want = {}
    for path, decay in jax.tree_util.tree_flatten_with_path(
            JO.wd_mask(params))[0]:
        key, _ = torch_key(tuple(str(k.key) for k in path))
        want[key] = bool(decay)
    model = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    got = O.wd_mask(model.named_parameters())
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_clamp_logit_scale_matches_jax():
    for v in (-1.0, 2.0, 7.0):
        p = {"logit_scale": torch.nn.Parameter(torch.tensor(v)),
             "visual.pos_embed": torch.nn.Parameter(torch.full((2,), v))}
        O.clamp_logit_scale(p.items())
        want = JO.clamp_logit_scale({"logit_scale": jnp.asarray(v)})
        assert p["logit_scale"].item() == pytest.approx(
            float(want["logit_scale"]))
        assert (p["visual.pos_embed"] == v).all()  # only logit_scale


def test_optimizer_options_that_raise():
    p = [("w", torch.nn.Parameter(torch.zeros(2, 2)))]
    with pytest.raises(ValueError, match="update_freq"):
        O.make_optimizer(p, 1e-3, update_freq=0)
    with pytest.raises(ValueError):
        O.make_optimizer(p, 1e-3, clip_grad_type="max")


@pytest.mark.parametrize("kind,value", [("norm", 0.5), ("value", 0.05)])
def test_clipping_matches_optax(kind, value):
    """One clipped AdamW update equals optax's ``clip_by_global_norm`` /
    ``clip`` followed by ``adamw``."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    gw = rng.normal(size=(3, 4)).astype(np.float32)
    gb = rng.normal(size=(4,)).astype(np.float32)
    tx = JO.make_optimizer(1e-2, weight_decay=0.1, clip_grad_value=value,
                           clip_grad_type=kind)
    jp = {"w": jnp.asarray(w), "bias": jnp.asarray(b)}
    upd, _ = tx.update({"w": jnp.asarray(gw), "bias": jnp.asarray(gb)},
                       tx.init(jp), jp)
    want = jax.tree.map(lambda p, u: p + u, jp, upd)
    tp = {"w": torch.nn.Parameter(torch.from_numpy(w.copy())),
          "bias": torch.nn.Parameter(torch.from_numpy(b.copy()))}
    tp["w"].grad, tp["bias"].grad = torch.from_numpy(gw), torch.from_numpy(gb)
    opt = O.make_optimizer(tp.items(), 1e-2, weight_decay=0.1,
                           clip_grad_value=value, clip_grad_type=kind)
    opt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-6, rtol=0)


def test_drop_path_shares_one_mask_for_cls_and_patches():
    blk = SpaceTimeBlock(16, 2, drop_path_rate=0.5).train()
    cls, pat = torch.ones(64, 1, 16), torch.ones(64, 3, 5, 16)
    gen = torch.Generator().manual_seed(0)
    space_mask, mlp_mask = blk.draw_masks(64, gen, "cpu", torch.float32)
    assert not torch.equal(space_mask, mlp_mask)  # two draws
    a, b = blk._drop_path((cls, pat), space_mask)
    kept_cls = a.flatten(1).amax(1) > 0
    kept_pat = b.flatten(1).amax(1) > 0
    assert torch.equal(kept_cls, kept_pat)
    assert 0 < int(kept_cls.sum()) < 64  # some dropped, some kept
    # kept samples are rescaled by 1 / keep, dropped ones are zero
    assert set(a.unique().tolist()) == {0.0, 2.0}


def test_drop_path_is_identity_in_eval_mode_and_at_rate_zero():
    x = torch.randn(4, 1, 8)
    blk = SpaceTimeBlock(8, 2, drop_path_rate=0.3).eval()
    assert blk.draw_masks(4, None, "cpu", torch.float32) is None
    assert blk._drop_path((x, x), None)[0] is x
    blk0 = SpaceTimeBlock(8, 2).train()
    assert blk0.draw_masks(4, None, "cpu", torch.float32) is None
    assert blk0._drop_path((x, x), None)[1] is x
    mask = drop_path_mask(4, 0.25, torch.Generator().manual_seed(1), "cpu",
                          torch.float32)
    torch.testing.assert_close(drop_path(x, 0.25, mask),
                               x / 0.75 * mask[:, None, None])


def test_drop_path_rate_rule_is_linear_and_model_uses_it():
    m = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    drop_path_rate=0.2, train=True)
    depth = len(m.visual.blocks)
    assert [b.drop_path_rate for b in m.visual.blocks] == pytest.approx(
        [0.2 * i / (depth - 1) for i in range(depth)])
    assert m.training
    frames = torch.randn(8, 4, 64, 64, 3)
    a = m.encode_image(frames, torch.Generator().manual_seed(0))
    b = m.encode_image(frames, torch.Generator().manual_seed(0))
    c = m.encode_image(frames, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)  # the generator decides the masks
    assert not torch.allclose(a, c)
    m.eval()
    torch.testing.assert_close(m.encode_image(frames),
                               m.encode_image(frames, torch.Generator()))
    # remat (policy full) recomputes the blocks with the same masks
    r = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    drop_path_rate=0.2, train=True, remat=True)
    assert r.visual.remat
    torch.testing.assert_close(
        r.encode_image(frames, torch.Generator().manual_seed(0)), a)
    # a narrator with remat (both towers) builds and gives the same
    # teacher-forced logits as without, the same weights loaded
    kw = dict(device="cpu", gated_xattn=True, train=True)
    plain = build_model("VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI", **kw)
    vr = build_model("VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI", remat=True,
                     **kw)
    assert vr.visual.remat and vr.text_decoder.cfg.remat
    vr.load_state_dict(plain.state_dict())
    text = torch.randint(1, 50257, (8, 6), generator=torch.Generator()
                         .manual_seed(2))
    torch.testing.assert_close(vr(frames, text)["logits"],
                               plain(frames, text)["logits"])
