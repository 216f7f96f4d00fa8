"""The TimeSformer's tanh gate on the time attention
(``timesformer_gated_xattn``) and its remat policies (``full``, ``dots``,
``save_attn``, ``dots_attn``) in the port against ``lavila_tpu``'s
``SpaceTimeTransformer`` on the same weights and numpy inputs, at a small
size (32², patch 16, 64 wide, 2 blocks, 4 heads, 4 frames), fp32 on the
CPU. The gate and the time attention are given seeded values: at their
zero init the gate is tanh(0) = 0 and the time attention's output is
constant across channels, so both the gate and K2 would be vacuous.
Forward atol 1e-5, loss relative 1e-5, gradients within 1e-4 of their
largest; each policy bit-equal to no remat in the port; the recompute's
launches of the divided phase as the policy predicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models.timesformer import SpaceTimeTransformer as JaxTSF
from lavila_tpu_torch.kernels import divided as KD
from lavila_tpu_torch.models import build_model, zoo
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.models.timesformer import (REMAT_POLICIES,
                                                 SpaceTimeTransformer)
from lavila_tpu_torch.train.step import working_copy

torch.set_num_threads(1)

GEOM = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            num_frames=4)
POLICIES = sorted(REMAT_POLICIES)


def _jax_tower(**kw):
    return JaxTSF(**GEOM, ln_pre=True, act="quick_gelu", **kw)


def _port_tower(**kw):
    return SpaceTimeTransformer(**GEOM, **kw)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(2, 64)).astype(np.float32)
    return frames, w


def _params(gated=True, seed=0):
    """The JAX tower's params: the time attention's qkv and proj given
    seeded noise and each block's gate 0.5 + noise."""
    frames, _ = _inputs()
    params = jax.tree.map(np.asarray, _jax_tower(is_tanh_gating=gated).init(
        jax.random.key(seed), jnp.asarray(frames))["params"])
    rng = np.random.default_rng(seed + 1)
    for name, blk in params.items():
        if not name.startswith("blocks_"):
            continue
        for lin in blk["timeattn"].values():
            for k, v in lin.items():
                lin[k] = (rng.normal(size=v.shape) * 0.2).astype(np.float32)
        if gated:
            blk["alpha_timeattn"] = np.float32(0.5 + 0.1 * rng.normal())
    return params


def _port_weights(params):
    """The JAX tower's params in the port's names, through ``convert``."""
    sd = state_dict_from_jax({"vision_model": params})
    return {k.removeprefix("visual."): v for k, v in sd.items()}


def _jax_loss_and_grads(params, frames, w, **kw):
    tower = _jax_tower(**kw)

    def loss(p):
        return jnp.sum(tower.apply({"params": p}, jnp.asarray(frames))
                       * jnp.asarray(w))
    value, grads = jax.value_and_grad(loss)(
        jax.tree.map(jnp.asarray, params))
    return float(value), _port_weights(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(model, frames, w):
    model.zero_grad()
    loss = (model(torch.from_numpy(frames)) * torch.from_numpy(w)).sum()
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    largest = max(w.abs().max().item() for w in want.values())
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * largest, (name, err, largest)


def test_gated_tower_matches_jax():
    """Forward, loss and every gradient (each block's ``alpha_timeattn``
    among them) of the gated tower against the JAX one."""
    params = _params()
    frames, w = _inputs()
    want = _jax_tower(is_tanh_gating=True).apply({"params": params},
                                                 jnp.asarray(frames))
    model = _port_tower(is_tanh_gating=True)
    model.load_state_dict(_port_weights(params), strict=True)
    assert model.blocks[0].alpha_timeattn.shape == ()
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    jloss, jgrads = _jax_loss_and_grads(params, frames, w,
                                        is_tanh_gating=True)
    ploss, pgrads = _port_loss_and_grads(model, frames, w)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
    assert pgrads["blocks.0.alpha_timeattn"].abs().item() > 0
    _assert_grads_close(pgrads, jgrads)


def test_gate_scales_the_time_attention():
    """tanh(alpha) multiplies both halves of the time attention's output:
    at alpha = 0 the gated tower is the ungated one with the time
    attention removed, and the gate's key is where JAX's importer reads
    it (``blocks.{i}.alpha_timeattn``)."""
    params = _params()
    frames, _ = _inputs()
    model = _port_tower(is_tanh_gating=True)
    model.load_state_dict(_port_weights(params), strict=True)
    assert "blocks.1.alpha_timeattn" in model.state_dict()
    with torch.no_grad():
        for blk in model.blocks:
            blk.alpha_timeattn.zero_()
        gated = model(torch.from_numpy(frames))
        for blk in model.blocks:
            blk.timeattn.proj.weight.zero_()
            blk.timeattn.proj.bias.zero_()
        no_time = model(torch.from_numpy(frames))
    torch.testing.assert_close(gated, no_time, atol=1e-6, rtol=0)
    fresh = _port_tower(is_tanh_gating=True)
    fresh.init_weights(torch.Generator().manual_seed(0))
    assert all(b.alpha_timeattn.item() == 0.0 for b in fresh.blocks)


def test_working_copy_keeps_the_gate_fp32():
    """The bf16 working copy keeps the 0-dim gate fp32, as the JAX
    package's bf16 compute keeps its params fp32; the gated bf16 forward
    runs."""
    model = _port_tower(is_tanh_gating=True)
    model.load_state_dict(_port_weights(_params()), strict=True)
    work = working_copy(model, torch.bfloat16)
    assert work.blocks[0].alpha_timeattn.dtype == torch.float32
    assert work.blocks[0].timeattn.qkv.weight.dtype == torch.bfloat16
    out = work(torch.from_numpy(_inputs()[0]))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["CLIP_OPENAI_TIMESFORMER_BASE",
                                  "VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL"])
def test_zoo_threads_the_gate_and_the_policy(name):
    """The TimeSformer zoo entries take ``timesformer_gated_xattn`` and
    ``remat_policy`` (built on the meta device: their parameters only)."""
    with torch.device("meta"):
        m = zoo._REGISTRY[name](timesformer_gated_xattn=True, remat=True,
                                remat_policy="save_attn")
    assert all(b.alpha_timeattn is not None for b in m.visual.blocks)
    assert m.visual.remat_policy == "save_attn"


def test_mini_takes_no_gate_as_jax():
    """The MINI towers take the gate's keyword and build no gate, as the
    JAX MINI factories swallow it."""
    m = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    timesformer_gated_xattn=True, remat=True,
                    remat_policy="dots")
    assert all(b.alpha_timeattn is None for b in m.visual.blocks)
    assert m.visual.remat_policy == "dots"


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax_and_no_remat(policy):
    """Each policy's loss and gradients against the JAX tower under the
    same policy, and bit-equal to the port without remat."""
    params = _params()
    frames, w = _inputs()
    jloss, jgrads = _jax_loss_and_grads(params, frames, w,
                                        is_tanh_gating=True, remat=True,
                                        remat_policy=policy)
    weights = _port_weights(params)
    plain = _port_tower(is_tanh_gating=True)
    plain.load_state_dict(weights, strict=True)
    model = _port_tower(is_tanh_gating=True, remat=True,
                        remat_policy=policy)
    model.load_state_dict(weights, strict=True)
    ploss, pgrads = _port_loss_and_grads(model, frames, w)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(pgrads, jgrads)
    bloss, bgrads = _port_loss_and_grads(plain, frames, w)
    assert ploss == bloss
    for name, g in bgrads.items():
        assert torch.equal(pgrads[name], g), name


@pytest.mark.parametrize("policy,per_block", [
    (None, 2), ("full", 4), ("dots", 4), ("save_attn", 2),
    ("dots_attn", 2)])
def test_remat_policy_launches(monkeypatch, policy, per_block):
    """The divided phase's forward runs once a phase a block under
    ``save_attn`` and ``dots_attn`` (the recompute keeps its outputs) and
    twice under ``full`` and ``dots``; its backward once whatever the
    policy (but at the last block's spatial phase, whose patch outputs
    never reach the CLS feature). Counted through the plain functions the
    wrappers call on a CPU tensor, as the kernels count their launches on
    the card."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("divided_phase_reference", "fwd"),
                      ("divided_phase_bwd_reference", "bwd")):
        fn = getattr(KD, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(KD, name, counted)
    model = _port_tower(is_tanh_gating=True, remat=policy is not None,
                        remat_policy=policy or "full")
    model.load_state_dict(_port_weights(_params()), strict=True)
    frames, w = _inputs()
    _port_loss_and_grads(model, frames, w)
    assert calls == {"fwd": per_block * GEOM["depth"],
                     "bwd": 2 * GEOM["depth"] - 1}


def test_unknown_policy_raises_naming_the_options():
    with pytest.raises(ValueError, match=r"remat_policy='bogus' unknown; "
                       r"one of \['dots', 'dots_attn', 'full', 'save_attn'\]"):
        _port_tower(remat=True, remat_policy="bogus")
    _port_tower(remat=False, remat_policy="bogus")  # unread without remat
