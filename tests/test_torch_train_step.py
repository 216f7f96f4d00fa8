"""The port's train step against ``lavila_tpu``'s: three AdamW steps on
MINI from one JAX init (fp32), the bf16 step's dtypes at the kernel
sites, and checkpoint save → resume → one more step against three
straight steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_clip_train_step as jax_train_step
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_clip_train_step
from lavila_tpu_torch.utils.checkpoints import CheckpointManager

torch.set_num_threads(1)

MINI = "CLIP_OPENAI_TIMESFORMER_MINI"
# warm-up from 1e-4 to 1e-3 over 2 steps, then cosine: the three steps
# use 1e-4, 5.5e-4 and 1e-3
SCHEDULE = dict(base_lr=1e-3, final_lr=1e-4, epochs=2, steps_per_epoch=2,
                warmup_epochs=1, start_warmup_lr=1e-4)
OPTIM = dict(weight_decay=0.1, clip_grad_value=5.0, clip_grad_type="norm")


def _batches(n, B=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.normal(size=(B, 4, 64, 64, 3)).astype(np.float32)
        text = rng.integers(1, 49407, size=(B, 77)).astype(np.int32)
        text[np.arange(B), rng.integers(5, 77, size=B)] = 49407  # EOT
        out.append((frames, text))
    return out


def _jax_params(seed=0):
    jm = jax_build_model(MINI)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 4, 64, 64, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    # time attention away from its zero init, so K2's path is not vacuous
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return jm, params


def _port_state(params, dtype=torch.float32):
    model = build_model(MINI, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return TrainState.create(model, lambda p: O.make_optimizer(
        p, O.cosine_schedule(**SCHEDULE), **OPTIM), dtype=dtype)


def _torch_batch(frames, text):
    return {"frames": torch.from_numpy(frames),
            "text": torch.from_numpy(text.astype(np.int64))}


def test_three_adamw_steps_match_jax():
    """Per-step loss within 1e-5 relative. Final parameters: Adam divides
    by √v, so an element whose gradient is at the level of fp32 rounding
    noise can move by up to lr per step in either framework whatever the
    other does; every element is bounded by that (2·Σ lr), and all but a
    thousandth of them must agree within 1e-5."""
    jm, params = _jax_params()
    tx = JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_train_step(jm))
    state = _port_state(params)
    step = make_clip_train_step()
    for frames, text in _batches(3):
        jstate, jm_ = jstep(jstate, {"frames": jnp.asarray(frames),
                                     "text": jnp.asarray(text)})
        state, m = step(state, _torch_batch(frames, text))
        assert m["loss"].item() == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-5)
        assert m["clip_acc"].item() == pytest.approx(float(jm_["clip_acc"]))
    assert state.step == int(jstate.step) == 3
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t) for t in range(3))
    far = total = 0
    for name, p in state.params.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    assert 0.0 <= state.params["logit_scale"].item() <= 4.6052


def test_bf16_step_dtypes(monkeypatch):
    """In a bf16 step the q/k/v reaching the divided phases and the rows
    reaching every LayerNorm are bf16 (the residual stream stays bf16),
    while the optimizer's parameters, and the LayerNorm γ/β and
    logit_scale of the working copy, are fp32."""
    import lavila_tpu_torch.ops.attention as A
    import lavila_tpu_torch.ops.basic as B
    seen = {"phase": set(), "ln_x": set(), "ln_w": set()}

    def phase(qp, kp, vp, ck, cv, *args):
        seen["phase"].update({qp.dtype, kp.dtype, vp.dtype, ck.dtype})
        return A_phase(qp, kp, vp, ck, cv, *args)

    def ln(x, w, b, eps):
        seen["ln_x"].add(x.dtype)
        seen["ln_w"].update({w.dtype, b.dtype})
        return B_ln(x, w, b, eps)

    A_phase, B_ln = A.divided_phase, B.layer_norm
    monkeypatch.setattr(A, "divided_phase", phase)
    monkeypatch.setattr(B, "layer_norm", ln)
    _, params = _jax_params()
    state = _port_state(params, torch.bfloat16)
    state, m = make_clip_train_step()(state, _torch_batch(*_batches(1)[0]))
    assert seen == {"phase": {torch.bfloat16}, "ln_x": {torch.bfloat16},
                    "ln_w": {torch.float32}}
    assert torch.isfinite(m["loss"])
    assert state.has_copy
    opt_params = [p for g in state.optimizer.inner.param_groups
                  for p in g["params"]]
    assert len(opt_params) == len(state.params)
    assert all(p.dtype == torch.float32 for p in opt_params)
    work = dict(state.model.named_parameters())
    assert work["logit_scale"].dtype == torch.float32
    assert work["visual.blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    # the working copy holds the updated masters, rounded to bf16
    for name, p in work.items():
        assert torch.equal(p, state.params[name].to(p.dtype)), name


def test_fp32_step_has_no_copy():
    _, params = _jax_params()
    state = _port_state(params, torch.float32)
    assert not state.has_copy
    assert next(state.model.parameters()) is next(iter(
        state.params.values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_resume_equals_straight_steps(tmp_path, dtype):
    _, params = _jax_params()
    batches = [_torch_batch(*b) for b in _batches(3, seed=5)]
    step = make_clip_train_step()
    straight = _port_state(params, dtype)
    for b in batches:
        straight, _ = step(straight, b)

    first = _port_state(params, dtype)
    for b in batches[:2]:
        first, _ = step(first, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first.state_dict(), epoch=0, config={"model": MINI})
    resumed = _port_state(params, dtype)
    tree, meta = mgr.restore("latest")
    resumed.load_state_dict(tree)
    assert resumed.step == 2 and meta["epoch"] == 0
    resumed, _ = step(resumed, batches[2])
    assert resumed.step == 3
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name
    for name, p in straight.model.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[name])


def test_checkpoint_manager_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for epoch in range(3):
        mgr.save({"step": epoch}, epoch=epoch, config={"model": MINI},
                 metrics={"best_metric": float(epoch)}, is_best=epoch == 1,
                 keep_epoch=epoch != 2)
    files = sorted(p.name for p in tmp_path.iterdir())
    # epoch 0 pruned by max_to_keep; epoch 2 not kept; latest is epoch 2
    assert files == ["checkpoint_0001.pt", "checkpoint_0001.pt.json",
                     "checkpoint_best.pt", "checkpoint_best.pt.json",
                     "checkpoint_latest.pt", "checkpoint_latest.pt.json"]
    assert mgr.restore("latest")[0] == {"step": 2}
    assert mgr.restore("best")[1]["epoch"] == 1
    assert mgr.restore(str(tmp_path / "checkpoint_0001.pt"))[0] == {"step": 1}


def test_resolve_resume_prefers_output_dir(tmp_path):
    from lavila_tpu_torch.utils.checkpoints import resolve_resume
    assert resolve_resume(str(tmp_path), "elsewhere.pt") == "elsewhere.pt"
    CheckpointManager(str(tmp_path)).save({}, epoch=0)
    assert resolve_resume(str(tmp_path), "elsewhere.pt") == str(
        tmp_path / "checkpoint_latest.pt")
