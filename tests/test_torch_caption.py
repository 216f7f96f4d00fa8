"""The narrator's training in the port against ``lavila_tpu``, on the CPU
at MINI size (``VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI``), fp32,
drop-path 0, the cross-attention gates and the time attention away from
their zero init: the caption loss, the teacher-forced logits, the
caption step under each combination of the VCLM freeze flags (frozen
parameters bit-equal and without a gradient), GPT-2's remat, the bf16
working copy's fp32 parameters, and the pretraining CLI's VCLM branch,
whose checkpoint the port's narrator CLIs read."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu import losses as JL
from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.train import freeze as JF
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_caption_train_step as jax_caption_step
from lavila_tpu_torch import losses as L
from lavila_tpu_torch.cli import main_infer_narrator
from lavila_tpu_torch.cli import main_pretrain as cli
from lavila_tpu_torch.config import parse_config
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.train import freeze as F
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_caption_train_step
from test_eval_narrator_cli import gpt2_vocab_dir  # noqa: F401  (fixture)
from test_torch_train_step import OPTIM, SCHEDULE

torch.set_num_threads(1)

VCLM = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
BOS = EOS = 50256


def _jax_params(seed=0):
    """The JAX MINI narrator's params, gates and time attention given
    seeded non-zero values (at zero the cross-attention's and K2's
    gradients would be vacuous)."""
    jm = jax_build_model(VCLM, num_frames=4, gated_xattn=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 4, 64, 64, 3)),
        jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(seed + 1)
    for blk in params["text_decoder"].values():
        if "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return jm, params


def _captions(B=4, L=12, seed=0):
    """Frames and GPT-2 captions: BOS, tokens, EOS, then padding (0)."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, 4, 64, 64, 3)).astype(np.float32)
    text = np.zeros((B, L), np.int32)
    for b in range(B):
        n = int(rng.integers(3, L - 1))
        text[b, 0] = BOS
        text[b, 1:n] = rng.integers(1, 50256, n - 1)
        text[b, n] = EOS
    return frames, text


def _port_model(params, **kw):
    model = build_model(VCLM, device="cpu", gated_xattn=True, train=True,
                        **kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _port_state(params, frozen, dtype=torch.float32, **kw):
    return TrainState.create(_port_model(params, **kw), lambda p:
                             O.make_optimizer(F.freeze_by_predicate(
                                 p, frozen), O.cosine_schedule(**SCHEDULE),
                                 **OPTIM), dtype=dtype)


def _batch(frames, text):
    return {"frames": torch.from_numpy(frames),
            "text": torch.from_numpy(text.astype(np.int64))}


@pytest.mark.parametrize("case", ["padded", "one_row_all_pad", "no_pad"])
def test_caption_loss_matches_jax(case):
    """Loss, token accuracy and perplexity within 1e-6 of the JAX
    function's on the same logits and padded labels; logits on a few
    rows made to pick the label, so the accuracy is not 0."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 9, 50), scale=3.0).astype(np.float32)
    labels = rng.integers(1, 50, (3, 9))
    if case != "no_pad":
        labels[0, 6:] = 0
        labels[2, 4:] = 0
    if case == "one_row_all_pad":
        labels[1] = 0
    logits[np.arange(3), 1, labels[:, 1]] += 20.0
    want = JL.caption_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = L.caption_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["caption_acc"].item() > 0
    assert L.get_metric_names(VCLM) == JL.get_metric_names(VCLM) == [
        "loss", "caption_loss", "caption_acc", "ppl"]


def test_teacher_forced_logits_match_jax():
    """The port's teacher-forced forward (K7/K8's plain versions at
    GPT-2's self- and cross-attention on the CPU) against the JAX
    VCLM's on the same weights: logits within 1e-4, the same labels."""
    jm, params = _jax_params()
    frames, text = _captions()
    want = jm.apply({"params": params}, jnp.asarray(frames),
                    jnp.asarray(text))
    model = _port_model(params).eval()
    with torch.no_grad():
        got = model(*_batch(frames, text).values())
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))


# the VCLM freeze flags, alone and as LaViLa's recipe
FREEZE = {"none": {}, "lm": {"freeze_lm_vclm": True},
          "visual": {"freeze_visual_vclm": True},
          "visual_temporal": {"freeze_visual_vclm_temporal": True},
          "recipe": {"freeze_lm_vclm": True, "freeze_visual_vclm": True}}


@pytest.mark.parametrize("flags", sorted(FREEZE))
def test_caption_steps_match_jax_under_freezing(flags):
    """Two caption steps against the JAX step with ``freeze_by_predicate``
    over the same predicate: losses, accuracy and perplexity within 1e-5
    relative; trainable parameters under the MINI parity tests' Adam
    bound (every element within 2·Σ lr, all but a thousandth within
    1e-5); frozen ones bit-equal to their start and without a
    gradient, the others with one."""
    jm, params = _jax_params()
    pred = F.build_freeze_predicate(**FREEZE[flags])
    jpred = JF.build_freeze_predicate(**FREEZE[flags])
    tx = JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM)
    if FREEZE[flags]:
        tx = JF.freeze_by_predicate(tx, jpred)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_caption_step(jm, pad_id=0))
    state = _port_state(params, pred)
    start = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_caption_train_step(pad_id=0)
    for seed in range(2):
        frames, text = _captions(seed=seed)
        jstate, jmet = jstep(jstate, {"frames": jnp.asarray(frames),
                                      "text": jnp.asarray(text)})
        state, met = step(state, _batch(frames, text))
        for k in ("loss", "caption_acc", "ppl"):
            assert met[k].item() == pytest.approx(float(jmet[k]), rel=1e-5,
                                                  abs=1e-6), k
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t) for t in range(2))
    assert state.frozen == {n for n in state.params if pred(n)}
    assert bool(state.frozen) == bool(FREEZE[flags])
    far = total = 0
    for name, p in state.params.items():
        if name in state.frozen:
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p, start[name]), name
            assert torch.equal(want[name], start[name]), name
            continue
        assert p.grad is not None, name
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)


def test_gpt2_remat_equals_no_remat():
    """Remat on both towers (GPT-2's blocks under checkpoint) against
    none, from the same weights, two caption steps of LaViLa's recipe:
    the same losses and the same parameters (the recompute is the same
    arithmetic)."""
    _, params = _jax_params()
    pred = F.build_freeze_predicate(**FREEZE["recipe"])
    runs = []
    for remat in (False, True):
        state = _port_state(params, pred, remat=remat)
        assert state.model.text_decoder.cfg.remat == remat
        step = make_caption_train_step()
        losses = [step(state, _batch(*_captions(seed=s)))[1]["loss"].item()
                  for s in range(2)]
        runs.append((losses, state.params))
    (l0, p0), (l1, p1) = runs
    assert l0 == pytest.approx(l1, rel=1e-6)
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], rtol=1e-6,
                                   atol=1e-7, msg=name)


def test_bf16_working_copy_keeps_norms_and_gates_fp32():
    """In the bf16 working copy every LayerNorm parameter (the pooler's
    bias-free γ too, which a bf16 copy rounded before) and the scalar
    gates stay fp32, as the JAX package keeps them; the matrices are
    bf16; a frozen parameter has no gradient after a step, the gates
    and the pooler's γ have one."""
    _, params = _jax_params()
    pred = F.build_freeze_predicate(**FREEZE["recipe"])
    state = _port_state(params, pred, torch.bfloat16)
    work = dict(state.model.named_parameters())
    for name in ("img_attn_pool.norm.gamma", "img_attn_pool.context_norm.gamma",
                 "img_attn_pool_norm.gamma",
                 "text_decoder.transformer.h.0.alpha_cattn",
                 "text_decoder.transformer.h.0.alpha_dense",
                 "text_decoder.transformer.h.0.ln_1.weight"):
        assert work[name].dtype == torch.float32, name
        assert torch.equal(work[name], state.params[name]), name
    assert work["img_queries"].dtype == torch.bfloat16
    assert work["text_decoder.transformer.h.0.crossattention.c_attn."
                "weight"].dtype == torch.bfloat16
    state, met = make_caption_train_step()(state, _batch(*_captions()))
    assert torch.isfinite(met["loss"])
    for name, p in work.items():
        assert (p.grad is None) == (name in state.frozen), name
        assert p.requires_grad != (name in state.frozen), name
    # the working copy holds the updated masters, rounded to its dtype
    for name, p in work.items():
        assert torch.equal(p, state.params[name].to(p.dtype)), name


@pytest.mark.parametrize("flags", [
    [],
    ["--update-freq", "2", "--steps", "3", "--use-checkpoint",
     "--disable-amp"],
])
def test_cli_trains_the_narrator_and_its_checkpoint_narrates(
        tmp_path, gpt2_vocab_dir, monkeypatch, flags):  # noqa: F811
    """``main_pretrain`` with LaViLa's narrator flags on MINI: the caption
    metrics in the log, the gates moved, the frozen tensors bit-equal in
    the checkpoint, and the port's ``main_infer_narrator`` reads that
    checkpoint (the port's own layout) and narrates. ``--update-freq 2``
    makes one update of two micro-steps."""
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", gpt2_vocab_dir)
    argv = ["--dataset", "synthetic", "--model", VCLM, "--gated-xattn",
            "--freeze-lm-vclm", "--freeze-visual-vclm", "--device", "cpu",
            "--batch-size", "4", "--workers", "1", "--output-dir",
            str(tmp_path / "run"), "--seed", "3", *flags]
    if "--steps" not in flags:
        argv += ["--steps", "2"]
    cfg = parse_config(cli.TorchPretrainConfig, argv)
    state = cli.main(cfg)
    log = json.loads((tmp_path / "run" / "log.txt").read_text())
    assert {"train_loss", "train_caption_loss", "train_caption_acc",
            "train_ppl"} <= log.keys()
    assert np.isfinite(log["train_loss"]) and log["train_ppl"] > 1
    fresh = dict(build_model(VCLM, device="cpu", gated_xattn=True,
                             remat=cfg.use_checkpoint,
                             generator=torch.Generator().manual_seed(3))
                 .named_parameters())
    ckpt = torch.load(tmp_path / "run" / "checkpoint_latest.pt",
                      weights_only=True)
    frozen = F.build_freeze_predicate(freeze_lm_vclm=True,
                                      freeze_visual_vclm=True)
    assert state.frozen == {n for n in fresh if frozen(n)}
    for name, p in fresh.items():
        saved = ckpt["state_dict"][name]
        if frozen(name):
            assert torch.equal(saved, p), name
    gate = "text_decoder.transformer.h.0.alpha_cattn"
    assert not torch.equal(ckpt["state_dict"][gate], fresh[gate])
    if "--update-freq" in flags:
        assert state.optimizer.scheduler.last_epoch == 1
    out = tmp_path / "narr"
    main_infer_narrator.main(main_infer_narrator.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--model", VCLM, "--device", "cpu",
         "--checkpoint", str(tmp_path / "run" / "checkpoint_latest.pt"),
         "--max-samples", "3", "--batch-size", "3", "--workers", "1",
         "--num-return-sequences", "2", "--max-text-length", "8",
         "--output-dir", str(out)]))
    records = pickle.loads((out / "total.pkl").read_bytes())
    assert len(records) == 3 and all(len(r[3]) == len(r[4]) == 2
                                     for r in records)
    assert all(np.isfinite(r[4]).all() for r in records)
