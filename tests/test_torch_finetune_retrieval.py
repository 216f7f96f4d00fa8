"""The port's retrieval fine-tune against ``lavila_tpu``'s: the max-margin
loss (values and gradients), the freeze predicates on the MINI parameter
names, gradient clipping and accumulation (``update_freq``) against
optax, three MINI retrieval steps against JAX's
``make_retrieval_train_step`` from the same weights, and the CLI end to
end: against the JAX CLI on the synthetic dataset, and on the
CharadesEgo fixture of ``tests/test_finetune_cli.py`` (train and
validate, ``--evaluate``, auto-resume, ``logit_scale`` frozen), and with
a DistilBERT dual encoder at MINI size, its masks reaching the step."""

import json
import math
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
from lavila_tpu.train.step import make_retrieval_train_step as jax_step
from lavila_tpu_torch import losses as L
from lavila_tpu_torch.cli import main_finetune_retrieval as cli
from lavila_tpu_torch.data.video import encode_test_video
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax, torch_key
from lavila_tpu_torch.train import freeze as F
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_retrieval_train_step
from test_torch_eval_zeroshot_cli import bert_mini  # noqa: F401  (fixture)
from test_torch_pretrain_cli import _spy_masks

torch.set_num_threads(1)

MINI = "CLIP_OPENAI_TIMESFORMER_MINI"
LOG_SCALE = torch.tensor(math.log(1 / 0.07))  # fp32, as the model holds it


@pytest.mark.parametrize("weighted", [False, True])
def test_max_margin_loss_matches_jax(weighted):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(6, 16)).astype(np.float32)
    txt = rng.normal(size=(6, 16)).astype(np.float32)
    w = rng.uniform(size=6).astype(np.float32) if weighted else None

    def jloss(i, t):
        return JL.max_margin_loss(i, t, margin=0.4, weights=w)["loss"]

    want = float(jloss(img, txt))
    gi, gt = jax.grad(jloss, argnums=(0, 1))(img, txt)
    ti, tt = (torch.from_numpy(x).requires_grad_() for x in (img, txt))
    out = L.max_margin_loss(ti, tt, margin=0.4, weights=None if w is None
                            else torch.from_numpy(w))
    assert out["loss"].item() == pytest.approx(want, rel=1e-6)
    assert out["max_margin_loss"] is out["loss"]
    out["loss"].backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-7)


def test_loss_selectors():
    assert L.get_loss("CLIP_OPENAI_TIMESFORMER_BASE") is L.clip_loss
    assert L.get_metric_names(MINI) == JL.get_metric_names(MINI)
    with pytest.raises(NotImplementedError, match="caption"):
        L.get_loss("VCLM_OPENAI_TIMESFORMER_BASE_GPT2")


def _jax_names(model_name):
    """(JAX path string, the port's parameter name) of every leaf."""
    jm = jax_build_model(model_name)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(0), jnp.zeros((1, 4, 64, 64, 3)),
        jnp.zeros((1, 77), jnp.int32))["params"]
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(str(k.key) for k in path)
        out.append(("/".join(keys), torch_key(keys)[0]))
    return out


@pytest.mark.parametrize("model_name", [
    MINI, "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"])
def test_freeze_predicates_match_jax(model_name):
    """Each predicate, and the pretraining flags' combination, freezes
    the same parameters under the port's names as under JAX's paths."""
    names = _jax_names(model_name)
    preds = [(JF.temporal_parts, F.temporal_parts),
             (JF.spatial_parts, F.spatial_parts),
             (JF.lm_parts, F.lm_parts),
             (JF.logit_scale_only, F.logit_scale_only)]
    flags = [dict(freeze_temperature=True, timesformer_freeze_space=True),
             dict(freeze_visual_vclm_temporal=True, freeze_lm_vclm=True),
             dict()]
    preds += [(JF.build_freeze_predicate(**f), F.build_freeze_predicate(**f))
              for f in flags]
    hits = 0
    for jp, tp in preds:
        got = {n for _, n in names if tp(n)}
        assert got == {n for p, n in names if jp(p)}
        hits += len(got)
    assert hits > 0
    if model_name.startswith("VCLM"):
        assert any(F.lm_parts(n) for _, n in names)
    # frozen parameters are left out of the optimizer
    model = build_model(MINI, device="cpu")
    pairs = F.freeze_by_predicate(model.named_parameters(),
                                  F.logit_scale_only)
    assert [n for n, _ in pairs] == [n for n, _ in model.named_parameters()
                                     if n != "logit_scale"]


@pytest.mark.parametrize("clip_type,clip_value,update_freq", [
    ("norm", 0.5, 2), ("value", 0.05, 2), ("norm", 0.5, 1)])
def test_clipping_and_accumulation_match_optax(clip_type, clip_value,
                                               update_freq):
    """Four micro-steps on a small tree with one frozen leaf: the port's
    optimizer (clipping, MultiSteps-style averaging, the schedule stepped
    per update) against optax's chain under ``freeze_by_predicate``."""
    rng = np.random.default_rng(1)
    init = {"w": rng.normal(size=(3, 4)), "bias": rng.normal(size=(4,)),
            "logit_scale": np.array(2.0)}
    init = {k: np.asarray(v, np.float32) for k, v in init.items()}
    grads = [{k: np.asarray(rng.normal(size=v.shape) * 3, np.float32)
              for k, v in init.items()} for _ in range(4)]
    schedule = JO.cosine_schedule(1e-2, 1e-3, 2, 2, 1, 1e-3)
    kw = dict(weight_decay=0.1, clip_grad_value=clip_value,
              clip_grad_type=clip_type, update_freq=update_freq)
    tx = JF.freeze_by_predicate(JO.make_optimizer(schedule, **kw),
                                JF.logit_scale_only)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = O.make_optimizer(
        F.freeze_by_predicate(params.items(), F.logit_scale_only),
        O.cosine_schedule(1e-2, 1e-3, 2, 2, 1, 1e-3), **kw)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
    assert params["logit_scale"].item() == 2.0
    assert opt.scheduler.last_epoch == 4 // update_freq


def _batches(n, B=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.normal(size=(B, 4, 64, 64, 3)).astype(np.float32)
        text = rng.integers(1, 49407, size=(B, 77)).astype(np.int32)
        text[np.arange(B), rng.integers(5, 77, size=B)] = 49407  # EOT
        rel = rng.uniform(size=B).astype(np.float32)
        out.append({"frames": frames, "text": text, "relevancy": rel})
    return out


def _jax_params(seed=0):
    jm = jax_build_model(MINI)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 4, 64, 64, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    # time attention away from its zero init, so K2's path is not vacuous
    rng = np.random.default_rng(seed + 1)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return jm, params


SCHEDULE = dict(base_lr=1e-3, final_lr=1e-4, epochs=2, steps_per_epoch=2,
                warmup_epochs=1, start_warmup_lr=1e-4)
OPTIM = dict(weight_decay=0.01, clip_grad_value=5.0, clip_grad_type="norm")


def test_three_retrieval_steps_match_jax():
    """adaptive_max_margin with relevancy weights, drop-path 0,
    normalised embeddings, logit_scale frozen: per-step loss within 1e-5
    relative and the final parameters within the bounds of
    ``tests/test_torch_train_step.py`` (every element within 2·Σ lr, all
    but a thousandth within 1e-5); logit_scale unchanged in both."""
    jm, params = _jax_params()
    tx = JF.freeze_by_predicate(
        JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM),
        JF.logit_scale_only)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_step(jm, loss_type="adaptive_max_margin",
                             margin=0.4, norm_embed=True))
    model = build_model(MINI, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    state = TrainState.create(model, lambda p: O.make_optimizer(
        F.freeze_by_predicate(p, F.logit_scale_only),
        O.cosine_schedule(**SCHEDULE), **OPTIM), dtype=torch.float32)
    step = make_retrieval_train_step("adaptive_max_margin", margin=0.4,
                                     norm_embed=True)
    for b in _batches(3):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tb = {"frames": torch.from_numpy(b["frames"]),
              "text": torch.from_numpy(b["text"].astype(np.int64)),
              "relevancy": torch.from_numpy(b["relevancy"])}
        state, m = step(state, tb)
        assert m["loss"].item() == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t) for t in range(3))
    far = total = 0
    for name, p in state.params.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    assert torch.equal(state.params["logit_scale"], LOG_SCALE)
    assert float(want["logit_scale"]) == pytest.approx(LOG_SCALE.item())


def test_retrieval_step_rejects_unknown_loss():
    with pytest.raises(ValueError, match="loss_type"):
        make_retrieval_train_step("triplet")


def _synthetic_args(out, *extra):
    return cli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", MINI, "--clip-length", "4",
        "--batch-size", "4", "--workers", "2", "--steps", "2",
        "--drop-path-rate", "0", "--device", "cpu", "--output-dir",
        str(out), *extra])


def test_cli_synthetic_matches_jax_cli(tmp_path):
    """Both CLIs fine-tune the same weights (a JAX checkpoint and its
    conversion to a port ``.pt``) for 2 steps on the synthetic dataset:
    the same batches, so the final parameters agree within the step
    test's bounds, and logit_scale is unchanged in both."""
    from cli.main_finetune_retrieval import get_args_parser as jax_parser
    from cli.main_finetune_retrieval import main as jax_main
    from lavila_tpu.utils.checkpoints import CheckpointManager as JaxMgr
    _, params = _jax_params()
    # the zoo's MINI projects to 64; the CLIs' default would be 256
    config = {"model": MINI, "clip_length": 4, "project_embed_dim": 64}
    JaxMgr(str(tmp_path / "jax_pre")).save({"params": params}, epoch=0,
                                           config=config)
    jpath = str(tmp_path / "jax_pre" / "checkpoint_0000")
    tpath = str(tmp_path / "pre.pt")
    torch.save({"state_dict": state_dict_from_jax(params)}, tpath)
    with open(tpath + ".json", "w") as f:
        json.dump({"epoch": 0, "config": config}, f)
    # batch 8: the JAX CLI shards it over the suite's 8 CPU devices
    flags = ["--dataset", "synthetic", "--clip-length", "4",
             "--batch-size", "8", "--workers", "2", "--steps", "2",
             "--drop-path-rate", "0", "--lr", "1e-3", "--fix-lr"]
    jstate = jax_main(jax_parser().parse_args(
        flags + ["--pretrain-model", jpath,
                 "--output-dir", str(tmp_path / "jax_run")]))
    state = cli.main(cli.get_args_parser().parse_args(
        flags + ["--pretrain-model", tpath, "--device", "cpu",
                 "--output-dir", str(tmp_path / "run")]))
    assert state.step == int(jstate.step) == 2
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    far = total = 0
    for name, p in state.params.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= 2 * 2 * 1e-3, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    assert torch.equal(state.params["logit_scale"], LOG_SCALE)
    log = json.loads((tmp_path / "run" / "log.txt").read_text())
    assert log["epoch"] == 0 and math.isfinite(log["train_loss"])


@pytest.fixture()
def charades_fixture(tmp_path):
    """Trimmed train pkl + untrimmed val csv + classes file sharing one
    synthetic video (the fixture of tests/test_finetune_cli.py)."""
    root = tmp_path / "vids"
    root.mkdir()
    encode_test_video(str(root / "VID1EGO.mp4"), 64, 64, 30, 120)
    train_pkl = tmp_path / "charades_train.pkl"
    with open(train_pkl, "wb") as f:
        pickle.dump([("VID1EGO", 0.2 + 0.3 * i, 1.5 + 0.3 * i,
                      f"someone is doing action {i}") for i in range(8)], f)
    val_csv = tmp_path / "CharadesEgo_v1_test_only1st.csv"
    val_csv.write_text(
        "id,subject,scene,quality,relevance,verified,script,objects,"
        "descriptions,actions,length\n"
        "VID1EGO,s,Kitchen,5,5,Yes,script,objects,desc,"
        "c092 0.5 2.0;c147 0.2 2.5,3.0\n")
    classes = tmp_path / "Charades_v1_classes.txt"
    classes.write_text("c092 someone is cooking\nc147 someone is eating\n"
                       "c100 someone is running\n")
    return str(root), str(train_pkl), str(val_csv), str(classes)


def _charades_args(tmp_path, fixture, *extra):
    root, train_pkl, val_csv, classes = fixture
    return cli.get_args_parser().parse_args([
        "--dataset", "charades_ego", "--root", root,
        "--metadata", train_pkl, "--metadata-val", val_csv,
        "--label-metadata", classes, "--model", MINI, "--clip-length", "4",
        "--clip-stride", "2", "--batch-size", "8", "--workers", "2",
        "--epochs", "1", "--eval-freq", "1", "--device", "cpu",
        "--output-dir", str(tmp_path / "run"), *extra])


def test_cli_charades_trains_validates_and_resumes(tmp_path,
                                                   charades_fixture):
    """CLIP loss on the trimmed clips, multilabel video mAP on the
    untrimmed csv after the epoch, the best checkpoint kept; a second run
    of the same output dir resumes at epoch 1 with the best metric."""
    cli.main(_charades_args(tmp_path, charades_fixture))
    run = tmp_path / "run"
    rec = json.loads((run / "log.txt").read_text().splitlines()[-1])
    assert rec["epoch"] == 0 and np.isfinite(rec["video_mAP"])
    assert (run / "checkpoint_best.pt").exists()
    meta = json.loads((run / "checkpoint_best.pt.json").read_text())
    assert meta["metrics"]["best_metric"] == rec["video_mAP"]
    state = cli.main(_charades_args(tmp_path, charades_fixture,
                                    "--epochs", "2"))
    meta = json.loads((run / "checkpoint_latest.pt.json").read_text())
    assert meta["epoch"] == 1 and state.step == 2  # epoch 0 not retrained
    assert np.isfinite(meta["metrics"]["best_metric"])


def test_cli_evaluate_only(tmp_path, charades_fixture):
    out = cli.main(_charades_args(tmp_path, charades_fixture, "--evaluate"))
    assert set(out) == {"video_mAP"} and np.isfinite(out["video_mAP"])
    assert not (tmp_path / "run" / "checkpoint_latest.pt").exists()


def test_cli_accumulation_keeps_logit_scale_frozen(tmp_path,
                                                   charades_fixture):
    """--update-freq 2 --clip-grad-value 1.0 over two micro-steps: one
    update, and logit_scale is exactly log(1/0.07) after it (the
    reference freezes it for retrieval fine-tuning whatever
    --freeze-temperature says)."""
    state = cli.main(_charades_args(
        tmp_path, charades_fixture, "--batch-size", "4", "--update-freq",
        "2", "--fix-lr", "--clip-grad-value", "1.0", "--freeze-temperature"))
    assert state.step == 2 and state.optimizer.scheduler.last_epoch == 1
    assert torch.equal(state.params["logit_scale"], LOG_SCALE)
    fresh = build_model(MINI, device="cpu", num_frames=4,
                        generator=torch.Generator().manual_seed(0))
    moved = [n for n, p in fresh.named_parameters()
             if not torch.equal(p, state.params[n])]
    assert moved and "logit_scale" not in moved


def test_cli_options_that_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="wandb"):
        cli.main(_synthetic_args(tmp_path, "--wandb"))
    with pytest.raises(NotImplementedError, match="remat"):
        cli.main(_synthetic_args(tmp_path, "--use-checkpoint",
                                 "--remat-policy", "dots"))
    if not torch.cuda.is_available():
        args = _synthetic_args(tmp_path)
        args.device = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)


def test_cli_gated_xattn_names_its_roadmap_subject(tmp_path):
    """A pretrain checkpoint whose config asks for
    timesformer_gated_xattn is refused, naming ROADMAP queue 1 item
    7a."""
    ckpt = tmp_path / "gated.pt"
    (tmp_path / "gated.pt.json").write_text(json.dumps({"config": {
        "model": MINI, "timesformer_gated_xattn": True}}))
    args = _synthetic_args(tmp_path, "--pretrain-model", str(ckpt))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1: timesformer_gated_xattn"):
        cli.build_finetune_model(args, torch.device("cpu"))


def test_cli_fine_tunes_a_distilbert_model(tmp_path, bert_mini, monkeypatch):
    """A DistilBERT dual encoder (MINI size, fixture vocabulary)
    fine-tunes through the CLI, each step's forward given the batch's
    mask, logit_scale frozen."""
    seen = _spy_masks(monkeypatch)
    args = _synthetic_args(tmp_path, "--model", bert_mini)
    state = cli.main(args)
    assert state.step == 2 and len(seen) == 2
    assert all(m is not None and m.shape == (4, 77) for m in seen)
    assert torch.equal(state.params["logit_scale"], LOG_SCALE)
