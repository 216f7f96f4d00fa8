"""SSL pretraining in the port against ``lavila_tpu``: the two-temperature
loss (values, metrics and gradients against ``jax.grad``), SSL train
steps on MINI from one JAX init and one criterion state against the JAX
step (clipping by norm and by value, ``update_freq`` 2, the freeze
flags, the pseudo scale unclamped), the criterion through the weight
bridge and a checkpoint round trip, and the pretraining CLI's aux
datasets, EK-100 probe, resume and ``--wandb``, as
``tests/test_cli_smoke.py`` tests the JAX CLI."""

import json
import math
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu import losses as JL
from lavila_tpu.config import parse_config
from lavila_tpu.train import freeze as JF
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_clip_train_step as jax_train_step
from lavila_tpu_torch import losses as L
from lavila_tpu_torch.cli import main_pretrain as cli
from lavila_tpu_torch.data.video import encode_test_video
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.train import freeze as F
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_clip_train_step
from lavila_tpu_torch.utils.checkpoints import CheckpointManager
from test_torch_train_step import SCHEDULE, _batches, _jax_params

torch.set_num_threads(1)

MINI = "CLIP_OPENAI_TIMESFORMER_MINI"
PSEUDO = "logit_scale_pseudo"


def _loss_inputs(ind, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(6, 16)).astype(np.float32)
    txt = rng.normal(size=(6, 16)).astype(np.float32)
    txt[2] = img[2]  # one clear match, so the accuracies are not all-or-none
    return img, txt, np.float32(3.0), np.float32(5.0), np.asarray(
        ind, np.int32)


@pytest.mark.parametrize("ind", [[1] * 6, [0] * 6, [1, 0, 1, 1, 0, 0]],
                         ids=["all_gt", "all_pseudo", "mixed"])
def test_ssl_clip_loss_matches_jax(ind):
    """Loss and every metric within 1e-6 relative; the gradients of both
    embeddings and both scales within 1e-5 of their largest, against
    ``jax.grad``."""
    img, txt, scale, pseudo, gt = _loss_inputs(ind)
    want = JL.ssl_clip_loss(*map(jnp.asarray, (img, txt, scale, pseudo, gt)))
    jgrads = jax.grad(
        lambda a, b, s, p: JL.ssl_clip_loss(a, b, s, p, jnp.asarray(gt))[
            "loss"], argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (img, txt, scale, pseudo)))
    leaves = [torch.from_numpy(img).requires_grad_(),
              torch.from_numpy(txt).requires_grad_(),
              torch.tensor(scale, requires_grad=True),
              torch.tensor(pseudo, requires_grad=True)]
    got = L.ssl_clip_loss(*leaves, torch.from_numpy(gt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    for name, a, w in zip(("image", "text", "scale", "pseudo"),
                          torch.autograd.grad(got["loss"], leaves), jgrads):
        w = np.asarray(w)
        scale_w = max(np.abs(w).max(), 1e-30)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * scale_w, name
    if not any(ind):  # the human scale takes no part
        assert float(jgrads[2]) == 0.0


def test_ssl_clip_loss_with_every_indicator_one_is_clip_loss():
    img, txt, scale, pseudo, gt = _loss_inputs([1] * 6)
    t = [torch.from_numpy(x) for x in (img, txt)]
    ssl = L.ssl_clip_loss(*t, torch.tensor(scale), torch.tensor(pseudo),
                          torch.from_numpy(gt))
    clip = L.clip_loss(*t, torch.tensor(scale))
    for k in clip:
        assert ssl[k].item() == pytest.approx(clip[k].item(), rel=1e-6)
    assert ssl["num_gt"].item() == 6 and ssl["num_pseudo"].item() == 0


def _ssl_batches(n, seed=0):
    ind = np.array([1, 0, 1, 0], np.int32)
    return [(f, t, ind) for f, t in _batches(n, seed=seed)]


def _run_both(optim, steps, pseudo_init=0.07, jfrozen=None, frozen=None):
    """``steps`` SSL steps of the JAX package and of the port from the
    same MINI weights and pseudo scale: the per-step losses and the two
    final states."""
    jm, params = _jax_params()
    init = math.log(1 / pseudo_init)
    tx = JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **optim)
    if jfrozen is not None:
        tx = JF.freeze_by_predicate(tx, jfrozen)
    jstate = JaxTrainState.create(
        params, tx, criterion_params={PSEUDO: jnp.asarray(init, jnp.float32)})
    jstep = jax.jit(jax_train_step(jm, use_ssl=True))
    model = build_model(MINI, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    state = TrainState.create(
        model, lambda p: O.make_optimizer(
            F.freeze_by_predicate(p, frozen or (lambda n: False)),
            O.cosine_schedule(**SCHEDULE), **optim),
        dtype=torch.float32, criterion={PSEUDO: init})
    step = make_clip_train_step(use_ssl=True)
    losses = []
    for frames, text, ind in _ssl_batches(steps):
        jstate, jmet = jstep(jstate, {"frames": jnp.asarray(frames),
                                      "text": jnp.asarray(text),
                                      "gt_indicators": jnp.asarray(ind)})
        state, met = step(state, {
            "frames": torch.from_numpy(frames),
            "text": torch.from_numpy(text.astype(np.int64)),
            "gt_indicators": torch.from_numpy(ind).float()})
        losses.append((met["loss"].item(), float(jmet["loss"])))
        for k in ("clip_acc_gt", "clip_acc_pseudo", "num_gt", "num_pseudo"):
            assert met[k].item() == pytest.approx(float(jmet[k])), k
    return losses, state, jstate


def _assert_close_to_jax(state, jstate, updates):
    """The MINI bound of tests/test_torch_train_step.py: every element
    within 2·Σ lr, all but a thousandth within 1e-5; the pseudo scale
    too."""
    want = state_dict_from_jax({
        **jax.tree.map(np.asarray, jstate.params),
        **jax.tree.map(np.asarray, jstate.criterion_params)})
    got = {**state.params, **state.criterion}
    assert set(got) == set(want)
    bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t) for t in range(updates))
    far = total = 0
    for name, p in got.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    assert abs(state.criterion[PSEUDO].item()
               - float(jstate.criterion_params[PSEUDO])) <= 1e-5


@pytest.mark.parametrize("optim,steps,updates", [
    (dict(weight_decay=0.1, clip_grad_value=5.0, clip_grad_type="norm"),
     2, 2),
    (dict(weight_decay=0.1, clip_grad_value=0.05, clip_grad_type="value"),
     2, 2),
    (dict(weight_decay=0.1, clip_grad_value=0.5, clip_grad_type="norm",
          update_freq=2), 4, 2),
], ids=["clip_norm", "clip_value", "update_freq_2"])
def test_ssl_steps_match_jax(optim, steps, updates):
    """Per-step loss within 1e-5 relative, the parameters and the pseudo
    scale within the MINI bound; the pseudo scale moved."""
    losses, state, jstate = _run_both(optim, steps)
    for got, want in losses:
        assert got == pytest.approx(want, rel=1e-5)
    _assert_close_to_jax(state, jstate, updates)
    assert state.criterion[PSEUDO].item() != pytest.approx(
        math.log(1 / 0.07), abs=1e-7)
    assert state.criterion[PSEUDO].dtype == torch.float32
    if "update_freq" in optim:
        assert state.optimizer.scheduler.last_epoch == updates


OPTIM = dict(weight_decay=0.1, clip_grad_value=5.0, clip_grad_type="norm")


def test_freeze_pseudo_temperature_pins_it_bit_equal():
    init = torch.tensor(math.log(1 / 0.07))
    losses, state, jstate = _run_both(
        OPTIM, 2, jfrozen=JF.pseudo_scale_only, frozen=F.pseudo_scale_only)
    assert torch.equal(state.criterion[PSEUDO].detach(), init)
    assert float(jstate.criterion_params[PSEUDO]) == init.item()
    _assert_close_to_jax(state, jstate, 2)
    # left out of the optimizer, and --freeze-temperature does not catch it
    assert not F.logit_scale_only(PSEUDO)
    opt_ids = {id(p) for g in state.optimizer.inner.param_groups
               for p in g["params"]}
    assert id(state.criterion[PSEUDO]) not in opt_ids


def test_freeze_temperature_leaves_the_pseudo_scale_learning():
    losses, state, jstate = _run_both(
        OPTIM, 2, jfrozen=JF.logit_scale_only, frozen=F.logit_scale_only)
    assert torch.equal(state.params["logit_scale"].detach(),
                       torch.tensor(math.log(1 / 0.07)))
    assert state.criterion[PSEUDO].item() != pytest.approx(
        math.log(1 / 0.07), abs=1e-7)
    _assert_close_to_jax(state, jstate, 2)


def test_pseudo_scale_is_not_clamped():
    """Started above log 100 it stays there, as in the JAX step, which
    clamps only the model's parameters; the pseudo scale shares the
    model's no-decay group."""
    losses, state, jstate = _run_both(OPTIM, 2, pseudo_init=0.005)
    assert state.criterion[PSEUDO].item() > L.LOGIT_SCALE_MAX
    assert float(jstate.criterion_params[PSEUDO]) > L.LOGIT_SCALE_MAX
    _assert_close_to_jax(state, jstate, 2)
    no_decay = [g for g in state.optimizer.inner.param_groups
                if g["weight_decay"] == 0.0][0]
    assert any(p is state.criterion[PSEUDO] for p in no_decay["params"])


def test_bf16_ssl_step_keeps_the_pseudo_scale_fp32():
    _, params = _jax_params()
    model = build_model(MINI, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    state = TrainState.create(
        model, lambda p: O.make_optimizer(p, 1e-3), dtype=torch.bfloat16,
        criterion={PSEUDO: math.log(1 / 0.07)})
    frames, text, ind = _ssl_batches(1)[0]
    state, met = make_clip_train_step(use_ssl=True)(state, {
        "frames": torch.from_numpy(frames),
        "text": torch.from_numpy(text.astype(np.int64)),
        "gt_indicators": torch.from_numpy(ind).float()})
    assert torch.isfinite(met["loss"]) and state.has_copy
    assert state.criterion[PSEUDO].dtype == torch.float32
    assert PSEUDO not in dict(state.model.named_parameters())


def test_ssl_checkpoint_resume_equals_straight_steps(tmp_path):
    """The checkpoint carries the pseudo scale (``criterion``); a resumed
    state's third step equals three straight steps, bit for bit."""
    _, params = _jax_params()
    batches = [{"frames": torch.from_numpy(f),
                "text": torch.from_numpy(t.astype(np.int64)),
                "gt_indicators": torch.from_numpy(i).float()}
               for f, t, i in _ssl_batches(3, seed=5)]

    def fresh():
        model = build_model(MINI, device="cpu", train=True)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        return TrainState.create(
            model, lambda p: O.make_optimizer(
                p, O.cosine_schedule(**SCHEDULE), **OPTIM),
            dtype=torch.float32, criterion={PSEUDO: math.log(1 / 0.07)})

    step = make_clip_train_step(use_ssl=True)
    straight = fresh()
    for b in batches:
        straight, _ = step(straight, b)
    first = fresh()
    for b in batches[:2]:
        first, _ = step(first, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first.state_dict(), epoch=0, config={"model": MINI})
    tree, _ = mgr.restore("latest")
    assert set(tree["criterion"]) == {PSEUDO}
    resumed = fresh()
    resumed.load_state_dict(tree)
    assert torch.equal(resumed.criterion[PSEUDO], first.criterion[PSEUDO])
    resumed, _ = step(resumed, batches[2])
    assert torch.equal(resumed.criterion[PSEUDO], straight.criterion[PSEUDO])
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name


def test_bridge_maps_the_criterion():
    _, params = _jax_params()
    sd = state_dict_from_jax({**params, PSEUDO: np.float32(2.5)})
    assert sd[PSEUDO].item() == 2.5 and sd[PSEUDO].shape == ()
    assert set(sd) - {PSEUDO} == set(dict(
        build_model(MINI, device="cpu").named_parameters()))


def _without_momentum(opt):
    """``opt`` (``use_sgd``) as plain SGD."""
    for group in opt.inner.param_groups:
        group["momentum"] = 0.0
    return opt


def test_local_loss_still_refuses_naming_multi_gpu():
    """The local SSL loss (``--contrastive-use-vissl``) is ported: at a
    world of one (no process group) its step is the global step's, the
    loss within 1e-6 relative and the masters within 1e-5; its
    multi-rank parity is tests/test_torch_distributed.py's."""
    _, params = _jax_params()
    states = []
    for local in (False, True):
        model = build_model(MINI, device="cpu", train=True)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        state = TrainState.create(
            model, lambda p: _without_momentum(O.make_optimizer(
                p, 1e-2, weight_decay=0.0, use_sgd=True)),
            dtype=torch.float32, criterion={PSEUDO: math.log(1 / 0.07)})
        step = make_clip_train_step(use_ssl=True, local_loss=local)
        frames, text, ind = _ssl_batches(1)[0]
        state, met = step(state, {
            "frames": torch.from_numpy(frames),
            "text": torch.from_numpy(text.astype(np.int64)),
            "gt_indicators": torch.from_numpy(ind).float()})
        states.append((state, met))
    (glob, gmet), (loc, lmet) = states
    assert lmet.keys() == gmet.keys()
    for k in gmet:
        assert lmet[k].item() == pytest.approx(gmet[k].item(), rel=1e-6), k
    for name, p in {**glob.params, **glob.criterion}.items():
        want = p.detach()
        got = {**loc.params, **loc.criterion}[name].detach()
        assert (got - want).abs().max().item() <= 1e-5, name


# ----------------------------------------------------------------- the CLI

def _cfg(out, *extra):
    return parse_config(cli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--model", MINI, "--steps", "2",
        "--batch-size", "4", "--workers", "2", "--device", "cpu",
        "--output-dir", str(out), "--disable-amp", *extra])


def test_cli_aux_datasets_mark_their_samples(tmp_path):
    """The human dataset first (indicator 1), each aux one after it
    (indicator 0), each aux under the random narration selection; the
    batches reach the step with ``gt_indicators``."""
    cfg = _cfg(tmp_path, "--metadata-aux", "aux_a,aux_b",
               "--narration-selection", "concat")
    ds = cli.build_dataset(cfg, None, None)
    assert ds.indicators == [1, 0, 0] and len(ds) == 3 * 256
    assert [d.cfg.narration_selection for d in ds.datasets] == [
        "concat", "random", "random"]
    assert [d.cfg.metadata for d in ds.datasets[1:]] == ["aux_a", "aux_b"]
    assert ds[0]["gt_indicators"] == 1 and ds[600]["gt_indicators"] == 0
    place = cli.make_place(torch.device("cpu"),
                           ("frames", "text", "gt_indicators"))
    out = place({"frames": np.zeros((2, 1), np.float32),
                 "text": np.zeros((2, 3), np.int32),
                 "gt_indicators": np.array([1, 0], np.int32)})
    assert out["gt_indicators"].dtype == torch.float32


def test_cli_pseudo_temperature_pinned_under_freeze(tmp_path):
    """--pseudo-temperature-init 0.05 with --freeze-pseudo-temperature:
    log(1/0.05) after two steps (tests/test_cli_smoke.py)."""
    state = cli.main(_cfg(tmp_path, "--metadata-aux", "synthetic_aux",
                          "--pseudo-temperature-init", "0.05",
                          "--freeze-pseudo-temperature"))
    assert state.step == 2
    assert torch.equal(state.criterion[PSEUDO].detach(),
                       torch.tensor(math.log(1 / 0.05)))


def test_cli_pseudo_temperature_learns_and_resumes(tmp_path, monkeypatch):
    """Unfrozen it moves from log(1/0.07) (the CLI default); the
    checkpoint holds it, and a second run of the output directory
    restores it before its next step."""
    cli.main(_cfg(tmp_path, "--metadata-aux", "synthetic_aux", "--steps",
                  "1", "--epochs", "2"))
    saved = torch.load(tmp_path / "checkpoint_latest.pt",
                       weights_only=True)["criterion"][PSEUDO]
    assert saved.item() != pytest.approx(math.log(1 / 0.07), abs=1e-7)
    restored, load = [], TrainState.load_state_dict

    def spy(self, ckpt):
        load(self, ckpt)
        restored.append(self.criterion[PSEUDO].detach().clone())
    monkeypatch.setattr(TrainState, "load_state_dict", spy)
    state = cli.main(_cfg(tmp_path, "--metadata-aux", "synthetic_aux",
                          "--steps", "1", "--epochs", "2"))
    assert len(restored) == 1 and torch.equal(restored[0], saved)
    assert state.step == 2
    assert not torch.equal(state.criterion[PSEUDO].detach(), saved)
    meta = json.loads((tmp_path / "checkpoint_latest.pt.json").read_text())
    assert meta["epoch"] == 1


@pytest.fixture()
def ek100_probe(tmp_path):
    """The EK-100 MIR probe fixture of tests/test_cli_smoke.py: one
    video, two clips, the sentence csv and an identity relevancy."""
    root = tmp_path / "vids"
    (root / "P01").mkdir(parents=True)
    encode_test_video(str(root / "P01" / "P01_01.MP4"), 64, 64, 30, 120)
    header = ("narration_id,participant_id,video_id,narration_timestamp,"
              "start_timestamp,stop_timestamp,start_frame,stop_frame,"
              "narration,verb,verb_class,noun,noun_class,all_nouns,"
              "all_noun_classes\n")
    rows = [f"P01_{i},P01,P01_01,00:00:00.0,00:00:0{i}.0,00:00:0{i + 2}.0,"
            f"0,60,narr {i},v,0,n,{i},[],[]\n" for i in range(2)]
    meta = tmp_path / "EPIC_100_retrieval_test.csv"
    meta.write_text(header + "".join(rows))
    (tmp_path / "EPIC_100_retrieval_test_sentence.csv").write_text(
        "narration_id,narration\nP01_0,narr 0\nP01_1,narr 1\n")
    (tmp_path / "relevancy").mkdir()
    with open(tmp_path / "relevancy" /
              "caption_relevancy_EPIC_100_retrieval_test.pkl", "wb") as f:
        pickle.dump(np.eye(2, dtype=np.float32), f)
    return str(root), str(meta)


def test_cli_probe_logs_and_keeps_the_best(tmp_path, ek100_probe,
                                           monkeypatch):
    """The probe runs every --eval-in-middle-freq iterations (it > 0)
    and after the epoch, on the working copy in eval mode, which is back
    in train mode after it; its metrics land in log.txt and
    checkpoint_best.pt follows its mAP_avg."""
    from lavila_tpu_torch.cli import eval_zeroshot as ez
    root, meta = ek100_probe
    modes, probe = [], ez.eval_ek100_mir

    def spy(model, *args, **kw):
        modes.append(model.training)
        return probe(model, *args, **kw)
    monkeypatch.setattr(ez, "eval_ek100_mir", spy)
    run = tmp_path / "run"
    state = cli.main(_cfg(run, "--steps", "3", "--val-metadata", meta,
                          "--val-root", root, "--eval-in-middle-freq", "2",
                          "--metadata-aux", "synthetic_aux"))
    assert modes == [False, False]  # after it 2, and after the epoch
    assert state.model.training
    rec = json.loads((run / "log.txt").read_text().splitlines()[-1])
    assert {"mAP_avg", "nDCG_avg", "train_loss"} <= set(rec)
    assert (run / "checkpoint_best.pt").exists()
    best = json.loads((run / "checkpoint_best.pt.json").read_text())
    assert best["metrics"]["best_metric"] == rec["mAP_avg"]


def test_cli_wandb_unavailable_keeps_training(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the import fails
    state = cli.main(_cfg(tmp_path, "--wandb"))
    assert state.step == 2
    assert "(wandb unavailable:" in capsys.readouterr().out


class _WandbStub:
    """A ``wandb`` module that records ``init`` and every ``log``."""

    def __init__(self):
        self.inits, self.logs = [], []
        self.module = types.ModuleType("wandb")
        self.module.init = self.init

    def init(self, **kw):
        self.inits.append(kw)
        return types.SimpleNamespace(log=self.logs.append)


@pytest.fixture()
def wandb_stub(monkeypatch):
    stub = _WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub.module)
    return stub


def test_cli_wandb_logs_to_the_run(tmp_path, wandb_stub):
    cli.main(_cfg(tmp_path, "--wandb", "--print-freq", "1"))
    (init,) = wandb_stub.inits
    assert init["project"] == "lavila_tpu"
    assert init["config"]["model"] == MINI and init["config"]["wandb"]
    # one log a printed step, then the epoch's
    assert len(wandb_stub.logs) == 3
    assert set(wandb_stub.logs[0]) == {"loss", "clip_loss", "clip_acc"}
    assert wandb_stub.logs[-1]["epoch"] == 0
