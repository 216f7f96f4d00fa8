"""The classification fine-tune in the port against ``lavila_tpu``:
``VideoClassifier[MultiHead]`` forwards on the same weights, the
backbone/head labels, SGD and the two-group optimizer (each group
clipped by its own norm) against optax, classifier steps against
``make_classifier_train_step`` under the JAX CLI's optax chain, the
CLI's ``validate`` against the JAX one on the EGTEA, EK-100 CLS and
CharadesEgo fixtures, and the CLI end to end (per-epoch validation,
best tracking, auto-resume, ``--evaluate``, ``--pretrain-model`` from a
port pretraining checkpoint, ``--wandb``)."""

import argparse
import json
import math
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lavila_tpu.config import parse_config
from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.dual_encoder import VideoClassifier as JaxClassifier
from lavila_tpu.models.dual_encoder import \
    VideoClassifierMultiHead as JaxMultiHead
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_classifier_train_step as jax_step
from lavila_tpu_torch.cli import main_finetune_classification as cli
from lavila_tpu_torch.cli import main_finetune_retrieval as rcli
from lavila_tpu_torch.cli import main_pretrain as pcli
from lavila_tpu_torch.data.video import encode_test_video
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax, torch_key
from lavila_tpu_torch.models.dual_encoder import (VideoClassifier,
                                                  VideoClassifierMultiHead)
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import (TrainState,
                                         make_classifier_train_step)
from test_torch_ssl import _WandbStub, wandb_stub  # noqa: F401  (fixture)

torch.set_num_threads(1)

MINI = "CLIP_OPENAI_TIMESFORMER_MINI"
HEADS = [3, 5, 7]  # verbs, nouns, actions


def _jax_classifier(heads, seed=0, frames=4):
    """A JAX classifier over MINI's video tower (dropout 0), its
    parameters as numpy, the time attention away from its zero init."""
    vision = jax_build_model(MINI, num_frames=frames).vision_model
    clf = (JaxMultiHead(vision_model=vision, num_classes_list=heads)
           if isinstance(heads, list)
           else JaxClassifier(vision_model=vision, num_classes=heads))
    params = clf.init({"params": jax.random.key(seed),
                       "dropout": jax.random.key(1)},
                      jnp.zeros((1, frames, 64, 64, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return clf, params


def _port_classifier(heads, params, frames=4, dropout=0.0):
    vision = build_model(MINI, device="cpu", num_frames=frames).visual
    clf = (VideoClassifierMultiHead(vision, heads, dropout)
           if isinstance(heads, list) else VideoClassifier(vision, heads,
                                                           dropout))
    clf.load_state_dict(state_dict_from_jax(params), strict=True)
    return clf.train()


@pytest.mark.parametrize("heads", [7, HEADS], ids=["single", "multihead"])
def test_classifier_forward_matches_jax(heads):
    """Logits within 1e-4 of their largest; the bridge names the tower
    ``vision_model`` and the heads ``fc_cls`` / ``fc_cls_{i}``."""
    jclf, params = _jax_classifier(heads)
    clf = _port_classifier(heads, params).eval()
    frames = np.random.default_rng(3).normal(size=(2, 4, 64, 64, 3)) \
        .astype(np.float32)
    want = jclf.apply({"params": params}, jnp.asarray(frames))
    with torch.no_grad():
        got = clf(torch.from_numpy(frames))
    if not isinstance(heads, list):
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    names = [n for n, _ in clf.named_parameters()]
    assert names[0].startswith("vision_model.")
    assert [n for n in names if not n.startswith("vision_model.")] == (
        ["fc_cls.weight", "fc_cls.bias"] if not isinstance(heads, list)
        else [f"fc_cls_{i}.{k}" for i in range(3) for k in ("weight",
                                                            "bias")])


def test_classifier_init_and_dropout():
    """Heads normal(0.01) with zero bias; dropout from the given
    generator in train mode (inverted, rate 0.5), the identity in eval
    mode; the tower's drop path runs in train mode."""
    vision = build_model(MINI, device="cpu", drop_path_rate=0.5).visual
    clf = VideoClassifier(vision, 400, dropout=0.5)
    clf.init_weights(torch.Generator().manual_seed(0), backbone=False)
    w = clf.fc_cls.weight
    assert abs(w.std().item() - 0.01) < 1e-3 and not clf.fc_cls.bias.any()
    frames = torch.randn(8, 4, 64, 64, 3)
    clf.eval()
    a, b = clf.features(frames), clf.features(frames, torch.Generator())
    torch.testing.assert_close(a, b)
    clf.train()
    x = clf.features(frames, torch.Generator().manual_seed(1))
    y = clf.features(frames, torch.Generator().manual_seed(1))
    torch.testing.assert_close(x, y)  # the generator decides
    assert 0.3 < (x == 0).float().mean().item() < 0.7
    assert not torch.equal(
        x, clf.features(frames, torch.Generator().manual_seed(2)))


def test_lr_multiplier_labels_match_jax_leaf_for_leaf():
    _, params = _jax_classifier(HEADS)
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(
            JO.lr_multiplier_labels(params))[0]:
        key, _ = torch_key(tuple(str(k.key) for k in path), "vision_model")
        want[key] = label
    clf = _port_classifier(HEADS, params)
    got = O.lr_multiplier_labels(n for n, _ in clf.named_parameters())
    assert got == want
    assert set(got.values()) == {"head", "backbone"}
    # a dual encoder's tower is the backbone too
    assert O.lr_multiplier_labels(["visual.cls_token", "logit_scale"]) == {
        "visual.cls_token": "backbone", "logit_scale": "head"}


def _tree(rng, scale=3.0):
    init = {"w": rng.normal(size=(3, 4)), "bias": rng.normal(size=(4,)),
            "vision_model.w": rng.normal(size=(4, 4)),
            "vision_model.ln.scale": rng.normal(size=(4,))}
    init = {k: np.asarray(v, np.float32) for k, v in init.items()}
    grads = [{k: np.asarray(rng.normal(size=v.shape) * scale, np.float32)
              for k, v in init.items()} for _ in range(5)]
    return init, grads


def _compare_with_optax(tx, opt, params, init, grads):
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("clip", [None, 2.0])
def test_sgd_matches_optax(clip):
    """``make_optimizer(use_sgd=True)``: five updates on random gradients
    under a warm-up and cosine schedule, with the weight-decay mask (the
    matrices decay, the biases and norms not), against optax's
    clip → masked add_decayed_weights → sgd(momentum 0.9)."""
    init, grads = _tree(np.random.default_rng(4))
    kw = dict(weight_decay=0.1, clip_grad_value=clip, use_sgd=True)
    tx = JO.make_optimizer(JO.cosine_schedule(1e-1, 1e-3, 2, 3, 1, 1e-2),
                           **kw)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = O.make_optimizer(params.items(),
                           O.cosine_schedule(1e-1, 1e-3, 2, 3, 1, 1e-2),
                           **kw)
    assert isinstance(opt.inner, torch.optim.SGD)
    _compare_with_optax(tx, opt, params, init, grads)


@pytest.mark.parametrize("use_sgd", [False, True], ids=["adamw", "sgd"])
@pytest.mark.parametrize("update_freq", [1, 2])
def test_two_group_optimizer_matches_multi_transform(use_sgd, update_freq):
    """The head and the backbone, each with its own schedule and clipped
    by its own norm, with MultiSteps outside, against the JAX CLI's
    chain."""
    init, grads = _tree(np.random.default_rng(5))
    kw = dict(weight_decay=0.1, clip_grad_value=1.0, use_sgd=use_sgd)
    sched = {"head": (1e-2, 1e-4, 2, 2, 1, 1e-3),
             "backbone": (1e-3, 1e-4, 2, 2, 1, 1e-3)}
    tx = optax.multi_transform(
        {k: JO.make_optimizer(JO.cosine_schedule(*s), **kw)
         for k, s in sched.items()},
        lambda p: {k: "backbone" if k.startswith("vision_model") else "head"
                   for k in p})
    if update_freq > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=update_freq)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = O.make_multi_optimizer(
        params.items(), O.lr_multiplier_labels(params),
        {k: O.cosine_schedule(*s) for k, s in sched.items()},
        update_freq=update_freq, **kw)
    _compare_with_optax(tx, opt, params, init, grads)


def test_each_group_is_clipped_by_its_own_norm():
    """Two groups with gradient norms √27 and √48, clip 1: each comes out
    with norm 1 (one norm over both would leave them at √27/√75 and
    √48/√75), as optax.multi_transform hands each chain its own
    leaves."""
    params = {"head.w": torch.nn.Parameter(torch.zeros(3, 3)),
              "vision_model.w": torch.nn.Parameter(torch.zeros(3, 4))}
    opt = O.make_multi_optimizer(
        params.items(), O.lr_multiplier_labels(params),
        {"head": 1.0, "backbone": 1.0}, weight_decay=0.0,
        clip_grad_value=1.0, use_sgd=True)
    params["head.w"].grad = torch.full((3, 3), 3.0 ** 0.5)  # norm √27
    params["vision_model.w"].grad = torch.full((3, 4), 2.0)  # norm √48
    opt.step()  # sgd at lr 1: the update is minus the clipped gradient
    for p in params.values():
        assert torch.linalg.vector_norm(p.detach()).item() == \
            pytest.approx(1.0, rel=1e-6)


# -------------------------------------------------------------- the steps

def _cls_batches(kind, n, B=4, seed=0, frames=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = rng.normal(size=(B, frames, 64, 64, 3)).astype(np.float32)
        if kind == "multihead":
            lab = tuple(rng.integers(0, h, size=B) for h in HEADS)
        elif kind == "multilabel":
            lab = (rng.uniform(size=(B, 7)) < 0.4).astype(np.float32)
        else:
            lab = rng.integers(0, 7, size=B)
        out.append((f, lab))
    return out


SCHED = dict(base_lr=1e-3, final_lr=1e-4, epochs=2, steps_per_epoch=2,
             warmup_epochs=1, start_warmup_lr=1e-4)


@pytest.mark.parametrize("use_sgd", [False, True], ids=["adamw", "sgd"])
@pytest.mark.parametrize("kind", ["single", "multihead", "multilabel"])
@pytest.mark.parametrize("update_freq", [1, 2])
def test_classifier_steps_match_jax(use_sgd, kind, update_freq):
    """Three updates (six micro-steps under ``update_freq`` 2) from the
    same weights, label smoothing 0.1, the backbone at 0.1 times the
    head's rate, each group clipped by its own norm, MultiSteps outside
    the multi-transform: per-step loss within 1e-5 relative, acc1 equal,
    the final parameters within the MINI bound of
    tests/test_torch_train_step.py (2·Σ lr, all but a thousandth within
    1e-5)."""
    heads = HEADS if kind == "multihead" else 7
    jclf, params = _jax_classifier(heads)
    kw = dict(weight_decay=1e-4, clip_grad_value=1.0, use_sgd=use_sgd)
    sched = {"head": dict(SCHED),
             "backbone": dict(SCHED, base_lr=1e-4, final_lr=1e-5)}
    tx = optax.multi_transform(
        {k: JO.make_optimizer(JO.cosine_schedule(**s), **kw)
         for k, s in sched.items()}, JO.lr_multiplier_labels)
    if update_freq > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=update_freq)
    jstate = JaxTrainState.create(params, tx)
    jfn = jax.jit(jax_step(jclf, multihead=kind == "multihead",
                           label_smoothing=0.1))
    clf = _port_classifier(heads, params)
    state = TrainState.create(
        clf, lambda p: O.make_multi_optimizer(
            p, O.lr_multiplier_labels(n for n, _ in clf.named_parameters()),
            {k: O.cosine_schedule(**s) for k, s in sched.items()},
            update_freq=update_freq, **kw),
        dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    step = make_classifier_train_step(multihead=kind == "multihead",
                                      label_smoothing=0.1)
    rng = jax.random.key(0)
    for f, lab in _cls_batches(kind, 3 * update_freq):
        if kind == "multihead":
            jb = {"frames": jnp.asarray(f),
                  "labels": tuple(map(jnp.asarray, lab))}
            tb = {"frames": torch.from_numpy(f),
                  "labels": tuple(torch.from_numpy(x) for x in lab)}
        else:
            jb = {"frames": jnp.asarray(f), "label": jnp.asarray(lab)}
            tb = {"frames": torch.from_numpy(f),
                  "label": torch.from_numpy(lab)}
        rng, sub = jax.random.split(rng)
        jstate, jm = jfn(jstate, jb, sub)
        state, m = step(state, tb)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["acc1"].item() == pytest.approx(float(jm["acc1"]))
    if kind == "multilabel":
        assert m["acc1"].item() == 0.0
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    bound = 2 * sum(O.cosine_schedule(**SCHED)(t) for t in range(3))
    far = total = 0
    for name, p in state.params.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    moved = [n for n, p in state_dict_from_jax(params).items()
             if not torch.equal(p, state.params[n])]
    assert any(n.startswith("vision_model.") for n in moved)
    assert any(n.startswith("fc_cls") for n in moved)


def test_bf16_classifier_step():
    """bf16 compute on fp32 masters: the heads' working copies are bf16,
    the loss fp32 and finite."""
    _, params = _jax_classifier(HEADS)
    clf = _port_classifier(HEADS, params)
    state = TrainState.create(
        clf, lambda p: O.make_optimizer(p, 1e-3, use_sgd=True),
        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    f, lab = _cls_batches("multihead", 1)[0]
    state, m = make_classifier_train_step(multihead=True)(state, {
        "frames": torch.from_numpy(f),
        "labels": tuple(torch.from_numpy(x) for x in lab)})
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert state.model.fc_cls_2.weight.dtype == torch.bfloat16
    assert state.params["fc_cls_2.weight"].dtype == torch.float32


# ------------------------------------------------------------ validation

@pytest.fixture()
def egtea_fixture(tmp_path):
    """The EGTEA fixture of tests/test_finetune_cli.py."""
    root = tmp_path / "vids"
    (root / "P01-R01-VID").mkdir(parents=True)
    encode_test_video(str(root / "P01-R01-VID" / "P01-R01-VID-CLIP.mp4"),
                      64, 64, 30, 80)
    actions = tmp_path / "action_idx.txt"
    actions.write_text("Cut_tomato 1\nPour_water 2\n")
    split = tmp_path / "train_split1.txt"
    split.write_text("".join(
        f"P01-R01-VID-CLIP {1 + i % 2} x\n" for i in range(8)))
    return {"dataset": "egtea", "root": str(root),
            "metadata_train": str(split), "metadata_val": str(split),
            "label_metadata": str(actions)}


@pytest.fixture()
def ek100_cls_fixture(tmp_path):
    """EK-100 CLS: one video, six clips over three verbs and four nouns
    (five verb:noun actions), the csv laid out as
    tests/test_cli_smoke.py's EK-100 fixture."""
    root = tmp_path / "vids"
    (root / "P01").mkdir(parents=True)
    encode_test_video(str(root / "P01" / "P01_01.MP4"), 64, 64, 30, 150)
    header = ("narration_id,participant_id,video_id,narration_timestamp,"
              "start_timestamp,stop_timestamp,start_frame,stop_frame,"
              "narration,verb,verb_class,noun,noun_class,all_nouns,"
              "all_noun_classes\n")
    vn = [(0, 0), (1, 2), (2, 3), (0, 1), (1, 2), (2, 0)]
    rows = [f"P01_{i},P01,P01_01,00:00:00.0,00:00:0{i % 3}.0,"
            f"00:00:0{i % 3 + 2}.0,0,60,narr {i},v,{v},n,{n},[],[]\n"
            for i, (v, n) in enumerate(vn)]
    meta = tmp_path / "EPIC_100_validation.csv"
    meta.write_text(header + "".join(rows))
    return {"dataset": "ek100_cls", "root": str(root),
            "metadata_train": str(meta), "metadata_val": str(meta),
            "label_metadata": ""}


@pytest.fixture()
def charades_ego_fixture(tmp_path):
    """The CharadesEgo untrimmed val csv and classes file of
    tests/test_finetune_cli.py (the video under its trimmed clips)."""
    root = tmp_path / "vids"
    root.mkdir()
    encode_test_video(str(root / "VID1EGO.mp4"), 64, 64, 30, 120)
    val_csv = tmp_path / "CharadesEgo_v1_test_only1st.csv"
    val_csv.write_text(
        "id,subject,scene,quality,relevance,verified,script,objects,"
        "descriptions,actions,length\n"
        "VID1EGO,s,Kitchen,5,5,Yes,script,objects,desc,"
        "c092 0.5 2.0;c147 0.2 2.5,3.0\n"
        "VID1EGO,s,Kitchen,5,5,Yes,script,objects,desc,"
        "c100 0.1 1.0,3.0\n")
    classes = tmp_path / "Charades_v1_classes.txt"
    classes.write_text("c092 someone is cooking\nc147 someone is eating\n"
                       "c100 someone is running\n")
    return {"dataset": "charades_ego", "root": str(root),
            "metadata_train": str(val_csv), "metadata_val": str(val_csv),
            "label_metadata": str(classes)}


def _val_args(fixture, **kw):
    ns = argparse.Namespace(
        clip_length=4, clip_stride=2, num_clips=1, num_crops=1,
        sparse_sample=False, batch_size=4, workers=2, num_classes=0,
        use_vn_classifier=False, model=MINI, **fixture)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("case", [
    ("egtea", {}), ("egtea", {"num_crops": 3}),
    ("ek100_cls", {"use_vn_classifier": True}), ("ek100_cls", {}),
    ("charades_ego", {})], ids=["egtea", "egtea_3crops", "ek100_vn",
                                "ek100_action", "charades_ego"])
def test_validate_matches_jax(case, request):
    """The port's ``validate`` against the JAX CLI's on the same weights
    and the same fixture: every metric within 1e-5."""
    from cli.main_finetune_classification import validate as jax_validate
    name, kw = case
    args = _val_args(request.getfixturevalue(f"{name}_fixture"), **kw)
    labels, mapping, num_classes, parts, heads = cli.label_space(args)
    jclf, params = _jax_classifier(heads)
    clf = _port_classifier(heads, params)
    want = jax_validate(args, jclf, params, mapping, num_classes, parts,
                        MINI, labels)
    got = cli.validate(args, clf, mapping, num_classes, parts, MINI)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-5), k
    assert clf.training  # back in train mode
    if name == "ek100_cls":
        assert {"verb_acc1", "noun_acc1"} <= set(got)
        if kw:
            assert heads == [3, 4, 5]


# ----------------------------------------------------------------- the CLI

def _cli_args(out, fixture, *extra):
    flags = ["--model", MINI, "--clip-length", "4", "--clip-stride", "2",
             "--batch-size", "4", "--workers", "2", "--epochs", "1",
             "--eval-freq", "1", "--device", "cpu", "--output-dir",
             str(out)]
    for k, v in fixture.items():
        flags += [f"--{k.replace('_', '-')}", v]
    return cli.get_args_parser().parse_args(flags + list(extra))


def test_cli_validates_keeps_the_best_and_resumes(tmp_path, egtea_fixture):
    """Per-epoch validation in log.txt with best tracking; a second run
    of the same output directory resumes at epoch 1 with the best metric
    (tests/test_finetune_cli.py)."""
    run = tmp_path / "run"
    cli.main(_cli_args(run, egtea_fixture))
    rec = json.loads((run / "log.txt").read_text().splitlines()[-1])
    assert {"acc1", "acc5", "mean_class_acc", "train_loss"} <= set(rec)
    assert rec["epoch"] == 0
    best = json.loads((run / "checkpoint_best.pt.json").read_text())
    assert best["metrics"]["best_metric"] == rec["acc1"]
    assert best["config"]["num_classes"] == 2
    state = cli.main(_cli_args(run, egtea_fixture, "--epochs", "2"))
    meta = json.loads((run / "checkpoint_latest.pt.json").read_text())
    assert meta["epoch"] == 1 and state.step == 4  # epoch 0 not retrained
    assert math.isfinite(meta["metrics"]["best_metric"])
    ckpt = torch.load(run / "checkpoint_latest.pt", weights_only=True)
    assert {"head", "backbone"} <= set(ckpt)


def test_cli_evaluate_only(tmp_path, egtea_fixture):
    out = cli.main(_cli_args(tmp_path / "run", egtea_fixture, "--evaluate"))
    assert {"acc1", "acc5", "mean_class_acc"} == set(out)
    assert not (tmp_path / "run" / "checkpoint_latest.pt").exists()


def test_cli_multihead_ek100_trains_and_validates(tmp_path,
                                                  ek100_cls_fixture):
    """--use-vn-classifier: the verb, noun and action heads train on the
    labels the action map gives, with SGD; validation marginalises."""
    run = tmp_path / "run"
    state = cli.main(_cli_args(run, ek100_cls_fixture, "--use-vn-classifier",
                               "--use-sgd", "--bf16"))
    assert isinstance(state.model, VideoClassifierMultiHead)
    assert [fc.out_features for fc in state.model.heads()] == [3, 4, 5]
    rec = json.loads((run / "log.txt").read_text().splitlines()[-1])
    assert {"verb_acc1", "noun_acc1", "acc1"} <= set(rec)
    assert math.isfinite(rec["train_loss"])
    for label in ("head", "backbone"):
        opt = state.optimizer.optimizers[label]
        assert isinstance(opt.inner, torch.optim.SGD)


def test_cli_charades_trains_on_actions_and_validates_mAP(
        tmp_path, charades_ego_fixture):
    """CharadesEgo trains on its trimmed action instances (one class
    each, as the JAX CLI's dataset gives them) and validates the
    untrimmed videos' multi-hot labels by mAP, the best checkpoint
    following it."""
    run = tmp_path / "run"
    cli.main(_cli_args(run, charades_ego_fixture, "--batch-size", "2"))
    rec = json.loads((run / "log.txt").read_text().splitlines()[-1])
    assert math.isfinite(rec["train_loss"]) and set(rec) == {
        "train_loss", "train_acc1", "video_mAP", "epoch"}
    best = json.loads((run / "checkpoint_best.pt.json").read_text())
    assert best["metrics"]["best_metric"] == rec["video_mAP"]


def _synthetic(out, *extra):
    return cli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", MINI, "--clip-length", "4",
        "--batch-size", "4", "--workers", "2", "--steps", "2",
        "--device", "cpu", "--output-dir", str(out), *extra])


def test_cli_pretrain_model_from_a_port_checkpoint(tmp_path):
    """A port SSL pretraining checkpoint: only its video tower is loaded,
    bit-equal, its sidecar config builds the tower at --clip-length; then
    the classifier trains, the backbone at a tenth of the head's rate."""
    pcli.main(parse_config(pcli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--model", MINI, "--steps", "1",
        "--batch-size", "4", "--workers", "2", "--device", "cpu",
        "--metadata-aux", "synthetic_aux", "--output-dir",
        str(tmp_path / "pre")]))
    path = str(tmp_path / "pre" / "checkpoint_latest.pt")
    args = _synthetic(tmp_path / "run", "--pretrain-model", path,
                      "--num-classes", "6", "--fix-lr")
    clf, config = cli.build_classifier(args, 6, torch.device("cpu"))
    saved = torch.load(path, weights_only=True)
    assert "criterion" in saved
    visual = {k.removeprefix("visual."): v
              for k, v in saved["state_dict"].items()
              if k.startswith("visual.")}
    got = clf.vision_model.state_dict()
    assert set(got) == set(visual)
    for k, v in visual.items():
        assert torch.equal(got[k], v), k
    assert config["model"] == MINI and clf.training
    state = cli.main(args)
    assert state.step == 2
    labels = O.lr_multiplier_labels(state.params)
    assert {labels[n] for n in state.params} == {"head", "backbone"}
    rates = {k: o.scheduler.get_last_lr()[0]
             for k, o in state.optimizer.optimizers.items()}
    assert rates["backbone"] == pytest.approx(0.1 * rates["head"])


def test_cli_use_checkpoint_trains_with_remat(tmp_path):
    state = cli.main(_synthetic(tmp_path, "--use-checkpoint"))
    assert state.step == 2 and state.model.vision_model.remat


@pytest.mark.parametrize("policy", ["dots", "save_attn", "dots_attn"])
def test_cli_remat_policy_trains_as_no_remat(tmp_path, policy):
    """``--use-checkpoint --remat-policy`` reaches the backbone, and the
    classifier trained under it (drop-path and dropout drawn from one
    seeded generator) ends at the masters of a run without remat, bit
    for bit."""
    state = cli.main(_synthetic(tmp_path / policy, "--use-checkpoint",
                                "--remat-policy", policy))
    assert state.model.vision_model.remat_policy == policy
    plain = cli.main(_synthetic(tmp_path / "none"))
    for name, p in plain.params.items():
        assert torch.equal(state.params[name], p), name


def test_cli_options_that_raise(tmp_path, egtea_fixture):
    with pytest.raises(ValueError, match="ek100_cls"):
        cli.main(_cli_args(tmp_path, egtea_fixture, "--use-vn-classifier"))
    if not torch.cuda.is_available():
        args = _synthetic(tmp_path)
        args.device = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)


@pytest.mark.parametrize("which", ["classification", "retrieval"])
def test_cli_wandb_unavailable_keeps_training(tmp_path, monkeypatch, capsys,
                                              which):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the import fails
    main, parser = ((cli.main, _synthetic) if which == "classification"
                    else (rcli.main, _retrieval_synthetic))
    state = main(parser(tmp_path, "--wandb"))
    assert state.step == 2
    assert "(wandb unavailable:" in capsys.readouterr().out


def _retrieval_synthetic(out, *extra):
    return rcli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", MINI, "--clip-length", "4",
        "--batch-size", "4", "--workers", "2", "--steps", "2",
        "--device", "cpu", "--output-dir", str(out), *extra])


@pytest.mark.parametrize("which", ["classification", "retrieval"])
def test_cli_wandb_logs_to_the_run(tmp_path, wandb_stub, which):
    main, parser = ((cli.main, _synthetic) if which == "classification"
                    else (rcli.main, _retrieval_synthetic))
    main(parser(tmp_path, "--wandb", "--print-freq", "1"))
    (init,) = wandb_stub.inits
    assert init["project"] == "lavila_tpu" and init["config"]["wandb"]
    want = {"loss", "acc1"} if which == "classification" else {"loss"}
    assert len(wandb_stub.logs) == 2
    assert all(set(log) == want for log in wandb_stub.logs)


def test_pickled_synthetic_dataset_labels():
    """The synthetic dataset's clip i is of class i % num_classes."""
    from lavila_tpu_torch.data.datasets import DatasetConfig
    ds = cli.SyntheticClassDataset(
        DatasetConfig(dataset="synthetic", root="", metadata="",
                      clip_length=4), None, 7)
    ds = pickle.loads(pickle.dumps(ds))
    assert [int(ds[i]["label"]) for i in (0, 6, 7, 13)] == [0, 6, 0, 6]
