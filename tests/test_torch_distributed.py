"""The port's data parallelism on the CPU: gloo ranks in processes of
their own (``tests/torch_dist_worker.py``) against the JAX package on a
2- or 4-device slice of the conftest's 8-device CPU mesh, on the same
seeded numpy inputs, fp32.

  * the collectives' conventions: the all-gather's backward is this
    rank's rows of the ranks' summed gradient, the all-reduce's the sum,
    ``average_grads`` the mean over coalesced buckets;
  * ``clip_loss_local``/``ssl_clip_loss_local`` on 2 and 4 ranks against
    JAX's ``shard_map`` bodies; the global ``clip_loss``,
    ``ssl_clip_loss``, ``max_margin_loss`` (adaptive weights too) and
    ``caption_loss`` (ranks with unequal padding) on 2 ranks against the
    JAX functions on the concatenated batch: loss and metrics rtol 1e-5,
    the gradients with respect to each rank's inputs (divided by the
    world size, the averaging ``train.step`` applies) and to the
    replicated scales (averaged over the ranks) rtol 1e-5;
  * two train steps on 2 ranks (SGD without momentum, so that the update
    stays linear in the gradients) against JAX's step on the global
    batch on a ``data=2`` mesh: the CLIP, local-loss and SSL steps,
    ``update_freq`` 2, clipping, the retrieval step (adaptive max-margin
    over the gathered batch, ``logit_scale`` frozen), the classifier
    step (EK-100's three heads) and the caption step under LaViLa's
    freeze flags with unequal token counts on the ranks; parameters
    within atol 1e-5 of JAX, the ranks bit-identical (rank 1 starts from
    perturbed weights, which ``broadcast_params`` replaces).

Each set of ranks runs once per module, under a timeout that fails the
tests rather than the suite.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from lavila_tpu import losses as JL
from lavila_tpu.parallel import create_mesh, shard_batch, shard_params
from lavila_tpu.train import freeze as JF
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_caption_train_step as jax_caption_step
from lavila_tpu.train.step import \
    make_classifier_train_step as jax_classifier_step
from lavila_tpu.train.step import make_clip_train_step as jax_clip_step
from lavila_tpu.train.step import \
    make_retrieval_train_step as jax_retrieval_step
from lavila_tpu_torch import losses as L
from lavila_tpu_torch.cli.launch import free_port
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.parallel import mesh
from test_torch_caption import VCLM
from test_torch_caption import _jax_params as vclm_params
from test_torch_classification import HEADS, _jax_classifier
from test_torch_train_step import MINI
from test_torch_train_step import _jax_params as clip_params

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
RANK_TIMEOUT = 240  # seconds for a set of ranks, start-up included
B, D = 8, 16


def run_ranks(tmp, world: int, cases: list, inputs: dict) -> list:
    """``cases`` on ``world`` gloo ranks, each a process; their outputs
    in rank order. A rank that fails or outlives the timeout fails the
    test, every rank killed."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"world": world, "port": free_port(),
                                "dir": str(tmp), "cases": cases,
                                "timeout": RANK_TIMEOUT}))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(tmp / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{text[-4000:]}"
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------- the inputs

def loss_inputs() -> dict:
    rng = np.random.default_rng(7)
    img = rng.normal(size=(B, D)).astype(np.float32)
    txt = rng.normal(size=(B, D)).astype(np.float32)
    txt[[1, 6]] = img[[1, 6]]  # clear matches, so the accuracy is not 0
    logits = rng.normal(size=(4, 9, 50), scale=3.0).astype(np.float32)
    labels = rng.integers(1, 50, (4, 9))
    labels[0, 3:] = 0   # rank 0: 3 + 5 kept tokens ...
    labels[1, 5:] = 0
    labels[3, 8:] = 0   # ... rank 1: 9 + 8
    logits[np.arange(4), 1, labels[:, 1]] += 20.0
    return {"img": img, "txt": txt, "scale": np.float32(5.0),
            "pscale": np.float32(3.0),
            "ind": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32),
            "weights": rng.uniform(0.2, 1.0, B).astype(np.float32),
            "logits": logits, "labels": labels}


def clip_batches(ssl: bool = False, relevancy: bool = False) -> list:
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        text = rng.integers(1, 49407, size=(4, 77)).astype(np.int32)
        text[np.arange(4), rng.integers(5, 77, size=4)] = 49407
        batch = {"frames": rng.normal(size=(4, 4, 64, 64, 3)).astype(
            np.float32), "text": text}
        if ssl:
            batch["gt_indicators"] = np.array([1, 0, 0, 1], np.float32)
        if relevancy:  # the EK-100 relevancy of each clip
            batch["relevancy"] = rng.uniform(0.2, 1.0, 4).astype(np.float32)
        out.append(batch)
    return out


def classify_batches() -> list:
    """Frames and the verb, noun and action ids (heads, B) of
    ``HEADS``."""
    rng = np.random.default_rng(9)
    return [{"frames": rng.normal(size=(4, 4, 64, 64, 3)).astype(
        np.float32), "labels": np.stack([rng.integers(0, h, 4)
                                         for h in HEADS])}
            for _ in range(2)]


def caption_batches() -> list:
    """Two caption batches whose first two rows (rank 0's) are short and
    whose last two (rank 1's) are long: the ranks' token counts differ."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        text = np.zeros((4, 12), np.int32)
        for b, n in enumerate((3, 4, 10, 11)):
            text[b, 0] = 50256
            text[b, 1:n] = rng.integers(1, 50256, n - 1)
            text[b, n] = 50256
        out.append({"frames": rng.normal(size=(4, 4, 64, 64, 3)).astype(
            np.float32), "text": text})
    return out


LOG_PSEUDO = np.float32(np.log(1 / 0.08))
RECIPE = {"freeze_lm_vclm": True, "freeze_visual_vclm": True}
# step case → what it trains on and how
STEPS = {
    "clip": {"model": MINI, "batches": "clip"},
    "local": {"model": MINI, "batches": "clip", "local": True},
    "ssl": {"model": MINI, "batches": "ssl", "ssl": True},
    "ssl_local": {"model": MINI, "batches": "ssl", "ssl": True,
                  "local": True},
    "update_freq2": {"model": MINI, "batches": "clip", "update_freq": 2},
    "clip_grad": {"model": MINI, "batches": "clip", "clip": 0.05},
    "caption_frozen": {"model": VCLM, "batches": "caption",
                       "freeze": RECIPE},
    "retrieval": {"model": MINI, "batches": "retrieval", "retrieval": True},
    "classifier": {"model": MINI, "weights": "classifier", "heads": HEADS,
                   "batches": "classify"},
}
LOSSES = ("clip", "ssl", "max_margin", "max_margin_adaptive", "caption")


@pytest.fixture(scope="module")
def jax_models():
    return {MINI: clip_params(), VCLM: vclm_params(),
            "classifier": _jax_classifier(HEADS)}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, jax_models):
    inputs = {**loss_inputs(), "log_pseudo": LOG_PSEUDO, "steps": STEPS,
              "state_dicts": {k: state_dict_from_jax(p)
                              for k, (_, p) in jax_models.items()},
              "batches": {"clip": clip_batches(),
                          "ssl": clip_batches(ssl=True),
                          "retrieval": clip_batches(relevancy=True),
                          "classify": classify_batches(),
                          "caption": caption_batches()}}
    cases = (["primitives:all"]
             + [f"loss:{n}" for n in (*LOSSES, "clip_local", "ssl_local")]
             + [f"step:{n}" for n in STEPS])
    return run_ranks(tmp_path_factory.mktemp("ranks2"), 2, cases, inputs)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks4"), 4,
                     ["loss:clip_local", "loss:ssl_local"], loss_inputs())


# ----------------------------------------------------------- collectives

def test_all_gather_forward_and_backward_convention(ranks2):
    """Forward: the ranks' rows in rank order. Backward: this rank's rows
    of the gradient summed over the ranks (each rank's loss is
    sum(gathered · weights), so the sum is 2× the weights)."""
    want = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                           for r in range(2)])
    weights = np.arange(12.0).reshape(6, 2) + 1
    for r, out in enumerate(ranks2):
        got = out["primitives:all"]
        np.testing.assert_array_equal(got["gathered"], want)
        np.testing.assert_array_equal(got["gather_grad"],
                                      2 * weights[3 * r:3 * (r + 1)])


def test_all_reduce_backward_sums_the_ranks_gradients(ranks2):
    """Rank r's loss is (r + 1)·Σ_ranks y: the gradient of y on every
    rank is the sum of the ranks' upstream gradients, 1 + 2."""
    for out in ranks2:
        np.testing.assert_array_equal(out["primitives:all"]["reduce_grad"],
                                      [3.0])


def test_average_grads_means_over_ranks_in_buckets(ranks2):
    """Tensors averaged in place across buckets smaller than the
    tensors (each its own bucket, the first two split from the third)."""
    want = [np.full((5,), 0.5), np.full((3, 4), 1.0), np.full((40,), 0.5)]
    for out in ranks2:
        for got, w in zip(out["primitives:all"]["averaged"], want):
            np.testing.assert_array_equal(got, w)


def test_broadcast_params_sends_rank_0s_masters_and_moments(ranks2):
    """Each rank's masters and AdamW moments differ before the broadcast
    (weights at the rank's id, gradients at rank + 1); after it every
    rank holds rank 0's: its weights -0.1 after one step of 0.1 from 0,
    its first moment 0.1 and second 0.001 from a gradient of 1."""
    got = [out["primitives:all"]["broadcast"] for out in ranks2]
    for key in ("params", "moments"):
        for a, b in zip(got[0][key], got[1][key]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0]["params"][0], -0.1, rtol=1e-5)
    moments = sorted({float(np.ravel(m)[0]) for m in got[1]["moments"]})
    np.testing.assert_allclose(moments, [0.001, 0.1, 1.0], rtol=1e-5)


def test_outside_a_group_the_collectives_are_identities():
    x = torch.arange(4.0).reshape(2, 2)
    assert not mesh.is_initialized()
    assert mesh.world() == 1 and mesh.rank() == 0 and mesh.local_rank() == 0
    assert mesh.all_gather(x) is x and mesh.all_reduce(x) is x
    grads = [x.clone()]
    mesh.average_grads(grads)
    assert torch.equal(grads[0], x)


@pytest.mark.parametrize("value,ok", [(-1, True), (1, True), (4, False),
                                      (2, False)])
def test_check_mesh_data_against_the_world(value, ok):
    if ok:
        assert mesh.check_mesh_data(value) == 1
    else:
        with pytest.raises(ValueError, match=f"--mesh-data {value} .* 1 "):
            mesh.check_mesh_data(value)


def test_rank_device_outside_a_group():
    assert mesh.rank_device("cuda") == torch.device("cuda", 0)
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------- losses

def _jax_loss(name, inp, world=None):
    """``(fn(args) -> metrics, args)``: the JAX loss on the global batch,
    or the ``*_local`` body under ``shard_map`` over ``world`` devices."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    if name == "caption":
        return (lambda lg: JL.caption_loss(lg, a["labels"])), (a["logits"],)
    if name.startswith("max_margin"):
        w = a["weights"] if name == "max_margin_adaptive" else None
        return (lambda i, t: JL.max_margin_loss(i, t, margin=0.2,
                                                weights=w)), (a["img"],
                                                              a["txt"])
    ssl = name.startswith("ssl")
    args = ((a["img"], a["txt"], a["scale"])
            + ((a["pscale"],) if ssl else ()))
    if not name.endswith("_local"):
        if ssl:
            return (lambda i, t, s, ps: JL.ssl_clip_loss(
                i, t, s, ps, a["ind"])), args
        return JL.clip_loss, args
    dmesh = Mesh(np.array(jax.devices()[:world]), axis_names=("data",))
    if ssl:
        body = shard_map(
            lambda i, t, s, ps, d: JL.ssl_clip_loss_local(i, t, s, ps, d),
            mesh=dmesh, in_specs=(P("data"), P("data"), P(), P(), P("data")),
            out_specs=P())
        return (lambda i, t, s, ps: body(i, t, s, ps, a["ind"])), args
    body = shard_map(lambda i, t, s: JL.clip_loss_local(i, t, s),
                     mesh=dmesh, in_specs=(P("data"), P("data"), P()),
                     out_specs=P())
    return body, args


def _check_loss(name, outs, world):
    inp = loss_inputs()
    fn, args = _jax_loss(name, inp, world)
    want = fn(*args)
    grads = jax.grad(lambda *x: fn(*x)["loss"],
                     argnums=tuple(range(len(args))))(*args)
    key = f"loss:{name}"
    for out in outs:  # every rank reports the global metrics
        got = out[key]["metrics"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for i, g in enumerate(grads):
        g = np.asarray(g)
        per_rank = [out[key]["grads"][i] for out in outs]
        if g.ndim == 0:  # a replicated scale: the ranks' mean
            np.testing.assert_allclose(np.mean(per_rank), g, rtol=1e-5)
            continue
        got = np.concatenate(per_rank) / world
        np.testing.assert_allclose(got, g, rtol=1e-5,
                                   atol=1e-6 * np.abs(g).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["clip_local", "ssl_local"])
def test_local_losses_match_shard_map(name, world, ranks2, ranks4):
    _check_loss(name, ranks2 if world == 2 else ranks4, world)


@pytest.mark.parametrize("name", LOSSES)
def test_global_losses_match_jax_on_the_global_batch(name, ranks2):
    _check_loss(name, ranks2, 2)


def test_caption_ranks_hold_unequal_token_counts():
    """The caption case is the one where a mean of the ranks' losses is
    not the global loss: it would differ from the JAX loss."""
    inp = loss_inputs()
    per_rank = [L.caption_loss(torch.from_numpy(inp["logits"][2 * r:
                                                              2 * r + 2]),
                               torch.from_numpy(inp["labels"][2 * r:
                                                              2 * r + 2]))
                ["loss"].item() for r in range(2)]
    want = float(JL.caption_loss(jnp.asarray(inp["logits"]),
                                 jnp.asarray(inp["labels"]))["loss"])
    assert abs(np.mean(per_rank) - want) > 1e-3 * abs(want)


# ------------------------------------------------------------ train steps

def _jax_steps(name, jax_models):
    cfg = STEPS[name]
    jm, params = jax_models[cfg.get("weights", cfg["model"])]
    dmesh = create_mesh(data=2, model=1, devices=jax.devices()[:2])
    tx = JO.make_optimizer(1e-2, weight_decay=0.0, use_sgd=True,
                           momentum=0.0, clip_grad_value=cfg.get("clip"),
                           update_freq=cfg.get("update_freq", 1))
    if "freeze" in cfg:
        tx = JF.freeze_by_predicate(
            tx, JF.build_freeze_predicate(**cfg["freeze"]))
    crit = ({"logit_scale_pseudo": jnp.asarray(LOG_PSEUDO)}
            if cfg.get("ssl") else None)
    state = JaxTrainState.create(params, tx, criterion_params=crit)
    state = state.replace(params=shard_params(state.params, dmesh))
    if cfg["model"] == VCLM:
        step = jax_caption_step(jm, pad_id=0)
        batches = caption_batches()
    elif "heads" in cfg:
        classify = jax_classifier_step(jm, multihead=True,
                                       label_smoothing=0.1)

        def step(state, batch):  # dropout 0: the key draws nothing
            return classify(state, batch, jax.random.key(0))
        batches = [{"frames": b["frames"], "labels": tuple(b["labels"])}
                   for b in classify_batches()]
    elif cfg.get("retrieval"):
        step = jax_retrieval_step(jm, loss_type="adaptive_max_margin",
                                  margin=0.4)
        batches = clip_batches(relevancy=True)
    else:
        step = jax_clip_step(jm, norm_embed=True, use_ssl=bool(crit),
                             local_loss_mesh=dmesh if cfg.get("local")
                             else None)
        batches = clip_batches(ssl=bool(crit))
    step = jax.jit(step)
    metrics = []
    for batch in batches:
        state, m = step(state, shard_batch(batch, dmesh))
        metrics.append({k: float(v) for k, v in m.items()})
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    if crit:
        want["logit_scale_pseudo"] = torch.tensor(np.asarray(
            state.criterion_params["logit_scale_pseudo"]))
    return metrics, want


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_steps_match_jax_global_step(name, ranks2, jax_models):
    """Both steps' metrics on both ranks within 1e-5 relative of JAX's;
    every parameter within 1e-5 of JAX's after them, the two ranks'
    bit-identical; frozen parameters where they started."""
    want_metrics, want = _jax_steps(name, jax_models)
    got = [out[f"step:{name}"] for out in ranks2]
    for out in got:
        for m, wm in zip(out["metrics"], want_metrics):
            for k in wm:
                assert m[k] == pytest.approx(wm[k], rel=1e-5, abs=1e-6), k
    assert got[0]["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[0]["params"][k],
                                      got[1]["params"][k], err_msg=k)
        np.testing.assert_allclose(got[0]["params"][k], w.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    cfg = STEPS[name]
    start = state_dict_from_jax(
        jax_models[cfg.get("weights", cfg["model"])][1])
    assert bool(got[0]["frozen"]) == ("freeze" in cfg)
    for k in got[0]["frozen"]:
        np.testing.assert_array_equal(got[0]["params"][k], start[k].numpy())
