"""The port's tensor parallelism on the CPU: gloo ranks in processes of
their own (``tests/torch_tp_worker.py``) against the JAX package, whose
sharded execution equals its replicated one
(``tests/test_tensor_parallel.py``), on the same seeded inputs, fp32.

  * GPT-2 MINI with cross-attention, sharded over 4 ranks: the forward
    (atol 2e-5, rtol 1e-4) and the KV-cached decode, prefill plus 3
    greedy steps (atol 3e-5, rtol 1e-4), against the JAX functions;
    5 heads over 2 ranks (3/2 heads) for the uneven split;
  * the MINI dual encoder's and the MINI narrator's SGD steps (lr 1e-2)
    on data=2 x model=2: loss rtol 1e-5, every gathered parameter rtol
    1e-4, atol 1e-5 against the JAX step; the replicated parameters'
    gradients equal on the ranks of a model group;
  * the sharded set: every MINI family's parameters that JAX's
    ``param_sharding_rules`` shards, with the dim, equal the port's;
  * ``main_pretrain --mesh-model 2`` (the CLIP dual encoder and the
    VCLM caption step under LaViLa's freeze flags) and ``--mesh-model
    4`` over gloo: the wide layers sharded, AdamW's moments sharded like
    them, the losses and the step's gradients (gathered) those of one
    process, the checkpoint the whole layout, served by
    ``eval_zeroshot`` in one process and resumed at ``--mesh-model 1``.

Each set of ranks runs once per module, under a timeout that fails the
tests rather than the suite.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.config import parse_config
from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from lavila_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from lavila_tpu.models.gpt2 import augment_config as jax_augment
from lavila_tpu.models.gpt2 import init_cache as jax_init_cache
from lavila_tpu.parallel import param_sharding_rules as jax_rules
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_caption_train_step as jax_caption_step
from lavila_tpu.train.step import make_clip_train_step as jax_clip_step
from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli import main_pretrain as cli
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import state_dict_from_jax, torch_key
from lavila_tpu_torch.parallel import mesh, sharding
from lavila_tpu_torch.parallel.tensor import Split, even_sizes
from test_torch_caption import _captions
from test_torch_caption import _jax_params as caption_params
from test_torch_train_step import MINI
from test_torch_train_step import _jax_params as clip_params
from torch_tp_worker import join_ranks, start_ranks

torch.set_num_threads(1)

VCLM = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
# the JAX tests' GPT-2 MINIs: cross-attention on every layer
GPT2 = {"even": dict(vocab_size=64, n_positions=16, n_embd=64, n_layer=2,
                     n_head=4),
        "uneven": dict(vocab_size=64, n_positions=16, n_embd=80, n_layer=2,
                       n_head=5),
        "decode": dict(vocab_size=96, n_positions=24, n_embd=64, n_layer=2,
                       n_head=4)}
GATED = {"even": False, "uneven": False, "decode": True}
IDS = {"even": [[3, 9, 27, 5]], "uneven": [[3, 9, 27, 5]],
       "decode": [[5, 17, 3, 9]]}


def _gpt2_case(name):
    """The JAX GPT-2 of a case on key(0) (its gates, where it has any,
    seeded non-zero so the cross-attention counts), its inputs, and the
    port's config and state dict."""
    cfg = GPT2[name]
    jcfg = jax_augment(JaxGPT2Config(**cfg), cross_attn_freq=1,
                       gated_xattn=GATED[name])
    jm = JaxGPT2(jcfg)
    ids = jnp.array(IDS[name], jnp.int32)
    enc = jax.random.normal(jax.random.key(2), (1, 6, cfg["n_embd"]))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), ids,
                                              enc)["params"])
    rng = np.random.default_rng(4)
    for blk in params.values():
        if isinstance(blk, dict) and "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    sd = {k.removeprefix("text_decoder."): v for k, v in
          state_dict_from_jax({"text_decoder": params}).items()}
    port = {"cfg": {**cfg, "cross_attn_freq": 1,
                    "gated_xattn": GATED[name]},
            "state_dict": sd, "ids": np.asarray(ids), "enc": np.asarray(enc)}
    return jm, jcfg, params, ids, enc, port


def _jax_forward(name):
    jm, _, params, ids, enc, _ = _gpt2_case(name)
    return np.asarray(jm.apply({"params": params}, ids, enc)[0])


def _jax_decode():
    """Prefill 4 tokens, then 3 cached greedy steps: the stacked last
    logits (``tests/test_tensor_parallel.py:136``)."""
    jm, jcfg, params, ids, enc, _ = _gpt2_case("decode")
    p = {"params": params}
    cache = jax_init_cache(jcfg, 1, 12, jnp.float32)
    cross_kv = jm.apply(p, enc, method="precompute_cross_kv")
    logits, cache = jm.apply(p, ids, cross_kv=cross_kv, cache=cache,
                             cache_index=0)
    outs = [logits[:, -1]]
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    idx = ids.shape[1]
    for _ in range(3):
        logits, cache = jm.apply(p, tok, cross_kv=cross_kv, cache=cache,
                                 cache_index=idx)
        outs.append(logits[:, -1])
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        idx += 1
    return np.asarray(jnp.stack(outs, 1))


def _step_batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        text = rng.integers(1, 49407, size=(8, 77)).astype(np.int32)
        text[np.arange(8), rng.integers(5, 77, size=8)] = 49407
        out.append({"frames": rng.normal(size=(8, 4, 64, 64, 3)).astype(
            np.float32), "text": text})
    return out


def _cli_argv(out, model, mesh_model, *extra):
    return ["--dataset", "synthetic", "--model", model, "--steps", "1",
            "--batch-size", "8", "--epochs", "2", "--workers", "1",
            "--clip-length", "4", "--device", "cpu", "--disable-amp",
            "--output-dir", str(out), "--mesh-model", str(mesh_model),
            *extra]


RECIPE = ("--gated-xattn", "--freeze-lm-vclm", "--freeze-visual-vclm")
# a clipping norm below the step's gradient norm: the clipped update
# depends on the global norm over the shards
CLIP = 0.05


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """$LAVILA_TOKENIZER_DIR with a synthetic gpt2 vocabulary (the
    layout of ``tests/test_eval_narrator_cli.py:gpt2_vocab_dir``)."""
    from lavila_tpu.data.tokenizers import byte_unicode_table
    root = tmp_path_factory.mktemp("tok")
    d = root / "gpt2"
    d.mkdir()
    vocab = {u: i for i, u in enumerate(byte_unicode_table().values())}
    merges = ["Ġ t", "Ġt h", "Ġth e", "h e", "l l", "he ll", "hell o"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n")
    return str(root)


def _layer_inputs():
    gen = torch.Generator().manual_seed(7)
    first, second = torch.nn.Linear(5, 7), torch.nn.Linear(7, 3)
    for p in (*first.parameters(), *second.parameters()):
        with torch.no_grad():
            p.normal_(generator=gen)
    return {"first": first.state_dict(), "second": second.state_dict(),
            "x": torch.randn(4, 5, generator=gen).numpy(),
            "w": torch.randn(4, 3, generator=gen).numpy()}


def _narrator_inputs():
    """The MINI narrator's seeded weights (its cross-attention gates at
    0.5, so the sharded cross-attention counts) and two clips."""
    model = build_model(VCLM, device="cpu", gated_xattn=True,
                        generator=torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith(("alpha_cattn", "alpha_dense")):
            sd[k].fill_(0.5)
    rng = np.random.default_rng(6)
    return {"model": VCLM, "state_dict": sd, "bos": 50256,
            "frames": rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_clip():
    return clip_params(seed=3)


@pytest.fixture(scope="module")
def jax_caption():
    return caption_params()


def _caption_batches():
    return [_captions(seed=seed) for seed in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_clip, jax_caption, vocab_dir):
    """One set of 4 ranks (GPT-2 over model=4, the steps over data=2 x
    model=2, the CLI at --mesh-model 4) and one of 2 (the uneven GPT-2,
    the CLIs at --mesh-model 2)."""
    base = tmp_path_factory.mktemp("tp")
    _, params = jax_clip
    inputs = {name: _gpt2_case(name)[-1] for name in GPT2}
    inputs["step"] = {"model": MINI, "state_dict": state_dict_from_jax(
        params), "batches": _step_batches()}
    inputs["step_clip"] = {**inputs["step"], "clip": CLIP}
    inputs["caption"] = {"model": VCLM, "state_dict": state_dict_from_jax(
        jax_caption[1]), "batches": _caption_batches()}
    inputs["narrate"] = _narrator_inputs()
    inputs["layers"] = _layer_inputs()
    inputs["cli"] = {
        "clip4": _cli_argv(base / "clip4", MINI, 4),
        "clip2": _cli_argv(base / "clip2", MINI, 2),
        "vclm2": _cli_argv(base / "vclm2", VCLM, 2, *RECIPE),
        "vclm2_ungated": _cli_argv(base / "vclm2_ungated", VCLM, 2,
                                   *RECIPE[1:])}
    env = {"LAVILA_TOKENIZER_DIR": vocab_dir}
    # both sets at once
    four = start_ranks(base / "ranks4", 4,
                       ["gpt2_fwd:even", "gpt2_decode:decode",
                        "tp_step:step", "tp_step:step_clip",
                        "tp_caption:caption", "cli:clip4"],
                       inputs, model=4,
                       case_model={"tp_step:step": 2,
                                   "tp_step:step_clip": 2,
                                   "tp_caption:caption": 2}, env=env)
    two = start_ranks(base / "ranks2", 2,
                      ["gpt2_fwd:uneven", "narrate:narrate",
                       "layers:layers", "cli:clip2", "cli:vclm2",
                       "cli:vclm2_ungated"], inputs,
                      model=2, env=env)
    return {"four": join_ranks(four), "two": join_ranks(two), "base": base,
            "inputs": inputs}


# ------------------------------------------------------------------ GPT-2

def test_gpt2_tp_sharded_forward_matches_replicated(runs):
    want = _jax_forward("even")
    for out in runs["four"]:
        got = out["gpt2_fwd:even"]
        assert got["heads"] == [1, 1] and got["local_width"] == 16
        np.testing.assert_allclose(got["logits"], want, atol=2e-5,
                                   rtol=1e-4)


def test_gpt2_tp_uneven_heads_forward_matches_replicated(runs):
    """5 heads over 2 ranks: 3 and 2, whole heads of 16 each."""
    want = _jax_forward("uneven")
    for r, out in enumerate(runs["two"]):
        got = out["gpt2_fwd:uneven"]
        assert got["heads"] == [[3, 3], [2, 2]][r]
        assert got["local_width"] == [48, 32][r]
        np.testing.assert_allclose(got["logits"], want, atol=2e-5,
                                   rtol=1e-4)


def test_gpt2_tp_kv_cache_decode_matches_replicated(runs):
    want = _jax_decode()
    for out in runs["four"]:
        got = out["gpt2_decode:decode"]
        assert got["cache_shape"] == [1, 12, 16]  # the rank's one head
        np.testing.assert_allclose(got["logits"], want, atol=3e-5,
                                   rtol=1e-4)


def test_gathered_column_into_sliced_row_matches_one_linear_pair(runs):
    """``gather_output`` (uneven: 4 and 3 of 7 outputs) and a row layer
    slicing its replicated input (``input_is_parallel=False``): output
    and input gradient those of the two whole layers, on both ranks."""
    inp = _layer_inputs()
    first, second = torch.nn.Linear(5, 7), torch.nn.Linear(7, 3)
    first.load_state_dict(inp["first"])
    second.load_state_dict(inp["second"])
    x = torch.as_tensor(inp["x"]).clone().requires_grad_()
    out = second(first(x))
    (out * torch.as_tensor(inp["w"])).sum().backward()
    for got in (o["layers:layers"] for o in runs["two"]):
        np.testing.assert_allclose(got["out"], out.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["grad"], x.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_tp_narrator_ranks_decode_alike(runs):
    """The sharded narrator on 2 ranks: sampled ids equal on both ranks
    although each rank's generator has its own seed (model rank 0's
    draw is broadcast), and the greedy and beam-search ids those of one
    process on the same weights."""
    from lavila_tpu_torch.models.beam import BeamDecoder
    got = [out["narrate:narrate"] for out in runs["two"]]
    for key in ("sampled", "greedy", "beam"):
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    inp = _narrator_inputs()
    model = build_model(VCLM, device="cpu", gated_xattn=True)
    model.load_state_dict(inp["state_dict"])
    model.eval()
    with torch.inference_mode():
        tokens = model.encode_image(torch.as_tensor(inp["frames"]))
        greedy, _ = model.generate(tokens, generator=None, top_k=1,
                                   bos_id=50256, eos_id=50256,
                                   max_text_length=12,
                                   num_return_sequences=2)
        beam, _ = BeamDecoder(model, 50256, 50256,
                              max_text_length=12).beam_search(tokens,
                                                              num_beams=3)
    np.testing.assert_array_equal(got[0]["greedy"], greedy.numpy())
    np.testing.assert_array_equal(got[0]["beam"], beam)


# ------------------------------------------------------------- the step

def _jax_steps(jax_clip, clip=None):
    jm, params = jax_clip
    tx = JO.make_optimizer(1e-2, use_sgd=True, momentum=0.0,
                           weight_decay=0.0, clip_grad_value=clip)
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_clip_step(jm, norm_embed=True))
    metrics = []
    for batch in _step_batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_dict_from_jax(jax.tree.map(np.asarray,
                                                     state.params))


@pytest.mark.parametrize("case", ["step", "step_clip"])
def test_tp_train_step_matches_replicated_step(runs, jax_clip, case):
    """data=2 x model=2: both steps' loss within rtol 1e-5 of JAX's on
    every rank, every parameter (the shards gathered) within rtol 1e-4,
    atol 1e-5; the replicas' masters bit-identical. ``step_clip`` clips
    by global norm: the squares of the shards summed over the model
    group, each replicated gradient counted once."""
    want_metrics, want = _jax_steps(jax_clip,
                                    CLIP if case == "step_clip" else None)
    got = [out[f"tp_step:{case}"] for out in runs["four"]]
    for out in got:
        for m, wm in zip(out["metrics"], want_metrics):
            assert m["loss"] == pytest.approx(wm["loss"], rel=1e-5)
    assert got[0]["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[0]["params"][k], w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        for out in got[1:]:
            np.testing.assert_array_equal(out["params"][k],
                                          got[0]["params"][k], err_msg=k)


def test_tp_caption_step_matches_replicated_step(runs, jax_caption):
    """The MINI narrator's caption step at data=2 x model=2, nothing
    frozen: GPT-2's and the pooler's sharded layers (the pooler's K/V
    head gathered and read by each rank's query heads, its gradient
    summed over them) and the video tower upstream of the pooler trained
    as JAX's replicated SGD step trains them: both steps' losses within
    rtol 1e-5, every parameter (the shards gathered) within rtol 1e-4,
    atol 1e-5; the replicas' masters bit-identical."""
    jm, params = jax_caption
    tx = JO.make_optimizer(1e-2, use_sgd=True, momentum=0.0,
                           weight_decay=0.0)
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_caption_step(jm, pad_id=0))
    losses = []
    for frames, text in _caption_batches():
        state, m = step(state, {"frames": jnp.asarray(frames),
                                "text": jnp.asarray(text)})
        losses.append(float(m["loss"]))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    got = [out["tp_caption:caption"] for out in runs["four"]]
    assert "img_attn_pool.to_kv.weight" in got[0]["sharded"]
    assert "img_attn_pool.to_q.weight" in got[0]["sharded"]
    for out in got:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    assert got[0]["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[0]["params"][k], w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        for out in got[1:]:
            np.testing.assert_array_equal(out["params"][k],
                                          got[0]["params"][k], err_msg=k)


def test_tp_replicated_gradients_agree_across_model_ranks(runs):
    """The conjugate operators leave every replicated parameter's
    gradient the same on the ranks of a model group (ranks 0, 1 and
    2, 3), with no all-reduce of their own."""
    got = [out["tp_step:step"]["replicated_grads"] for out in runs["four"]]
    assert {"logit_scale", "visual.norm.weight",
            "token_embedding.weight"} <= got[0].keys()
    for a, b in ((0, 1), (2, 3)):
        assert got[a].keys() == got[b].keys()
        for k in got[a]:
            np.testing.assert_array_equal(got[a][k], got[b][k], err_msg=k)


def test_tp_step_holds_only_this_ranks_shards(runs):
    """At model=2 every sharded master is half of the whole (MINI's 4
    heads and 256 hidden features split evenly)."""
    sharded = runs["four"][0]["tp_step:step"]["sharded"]
    assert any(k.endswith("attn.qkv.weight") for k in sharded)
    assert any(k.endswith("in_proj_weight") for k in sharded)
    for k, (local, whole) in sharded.items():
        dim = 0 if local[0] != whole[0] else 1
        assert local[dim] * 2 == whole[dim], k


# ------------------------------------------------------- the sharded set

def _jax_specs(jm, *args):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        spec = jax_rules(path, leaf.shape)
        if "model" in tuple(spec):
            dim = tuple(spec).index("model")
            names = tuple(k.key for k in path)
            key, layout = torch_key(names)
            # a flax Dense kernel is (in, out), a torch weight (out, in)
            out[key] = (1 - dim) if layout == "dense" else dim
    return out


def _families():
    from test_torch_distilbert import _inputs as bert_inputs
    from test_torch_distilbert import _jax_model as jax_bert
    from test_torch_distilbert import _port_model as port_bert
    from test_torch_vit_cli import _jax_narrator, _vclm_vit_mini
    frames = jnp.zeros((1, 4, 64, 64, 3))
    f, t, m = bert_inputs(0)
    return {
        "clip": (lambda: _jax_specs(jax_build_model(MINI), frames,
                                    jnp.zeros((1, 77), jnp.int32)),
                 lambda: build_model(MINI, device="cpu")),
        "vclm": (lambda: _jax_specs(
            jax_build_model(VCLM, num_frames=4, gated_xattn=True), frames,
            jnp.zeros((1, 8), jnp.int32)),
            lambda: build_model(VCLM, device="cpu", gated_xattn=True)),
        "distilbert": (lambda: _jax_specs(jax_bert(), jnp.asarray(f),
                                          jnp.asarray(t), jnp.asarray(m)),
                       port_bert),
        "vit_narrator": (lambda: _jax_specs(_jax_narrator(), frames,
                                            jnp.zeros((1, 8), jnp.int32)),
                         _vclm_vit_mini),
    }


@pytest.mark.parametrize("family", ["clip", "vclm", "distilbert",
                                    "vit_narrator"])
def test_dual_encoder_tp_rules_cover_wide_layers(family):
    """The parameters JAX's rules shard, by the port's names and with
    the torch dim, are exactly those the port's rules name and those
    ``shard_model`` shards (its plan at 2 ranks)."""
    jax_side, port_model = _families()[family]
    want = jax_side()
    model = port_model()
    rules = {n: d for n, p in model.named_parameters()
             if (d := sharding.param_sharding_rules(n, p.shape)) is not None}
    planned = {n: s.dim for n, s in sharding.plan(model, 2).items()}
    assert want and rules == want
    assert planned == want
    names = dict(model.named_parameters())
    assert set(want) <= names.keys()
    # the norms stay whole
    assert not any("norm" in k or k.endswith("ln_1.weight") for k in want)


# ---------------------------------------------------------------- the CLI

def _assert_grads_match(got: dict, state):
    """The ranks' last-step gradients (``got``, whole) against those of
    one process's ``state``: rtol 1e-4, atol 1e-4 of each tensor's
    largest plus 1e-5 of the largest of all (the summation order's noise
    where a tensor's gradient cancels to almost nothing, as the time
    attention's v on these clips: 3e-6 against 60). A shard's missing
    share is a part of its tensor's own gradient."""
    want = {k: p.grad.numpy() for k, p in state.params.items()
            if p.grad is not None}
    assert want and got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-5 * top,
            err_msg=k)


def _one_process(tmp, model, *extra):
    """The same command at --mesh-model 1 in this process."""
    losses = []
    real = cli.make_clip_train_step

    def recorded(**kw):
        fn = real(**kw)

        def run(state, batch):
            state, m = fn(state, batch)
            losses.append(m["loss"].item())
            return state, m
        return run
    cli.make_clip_train_step = recorded
    try:
        state = cli.main(parse_config(cli.TorchPretrainConfig, _cli_argv(
            tmp, model, 1, *extra)))
    finally:
        cli.make_clip_train_step = real
    return state, losses


def test_pretrain_cli_mesh_model_shards_params(runs, tmp_path):
    """``--mesh-model 2`` on 2 ranks: qkv (and the text tower's bare
    in_proj) sharded, AdamW's moments the shards' shapes, the loss and
    the step's gradients those of one process; the checkpoint is the
    whole layout (its masters and moments the shapes of one process's),
    ``eval_zeroshot`` serves it in one process, and it resumes at
    ``--mesh-model 1``."""
    got = [out["cli:clip2"] for out in runs["two"]]
    assert all(g["model"] == [r, 2] and g["data"] == [0, 1]
               for r, g in enumerate(got))
    sharded = got[0]["sharded"]
    assert any(k.endswith("attn.qkv.weight") for k in sharded)
    assert any(k.endswith("in_proj_weight") for k in sharded)
    assert got[0]["moments"] == {k: v for k, v in sharded.items()
                                 if k in got[0]["moments"]}
    assert got[0]["moments"]
    ref, losses = _one_process(tmp_path / "one", MINI)
    for g in got:
        assert g["step"] == 1
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        _assert_grads_match(g["grads"], ref)

    run_dir = runs["base"] / "clip2"
    ckpt = torch.load(run_dir / "checkpoint_latest.pt", weights_only=True)
    whole = ref.state_dict()
    for k, v in whole["state_dict"].items():
        assert ckpt["state_dict"][k].shape == v.shape, k
    moments = {i: st["exp_avg"].shape for i, st in
               whole["optimizer"]["state"].items()}
    assert {i: st["exp_avg"].shape for i, st in
            ckpt["optimizer"]["state"].items()} == moments
    for k in sharded:
        assert ckpt["state_dict"][k].shape != tuple(sharded[k]), k

    args = ez.get_args_parser().parse_args(
        ["--checkpoint", str(run_dir / "checkpoint_latest.pt"),
         "--device", "cpu"])
    model, _, name = ez.load_model_from_checkpoint(args)
    assert name == MINI
    for k, p in model.named_parameters():
        assert torch.equal(p, ckpt["state_dict"][k]), k
    with torch.inference_mode():
        emb = model.encode_image(torch.randn(2, 4, 64, 64, 3))
    assert emb.shape == (2, 256) and torch.isfinite(emb).all()

    resumed = cli.main(parse_config(cli.TorchPretrainConfig, _cli_argv(
        run_dir, MINI, 1)))
    assert resumed.step == 2
    assert not any(hasattr(p, "tp_split") for p in resumed.params.values())


def test_pretrain_cli_mesh_model_4(runs, tmp_path):
    """``--mesh-model 4`` on 4 ranks (a model axis of the world): every
    rank holds a quarter of each wide layer; the loss and the step's
    gradients those of one process."""
    got = [out["cli:clip4"] for out in runs["four"]]
    ref, losses = _one_process(tmp_path / "one", MINI)
    for r, g in enumerate(got):
        assert g["model"] == [r, 4] and g["data"] == [0, 1]
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        _assert_grads_match(g["grads"], ref)
    sharded = got[0]["sharded"]
    assert sharded["visual.blocks.0.attn.qkv.weight"] == [48, 64]
    assert sharded["visual.blocks.0.mlp.fc2.weight"] == [64, 64]


def test_vclm_caption_step_under_tensor_parallelism(runs, tmp_path,
                                                    vocab_dir, monkeypatch):
    """The narrator's caption step at ``--mesh-model 2`` under LaViLa's
    freeze flags: GPT-2's and the pooler's wide layers sharded (the
    pooler's ``to_kv`` gathered), the frozen shards left out of the
    optimizer, the step's gradients of the trainable parameters (the
    pooler's among them) those of one process, the checkpoint the whole
    layout and equal to one process's run in its frozen tensors."""
    got = [out["cli:vclm2"] for out in runs["two"]]
    sharded = got[0]["sharded"]
    assert "img_attn_pool.to_kv.weight" in sharded
    assert "text_decoder.transformer.h.0.attn.c_attn.weight" in sharded
    assert got[0]["frozen_sharded"]  # GPT-2's own layers under the recipe
    assert got[0]["step"] == 1
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", vocab_dir)
    ref, _ = _one_process(tmp_path / "one", VCLM, *RECIPE)
    for g in got:
        assert "img_attn_pool.to_kv.weight" in g["grads"]
        _assert_grads_match(g["grads"], ref)
    ckpt = torch.load(runs["base"] / "vclm2" / "checkpoint_latest.pt",
                      weights_only=True)
    for k, v in ref.state_dict()["state_dict"].items():
        assert ckpt["state_dict"][k].shape == v.shape, k
        if k in ref.frozen:
            assert torch.equal(ckpt["state_dict"][k], v), k
        else:
            np.testing.assert_allclose(ckpt["state_dict"][k], v,
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_vclm_ungated_caption_step_gradients_under_tensor_parallelism(
        runs, tmp_path, vocab_dir, monkeypatch):
    """The freeze flags without ``--gated-xattn``: the cross-attention is
    not gated at zero, so the first step's gradient reaches the pooler;
    at ``--mesh-model 2`` every trainable gradient (the pooler's
    gathered ``to_kv``, summed over the ranks' heads, among them) is one
    process's."""
    got = [out["cli:vclm2_ungated"] for out in runs["two"]]
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", vocab_dir)
    ref, losses = _one_process(tmp_path / "one", VCLM, *RECIPE[1:])
    grads = {k: p.grad for k, p in ref.params.items() if p.grad is not None}
    for name in ("img_attn_pool.to_kv.weight", "img_attn_pool.to_q.weight"):
        assert grads[name].abs().max() > 1e-3 * max(
            g.abs().max() for g in grads.values()), name
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        _assert_grads_match(g["grads"], ref)


# ------------------------------------------------------- single process

def test_even_sizes_split_heads_as_evenly_as_they_go():
    assert even_sizes(25, 2, 64) == (832, 768)   # GPT-2 XL, 13/12 heads
    assert even_sizes(25, 4, 64) == (448, 384, 384, 384)
    assert even_sizes(20, 2, 64) == (640, 640)   # GPT-2 large
    assert even_sizes(128, 4) == (32, 32, 32, 32)


@pytest.mark.parametrize("parts,sizes", [(3, (3, 2)), (2, (1, 1, 1)),
                                         (1, (7, 6, 6, 6))])
def test_split_take_and_join_are_inverse(parts, sizes):
    """Per-part slices: a rank's slice of q|k|v holds its own rows of
    each part, and joining every rank's slice gives the whole back."""
    whole = torch.arange(parts * sum(sizes) * 3.0).reshape(
        parts * sum(sizes), 3)
    split = Split(0, parts, sizes)
    pieces = [sharding.shard_state_dict({"w": whole}, {"w": split}, r)["w"]
              for r in range(len(sizes))]
    assert all(torch.equal(p, split.take(whole, r))
               for r, p in enumerate(pieces))
    assert [p.shape[0] for p in pieces] == [parts * s for s in sizes]
    lo, hi = split.bounds(1)
    first = whole.chunk(parts)[0][lo:hi]
    assert torch.equal(pieces[1][:hi - lo], first)
    assert torch.equal(split.join(pieces), whole)
    col = Split(1, parts, sizes)
    assert torch.equal(col.join([col.take(whole.T, r)
                                 for r in range(len(sizes))]), whole.T)


@pytest.mark.parametrize("model,ok", [(1, True), (2, False), (3, False)])
def test_check_mesh_model_against_the_world(model, ok):
    """Outside a group the world is 1: only --mesh-model 1 divides it;
    the others raise as ``create_mesh`` does."""
    if ok:
        assert mesh.check_mesh_model(model) == 1
        mesh.init_model_parallel(model)
        assert (mesh.model_world(), mesh.model_rank(), mesh.data_world(),
                mesh.data_rank()) == (1, 0, 1, 0)
        assert mesh.model_group() is None and mesh.world_group() is None
    else:
        with pytest.raises(ValueError, match=f"--mesh-model {model}: the 1 "):
            mesh.check_mesh_model(model)


def test_shard_model_without_a_group_is_a_no_op():
    model = build_model(MINI, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert sharding.shard_model(model) is model
    assert not sharding.layout(dict(model.named_parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
