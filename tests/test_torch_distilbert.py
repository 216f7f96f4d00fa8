"""The port's DistilBERT dual encoders against ``lavila_tpu`` on the same
weights and numpy inputs, fp32, at a small size (DistilBERT 2 layers 64
wide with 4 heads, a vocabulary of 100, 16 tokens; the MINI video tower):
the text tower under ragged masks, ``VideoCLIPHF`` under both
projections, the CLIP_HF tower (no ``ln_pre``, erf GELU, patch-embed
bias), a reference-layout checkpoint through both importers, two
pretraining steps and one retrieval step with masks, the weight-decay and
freeze masks through the bridge's key map, and the full-width zoo
entries' parameter trees. Forward outputs within 1e-5 of their largest
magnitude; train steps: loss within 1e-5 relative, every parameter
within 1e-4 of its tensor's largest value (the key biases, whose exact
gradient is zero, within Adam's bound 2·Σ lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.distilbert import DistilBertModel as JaxBert
from lavila_tpu.models.dual_encoder import VideoCLIPHF as JaxVideoCLIPHF
from lavila_tpu.models.import_torch import import_video_clip_hf
from lavila_tpu.models.timesformer import SpaceTimeTransformer as JaxTSF
from lavila_tpu.train import freeze as JF
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_clip_train_step as jax_clip_step
from lavila_tpu.train.step import make_retrieval_train_step as jax_retr_step
from lavila_tpu_torch.models import zoo
from lavila_tpu_torch.models.convert import (load_reference_checkpoint,
                                             state_dict_from_jax, torch_key)
from lavila_tpu_torch.models.distilbert import DistilBertModel
from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
from lavila_tpu_torch.ops.attention import padding_bias
from lavila_tpu_torch.train import freeze as F
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import (TrainState, make_clip_train_step,
                                         make_retrieval_train_step)

torch.set_num_threads(1)

BERT = dict(vocab_size=100, dim=64, num_heads=4, hidden_dim=256, n_layers=2,
            max_position_embeddings=32)
L = 16
CLS, PAD = 2, 0
# caption lengths, [CLS] included: a row of [CLS] alone, ragged ones, a
# full one
LENGTHS = (1, 5, 16, 9)
SCHEDULE = dict(base_lr=1e-3, final_lr=1e-4, epochs=2, steps_per_epoch=2,
                warmup_epochs=1, start_warmup_lr=1e-4)
OPTIM = dict(weight_decay=0.1, clip_grad_value=5.0, clip_grad_type="norm")


def _tower_kw(hf: bool) -> dict:
    """The MINI video tower; ``hf``: the CLIP_HF variant."""
    return dict(img_size=64, patch_size=16, embed_dim=64, depth=2,
                num_heads=4, num_frames=4, ln_pre=not hf,
                act="gelu" if hf else "quick_gelu")


def _jax_model(projection="default", hf=False):
    return JaxVideoCLIPHF(vision_model=JaxTSF(**_tower_kw(hf)),
                          text_model=JaxBert(**BERT), vision_width=64,
                          text_width=64, embed_dim=32, projection=projection)


def _port_model(projection="default", hf=False):
    return VideoCLIPHF(SpaceTimeTransformer(**_tower_kw(hf)),
                       DistilBertModel(**BERT), 32, projection)


def _inputs(seed, lengths=LENGTHS):
    """Frames, token ids ([CLS] first, [PAD] past each length) and their
    {0, 1} mask."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    frames = rng.normal(size=(B, 4, 64, 64, 3)).astype(np.float32)
    text = rng.integers(5, BERT["vocab_size"], size=(B, L)).astype(np.int32)
    text[:, 0] = CLS
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    text[mask == 0] = PAD
    return frames, text, mask


def _noise(tree, rng, scale=0.1):
    for k, v in tree.items():
        tree[k] = (rng.normal(size=v.shape) * scale).astype(np.float32)


def _params(jm, seed):
    """Init the JAX model; give its time attention (zero at init), its
    LayerNorms (ones and zeros) and the patch-embed bias (zero) seeded
    noise, so none of them is vacuous."""
    frames, text, mask = _inputs(seed)
    params = jm.init(jax.random.key(seed), jnp.asarray(frames),
                     jnp.asarray(text), jnp.asarray(mask))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                _noise(lin, rng)
    pe = params["vision_model"]["patch_embed"]
    if "bias" in pe:
        pe["bias"] = (rng.normal(size=pe["bias"].shape) * 0.1).astype(
            np.float32)
    tm = params["text_model"]
    norms = [tm["emb_layer_norm"]] + [
        blk[n] for k, blk in tm.items() if k.startswith("layer_")
        for n in ("sa_layer_norm", "output_layer_norm")]
    for ln in norms:
        ln["scale"] = (1 + 0.1 * rng.normal(size=ln["scale"].shape)).astype(
            np.float32)
        ln["bias"] = (0.1 * rng.normal(size=ln["bias"].shape)).astype(
            np.float32)
    return params


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _port(params, projection="default", hf=False):
    pm = _port_model(projection, hf)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return pm.eval()


def _t(x):
    x = torch.from_numpy(np.asarray(x))
    return x.long() if x.dtype == torch.int32 else x


def test_padding_bias():
    bias = padding_bias(torch.tensor([[1.0, 1.0, 0.0]]))
    assert bias.shape == (1, 1, 1, 3) and bias.dtype == torch.float32
    assert bias[0, 0, 0].tolist() == [0.0, 0.0,
                                      torch.finfo(torch.float32).min]


def test_distilbert_matches_jax_under_ragged_masks():
    """The last hidden state of every position, [CLS]-only row
    included, with and without the mask."""
    jm = JaxBert(**BERT)
    _, text, mask = _inputs(0)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(1), jnp.asarray(text), jnp.asarray(mask))["params"])
    pm = DistilBertModel(**BERT)
    sd = state_dict_from_jax({"text_model": params})
    pm.load_state_dict({k.removeprefix("textual."): v for k, v in sd.items()},
                       strict=True)
    for m in (mask, None):
        want = jm.apply({"params": params}, jnp.asarray(text),
                        None if m is None else jnp.asarray(m))
        with torch.inference_mode():
            got = pm(_t(text), None if m is None else _t(m))
        _close(got.numpy(), want)


@pytest.mark.parametrize("projection,hf", [
    ("default", False), ("frozen_in_time", False), ("default", True),
    ("frozen_in_time", True)])
def test_video_clip_hf_matches_jax(projection, hf):
    """encode_image, masked encode_text and forward (normalised
    embeddings) for both projections, on the CLIP-initialised tower and
    on the CLIP_HF one (no ln_pre, erf GELU, patch-embed bias)."""
    jm = _jax_model(projection, hf)
    params = _params(jm, seed=2)
    pm = _port(params, projection, hf)
    frames, text, mask = _inputs(3)
    v = {"params": params}
    f, t, m = jnp.asarray(frames), jnp.asarray(text), jnp.asarray(mask)
    with torch.inference_mode():
        got_i = pm.encode_image(_t(frames))
        got_t = pm.encode_text(_t(text), _t(mask))
        got = pm(_t(frames), _t(text), _t(mask), norm_embed=True)
    _close(got_i.numpy(), jm.apply(v, f, method="encode_image"))
    _close(got_t.numpy(), jm.apply(v, t, m, method="encode_text"))
    want = jm.apply(v, f, t, m, norm_embed=True)
    for k in ("image_embed", "text_embed", "logit_scale"):
        _close(got[k].numpy(), want[k])
    assert (pm.visual.ln_pre is None) == hf
    assert (pm.visual.patch_embed.proj.bias is not None) == hf


def test_padded_ids_do_not_move_the_text_embedding():
    """Ids past each caption's mask are never attended to: changing
    them leaves the masked embedding as it was (and moves the unmasked
    one)."""
    pm = _port(_params(_jax_model(), seed=4))
    _, text, mask = _inputs(5)
    other = text.copy()
    other[mask == 0] = 7
    with torch.inference_mode():
        a = pm.encode_text(_t(text), _t(mask))
        b = pm.encode_text(_t(other), _t(mask))
        c = pm.encode_text(_t(other))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert not torch.allclose(a, c, atol=1e-3)


def _reference_state_dict(params, projection):
    """A CLIP_HF checkpoint in the reference layout: the port's keys
    under DDP's ``module.``, HF's ``position_ids`` buffer beside them."""
    sd = state_dict_from_jax(params)
    if projection == "frozen_in_time":
        assert "image_projection.0.weight" in sd
        assert "text_projection.1.bias" in sd
    sd["textual.embeddings.position_ids"] = torch.arange(
        BERT["max_position_embeddings"])[None]
    return {f"module.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("projection", ["default", "frozen_in_time"])
def test_reference_checkpoint_loads_as_in_jax(projection, tmp_path):
    """One synthetic CLIP_HF checkpoint through the port's
    ``load_reference_checkpoint`` (strict) and through JAX's
    ``import_video_clip_hf`` (strict) gives the same embeddings."""
    params = _params(_jax_model(projection, hf=True), seed=6)
    ref = _reference_state_dict(params, projection)
    path = tmp_path / "clip_hf.pth"
    torch.save({"state_dict": ref, "epoch": 3}, path)
    pm = _port_model(projection, hf=True)
    pm.load_state_dict(load_reference_checkpoint(str(path), num_frames=4),
                       strict=True)
    pm.eval()
    jparams = import_video_clip_hf(
        {k.removeprefix("module."): v.numpy() for k, v in ref.items()},
        depth=2, num_frames=4, projection=projection, strict=True)
    jm = _jax_model(projection, hf=True)
    frames, text, mask = _inputs(7)
    want = jm.apply({"params": jparams}, jnp.asarray(frames),
                    jnp.asarray(text), jnp.asarray(mask))
    with torch.inference_mode():
        got = pm(_t(frames), _t(text), _t(mask))
    for k in ("image_embed", "text_embed"):
        _close(got[k].numpy(), want[k])


def _batches(n, seed, B=4, relevancy=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lengths = rng.integers(1, L + 1, size=B)
        frames, text, mask = _inputs(seed + i, tuple(lengths))
        b = {"frames": frames, "text": text, "mask": mask}
        if relevancy:
            b["relevancy"] = rng.random(B).astype(np.float32)
        out.append(b)
    return out


def _port_state(params, frozen=lambda n: False):
    model = _port_model()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return TrainState.create(model.train(), lambda p: O.make_optimizer(
        F.freeze_by_predicate(p, frozen), O.cosine_schedule(**SCHEDULE),
        **OPTIM), dtype=torch.float32)


def _key_bias(name: str, shape) -> slice | None:
    """The key biases' elements: softmax is invariant to a shift of all
    of a query's scores, so their exact gradient is zero and Adam, which
    divides by √v, moves them by fp32 rounding noise, up to lr a step in
    either framework (ROADMAP queue 3)."""
    if name.endswith("k_lin.bias"):
        return slice(None)
    if name.endswith("attn.qkv.bias"):
        d = shape[0] // 3
        return slice(d, 2 * d)
    return None


def _check_params(state, jstate, steps):
    """Every parameter within 1e-4 of its tensor's largest value, the key
    biases within the Adam bound 2·Σ lr."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    adam_bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t)
                         for t in range(steps))
    for name, p in state.params.items():
        got, ref = p.detach().numpy().copy(), want[name].numpy().copy()
        keys = _key_bias(name, ref.shape)
        if keys is not None:
            assert np.abs(got[keys] - ref[keys]).max() <= adam_bound, name
            got[keys] = ref[keys] = 0.0
        if np.abs(ref).max() > 0:
            _close(got, ref, rel=1e-4)


def test_two_pretraining_steps_with_masks_match_jax():
    """``make_clip_train_step`` with each batch's mask (drop-path 0):
    both steps' losses within 1e-5 relative, the parameters after them
    within 1e-4 of each tensor's largest value."""
    jm = _jax_model()
    params = _params(jm, seed=8)
    tx = JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_clip_step(jm))
    state = _port_state(params)
    step = make_clip_train_step()
    for b in _batches(2, seed=9):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: _t(v) for k, v in b.items()})
        assert met["loss"].item() == pytest.approx(float(jmet["loss"]),
                                                   rel=1e-5)
    assert state.step == int(jstate.step) == 2
    _check_params(state, jstate, 2)


def test_retrieval_step_with_masks_matches_jax():
    """One adaptive max-margin step with relevancy weights and masks,
    logit_scale frozen, held as the pretraining steps."""
    jm = _jax_model()
    params = _params(jm, seed=10)
    tx = JF.freeze_by_predicate(
        JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM),
        JF.logit_scale_only)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_retr_step(jm, loss_type="adaptive_max_margin",
                                  margin=0.4, norm_embed=True))
    state = _port_state(params, F.logit_scale_only)
    step = make_retrieval_train_step("adaptive_max_margin", margin=0.4,
                                     norm_embed=True)
    (b,) = _batches(1, seed=11, relevancy=True)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, met = step(state, {k: _t(v) for k, v in b.items()})
    assert met["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-5)
    _check_params(state, jstate, 1)
    assert state.params["logit_scale"].item() == pytest.approx(
        float(jstate.params["logit_scale"]))


def test_train_step_takes_the_mask():
    """The step's loss does not move when the ids past the mask do."""
    params = _params(_jax_model(), seed=12)
    (b,) = _batches(1, seed=13)
    other = dict(b, text=np.where(b["mask"] > 0, b["text"], 9))
    losses = []
    for batch in (b, other):
        state = _port_state(params)
        _, met = make_clip_train_step()(state, {k: _t(v)
                                                for k, v in batch.items()})
        losses.append(met["loss"].item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def _jax_paths(params):
    return [(path, "/".join(str(k.key) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]


@pytest.mark.parametrize("projection", ["default", "frozen_in_time"])
def test_weight_decay_and_freeze_masks_match_jax(projection):
    """JAX's weight-decay mask (flax paths) and the port's (HF names),
    parameter by parameter through ``torch_key``; the freeze predicates
    likewise."""
    params = _params(_jax_model(projection), seed=14)
    jmask = jax.tree_util.tree_flatten_with_path(JO.wd_mask(params))[0]
    want = {torch_key(tuple(k.key for k in path))[0]: bool(v)
            for path, v in jmask}
    pm = _port_model(projection)
    got = O.wd_mask(pm.named_parameters())
    assert got == want
    assert any(got[k] for k in got if k.startswith("textual."))
    assert not got["textual.embeddings.LayerNorm.weight"]
    flags = [dict(freeze_temperature=True, timesformer_freeze_space=True),
             dict(freeze_visual_vclm_temporal=True)]
    for f in flags:
        jp, tp = (JF.build_freeze_predicate(**f),
                  F.build_freeze_predicate(**f))
        names = [(p, torch_key(tuple(k.key for k in path))[0])
                 for path, p, _ in _jax_paths(params)]
        assert {n for p, n in names if jp(p)} == \
            {n for _, n in names if tp(n)}
        assert not any(tp(n) for _, n in names if n.startswith("textual."))


DISTILBERT_ENTRIES = [
    ("CLIP_OPENAI_TIMESFORMER_BASE_DISTILBERT_BASE", 224),
    ("CLIP_OPENAI_TIMESFORMER_LARGE_DISTILBERT_BASE", 224),
    ("CLIP_OPENAI_TIMESFORMER_LARGE_336PX_DISTILBERT_BASE", 336),
    ("CLIP_HF_TIMESFORMER_DISTILBERT_BASE", 224),
    ("CLIP_HF_EGOVLP_DISTILBERT_BASE", 224),
]


@pytest.mark.parametrize("name,img", DISTILBERT_ENTRIES)
def test_zoo_distilbert_entries_have_the_jax_parameters(name, img):
    """Each full-width entry, built on the meta device (no init), has its
    JAX twin's parameters, key by key through ``torch_key`` and shape by
    shape, as ``jax.eval_shape`` gives them."""
    jm = jax_build_model(name, num_frames=4)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 4, img, img, 3)),
        jnp.zeros((1, 77), jnp.int32), jnp.ones((1, 77))))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, layout = torch_key(tuple(k.key for k in path))
        shape = leaf.shape
        if layout == "dense":
            shape = shape[::-1]
        elif layout == "conv":  # (kh, kw, I, O) → (O, I, kh, kw)
            shape = (shape[3], shape[2], *shape[:2])
        want[key] = tuple(shape)
    with torch.device("meta"):
        pm = zoo._REGISTRY[name]()
    got = {k: tuple(v.shape) for k, v in pm.named_parameters()}
    assert got == want
    assert isinstance(pm, VideoCLIPHF)
    assert pm.projection == ("frozen_in_time" if "EGOVLP" in name
                             else "default")
