"""The port's CLIP ViT towers against ``lavila_tpu`` on the same weights
and seeded numpy inputs, on the CPU.

  * ``VisionTransformer`` at two small geometries (32², patch 8: 16
    patches and the CLS token; 2 blocks 64 wide with 4 heads of 16, and
    128 wide with 2 heads of 64): the projected and the un-projected CLS
    feature and the patch tokens (``cls_at_last=False``), fp32 (atol
    1e-4) and bf16 (within 2e-2 of each output's largest magnitude: the
    towers round every product to bf16, and K7's plain version rounds
    exp(s − m) where the JAX attention rounds the normalised
    probabilities); the JAX side once on the Pallas backend, its
    LayerNorms through the Pallas K3 in interpret mode.
  * ``FrameMeanViT`` on an image and on a clip, ``FrameTokensViT`` on a
    clip, against the JAX wrappers (fp32, atol 1e-4).
  * The ViT dual encoder (no image projection): embeddings (fp32, atol
    1e-4) and two AdamW steps against ``lavila_tpu``'s step (losses
    within 1e-5 relative, the parameters as ``test_torch_train_step``
    bounds them).
  * A ViT narrator (the tower's patch tokens into a 2-layer gated GPT-2):
    teacher-forced logits (atol 1e-4) and greedy ids token for token.
  * ``state_dict_from_jax`` carries both JAX trees (``vision_model/vit``)
    strict; the eight zoo names build on the meta device with the JAX
    package's parameters, name for name and shape for shape.
  * The OpenAI-layout bridge: one synthetic OpenAI state dict through
    JAX ``import_clip_vit``/``import_clip_text`` and through the port's
    strict load of a ``.pt`` (a pickled state dict and a TorchScript
    archive) gives the same embeddings (atol 1e-5); the three metadata
    entries are dropped; a missing or an extra key raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models import import_torch as imp
from lavila_tpu.models.dual_encoder import VideoCLIP as JaxVideoCLIP
from lavila_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from lavila_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from lavila_tpu.models.gpt2 import augment_config as jax_augment
from lavila_tpu.models.narrator import VCLM as JaxVCLM
from lavila_tpu.models.openai_clip import TextTransformer as JaxText
from lavila_tpu.models.openai_clip import VisionTransformer as JaxViT
from lavila_tpu.models.zoo import _FrameTokensViT as JaxFrameTokens
from lavila_tpu.ops import attention as JA
from lavila_tpu.train import optim as JO
from lavila_tpu.train.step import TrainState as JaxTrainState
from lavila_tpu.train.step import make_clip_train_step as jax_train_step
from lavila_tpu_torch.models import zoo
from lavila_tpu_torch.models.convert import (OPENAI_METADATA,
                                             load_reference_checkpoint,
                                             state_dict_from_jax, torch_key)
from lavila_tpu_torch.models.dual_encoder import VideoCLIP
from lavila_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    augment_config
from lavila_tpu_torch.models.narrator import VCLM
from lavila_tpu_torch.models.openai_clip import (FrameMeanViT,
                                                FrameTokensViT,
                                                TextTransformer,
                                                VisionTransformer)
from lavila_tpu_torch.train import optim as O
from lavila_tpu_torch.train.step import TrainState, make_clip_train_step

torch.set_num_threads(1)

IMG, PATCH = 32, 8
# (width, heads): 4 heads of 16, and 2 heads of 64 (the kernels' width)
GEOMS = {"w64h4": (64, 4), "w128h2": (128, 2)}
TEXT = dict(width=32, heads=2, layers=1)


def _geom(width=64, heads=4, output_dim=16):
    return dict(input_resolution=IMG, patch_size=PATCH, width=width,
                layers=2, heads=heads, output_dim=output_dim)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _spread_norms(params, rng):
    """Every LayerNorm's scale and bias away from ones and zeros, so that
    they count."""
    for k, v in params.items():
        if isinstance(v, dict):
            if set(v) == {"scale", "bias"}:
                v["scale"] = (1 + 0.2 * rng.normal(size=v["scale"].shape)
                              ).astype(np.float32)
                v["bias"] = (0.2 * rng.normal(size=v["bias"].shape)
                             ).astype(np.float32)
            else:
                _spread_norms(v, rng)
    return params


def _vit_pair(geom, seed=0):
    """A JAX ViT's params (norms spread) and the port's ViT on them."""
    jm = JaxViT(**_geom(*GEOMS[geom]))
    params = _np(jm.init(jax.random.key(seed),
                         jnp.zeros((1, IMG, IMG, 3)))["params"])
    params = _spread_norms(params, np.random.default_rng(seed))
    pm = VisionTransformer(**_geom(*GEOMS[geom]))
    sd = state_dict_from_jax({"vision_model": {"vit": params}})
    pm.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()},
                       strict=True)
    return jm, params, pm.eval()


def _images(B, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, IMG, IMG, 3)).astype(np.float32)


def _bf16_values(params):
    """The params rounded to bf16 (kept fp32), so that a bf16 port model
    holds exactly the values the JAX bf16 tower computes with."""
    return jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)


@pytest.fixture()
def pallas_backend():
    old = JA.get_attention_backend()
    JA.set_attention_backend("pallas")
    yield
    JA.set_attention_backend(old)


VARIANTS = [dict(apply_project=True), dict(apply_project=False),
            dict(cls_at_last=False)]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["proj", "noproj", "tokens"])
def test_vision_transformer_matches_jax_fp32(geom, kw):
    jm, params, pm = _vit_pair(geom)
    x = _images(3)
    want = jm.apply({"params": params}, jnp.asarray(x), **kw)
    with torch.inference_mode():
        got = pm(_t(x), **kw)
    width = GEOMS[geom][0]
    shape = ((3, 16) if kw.get("apply_project", True) else (3, width)) \
        if kw.get("cls_at_last", True) else (3, (IMG // PATCH) ** 2, width)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("kw", VARIANTS, ids=["proj", "noproj", "tokens"])
def test_vision_transformer_pallas_backend_matches_jax(kw, pallas_backend):
    """The JAX tower with its LayerNorms on the Pallas K3 (interpret
    mode) against the port's plain versions, 2 heads of 64."""
    test_vision_transformer_matches_jax_fp32("w128h2", kw)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["proj", "noproj", "tokens"])
def test_vision_transformer_matches_jax_bf16(geom, kw):
    width, heads = GEOMS[geom]
    _, params, _ = _vit_pair(geom)
    params = _bf16_values(params)
    jm = JaxViT(**_geom(width, heads), dtype=jnp.bfloat16)
    pm = VisionTransformer(**_geom(width, heads))
    sd = state_dict_from_jax({"vision_model": {"vit": params}})
    pm.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()},
                       strict=True)
    pm = pm.to(torch.bfloat16).eval()
    x = _images(3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), **kw),
                      np.float32)
    with torch.inference_mode():
        got = pm(_t(x), **kw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.fixture(scope="module")
def frame_mean():
    """The JAX zoo's ``FrameMeanViT`` (defined inside ``_clip_vit``) over
    a small ViT, and the port's on the same weights."""
    wrapper = type(jax_build_model("CLIP_OPENAI_VITB16").vision_model)
    jm = wrapper(vit=JaxViT(**_geom()))
    params = _np(jm.init(jax.random.key(2),
                         jnp.zeros((1, 2, IMG, IMG, 3)))["params"])
    params = _spread_norms(params, np.random.default_rng(2))
    pm = FrameMeanViT(**_geom())
    sd = state_dict_from_jax({"vision_model": params})
    pm.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()},
                       strict=True)
    return jm, params, pm.eval()


@pytest.mark.parametrize("shape", [(3, IMG, IMG, 3), (2, 3, IMG, IMG, 3)],
                         ids=["image", "clip"])
def test_frame_mean_vit_matches_jax(frame_mean, shape):
    jm, params, pm = frame_mean
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(_t(x), generator=torch.Generator())
    assert got.shape == (shape[0], 16) and pm.embed_dim == 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_frame_tokens_vit_matches_jax():
    jm = JaxFrameTokens(vit=JaxViT(**_geom()))
    x = np.random.default_rng(4).normal(
        size=(2, 3, IMG, IMG, 3)).astype(np.float32)
    params = _np(jm.init(jax.random.key(4), jnp.asarray(x))["params"])
    params = _spread_norms(params, np.random.default_rng(4))
    pm = FrameTokensViT(**_geom())
    sd = state_dict_from_jax({"vision_model": params})
    pm.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()},
                       strict=True)
    want = jm.apply({"params": params}, jnp.asarray(x), cls_at_last=False)
    with torch.inference_mode():
        got = pm(_t(x), cls_at_last=False)
    assert got.shape == (2, 3 * 16, 64) and pm.embed_dim == 64
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


# ------------------------------------------------------- dual encoder

def _dual_pair(seed=5):
    """The JAX ViT dual encoder (the zoo's wrapper, no image projection)
    and the port's at small size, on one JAX init."""
    wrapper = type(jax_build_model("CLIP_OPENAI_VITB16").vision_model)
    jm = JaxVideoCLIP(vision_model=wrapper(vit=JaxViT(**_geom())),
                      text_model=JaxText(**TEXT, embed_dim=16),
                      vision_width=16, embed_dim=16,
                      use_image_projection=False)
    params = _np(jm.init(jax.random.key(seed),
                         jnp.zeros((1, 2, IMG, IMG, 3)),
                         jnp.zeros((1, 77), jnp.int32))["params"])
    params = _spread_norms(params, np.random.default_rng(seed))
    assert "image_projection" not in params
    pm = VideoCLIP(FrameMeanViT(**_geom()),
                   TextTransformer(**TEXT, embed_dim=16), 16,
                   use_image_projection=False)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, pm


def _clip_batches(n, B=4, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.normal(size=(B, 2, IMG, IMG, 3)).astype(np.float32)
        text = rng.integers(1, 49407, size=(B, 77)).astype(np.int32)
        text[np.arange(B), rng.integers(5, 77, size=B)] = 49407  # EOT
        out.append((frames, text))
    return out


def test_vit_dual_encoder_embeddings_match_jax():
    jm, params, pm = _dual_pair()
    assert pm.image_projection is None
    frames, text = _clip_batches(1)[0]
    v = {"params": params}
    want = jm.apply(v, jnp.asarray(frames), jnp.asarray(text),
                    norm_embed=True)
    with torch.inference_mode():
        got = pm.eval()(_t(frames), torch.from_numpy(text).long(),
                        norm_embed=True)
    for k in ("image_embed", "text_embed", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


SCHEDULE = dict(base_lr=1e-3, final_lr=1e-4, epochs=2, steps_per_epoch=2,
                warmup_epochs=1, start_warmup_lr=1e-4)
OPTIM = dict(weight_decay=0.1, clip_grad_value=5.0, clip_grad_type="norm")


def test_vit_dual_encoder_two_adamw_steps_match_jax():
    """Per-step loss within 1e-5 relative; every parameter within Adam's
    2·Σ lr of JAX's and all but a thousandth within 1e-5, as
    ``test_torch_train_step`` holds the TimeSformer's."""
    jm, params, pm = _dual_pair()
    tx = JO.make_optimizer(JO.cosine_schedule(**SCHEDULE), **OPTIM)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_train_step(jm))
    state = TrainState.create(pm.train(), lambda p: O.make_optimizer(
        p, O.cosine_schedule(**SCHEDULE), **OPTIM), dtype=torch.float32)
    step = make_clip_train_step()
    for frames, text in _clip_batches(2):
        jstate, jm_ = jstep(jstate, {"frames": jnp.asarray(frames),
                                     "text": jnp.asarray(text)})
        state, m = step(state, {"frames": _t(frames),
                                "text": torch.from_numpy(text).long()})
        assert m["loss"].item() == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-5)
    want = state_dict_from_jax(_np(jstate.params))
    bound = 2 * sum(O.cosine_schedule(**SCHEDULE)(t) for t in range(2))
    far = total = 0
    for name, p in state.params.items():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= bound, name
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    assert far <= total // 1000, (far, total)
    # the ViT's own parameters trained: conv1, class and positional
    # embeddings, proj
    for name in ("visual.conv1.weight", "visual.class_embedding",
                 "visual.positional_embedding", "visual.proj"):
        assert not torch.equal(state.params[name],
                               state_dict_from_jax(params)[name]), name


# ------------------------------------------------------------ narrator

GPT2 = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def narrator():
    """A JAX ViT narrator (the zoo's ``_FrameTokensViT``, a 2-layer gated
    GPT-2 with cross-attention on every layer, 8 queries of 2 heads x 16)
    with seeded non-zero gates, and the port's on the same weights."""
    jcfg = jax_augment(JaxGPT2Config(**GPT2), cross_attn_freq=1,
                       gated_xattn=True)
    jm = JaxVCLM(vision_model=JaxFrameTokens(vit=JaxViT(**_geom())),
                 text_decoder=JaxGPT2(jcfg), vision_width=64, text_width=32,
                 num_img_queries=8, dim_head=16, heads=2)
    params = _np(jm.init(jax.random.key(7), jnp.zeros((1, 2, IMG, IMG, 3)),
                         jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(7)
    params = _spread_norms(params, rng)
    for blk in params["text_decoder"].values():
        if isinstance(blk, dict) and "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    cfg = augment_config(GPT2Config(**GPT2), cross_attn_freq=1,
                         gated_xattn=True)
    pm = VCLM(FrameTokensViT(**_geom()), GPT2LMHead(cfg), vision_width=64,
              text_width=32, num_img_queries=8, dim_head=16, heads=2)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    frames = rng.normal(size=(2, 2, IMG, IMG, 3)).astype(np.float32)
    return jm, params, pm.eval(), frames


def test_vit_narrator_teacher_forced_logits_match_jax(narrator):
    jm, params, pm, frames = narrator
    text = np.random.default_rng(8).integers(1, 64, (2, 7)).astype(np.int32)
    v = {"params": params}
    want_tok = jm.apply(v, jnp.asarray(frames), method="encode_image")
    want = jm.apply(v, jnp.asarray(frames), jnp.asarray(text))
    with torch.no_grad():
        tok = pm.encode_image(_t(frames))
        got = pm(_t(frames), torch.from_numpy(text).long())
    assert tok.shape == (2, 8, 32)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)


def test_vit_narrator_greedy_ids_match_jax(narrator):
    """top_k = 1: the same ids token for token, the entropy perplexity
    within 1e-4 relative."""
    jm, params, pm, frames = narrator
    v = {"params": params}
    kw = dict(bos_id=0, eos_id=-1, pad_id=0, max_text_length=10, top_k=1,
              num_return_sequences=2)
    toks = jm.apply(v, jnp.asarray(frames), method="encode_image")
    jids, jppl = jm.apply(v, toks, rng=jax.random.key(3), method="generate",
                          **kw)
    with torch.no_grad():
        pids, pppl = pm.generate(pm.encode_image(_t(frames)),
                                 generator=torch.Generator(), **kw)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(pppl.numpy(), np.asarray(jppl), rtol=1e-4)


# ----------------------------------------------------------------- zoo

VIT_DUALS = {"CLIP_OPENAI_VITB32": (224, 32, 12, 768),
             "CLIP_OPENAI_VITB16": (224, 16, 12, 768),
             "CLIP_OPENAI_VITL14": (224, 14, 24, 1024),
             "CLIP_OPENAI_VITL14_336PX": (336, 14, 24, 1024)}
VIT_NARRATORS = {"VCLM_OPENAI_VITB16_GPT2_LARGE": (224, 16, 12, 768),
                 "VCLM_OPENAI_VITB16_GPT2_XL": (224, 16, 12, 768),
                 "VCLM_OPENAI_VITL14_GPT2_XL": (224, 14, 24, 1024),
                 "VCLM_OPENAI_VITL14_336PX_GPT2_XL": (336, 14, 24, 1024)}


def _jax_shapes(name, img):
    """The JAX model's parameters in the port's names and layouts,
    abstractly (``jax.eval_shape``: nothing is allocated)."""
    narrator = name.startswith("VCLM")
    jm = jax_build_model(name, **({"gated_xattn": True} if narrator
                                  else {}))
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 2, img, img, 3)),
        jnp.zeros((1, 8 if narrator else 77), jnp.int32)))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, layout = torch_key(tuple(k.key for k in path))
        shape = leaf.shape
        if layout == "dense":
            shape = shape[::-1]
        elif layout == "conv":  # (kh, kw, I, O) → (O, I, kh, kw)
            shape = (shape[3], shape[2], *shape[:2])
        want[key] = tuple(shape)
    return want


@pytest.mark.parametrize("name", [*VIT_DUALS, *VIT_NARRATORS])
def test_zoo_vit_entries_have_the_jax_parameters(name):
    """Every ViT zoo name builds (on the meta device, with the keywords
    the CLIs pass) with exactly the JAX package's parameters, name for
    name and shape for shape, and the JAX geometry."""
    narrator = name.startswith("VCLM")
    img, patch, depth, width = {**VIT_DUALS, **VIT_NARRATORS}[name]
    kw = (dict(num_frames=4, gated_xattn=True, remat=True) if narrator else
          dict(num_frames=4, project_embed_dim=256, temperature_init=0.05,
               drop_path_rate=0.1, remat=True))
    with torch.device("meta"):
        pm = zoo._REGISTRY[name](**kw)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    want = _jax_shapes(name, img)
    assert got == want
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(s)) for s in want.values())
    vit = pm.visual
    assert (vit.patch_size, vit.width) == (patch, width)
    assert len(vit.transformer.resblocks) == depth
    assert vit.num_patches == (img // patch) ** 2
    if narrator:  # remat goes to GPT-2 only
        assert pm.text_decoder.cfg.remat and pm.text_decoder.cfg.\
            cross_attn_freq == 2
    else:  # the JAX factory ignores temperature_init and the projection
        assert pm.image_projection is None
        assert pm.logit_scale.shape == ()


def test_zoo_vit_dual_encoder_ignores_the_training_keywords(monkeypatch):
    """As the JAX factory swallows them: the logit scale starts at
    log(1 / 0.07) and the embedding is the ViT's output_dim, whatever
    ``temperature_init`` and ``project_embed_dim`` say; an unknown keyword
    raises."""
    from lavila_tpu_torch.models import build_model
    seen = []
    real = zoo.VideoCLIP

    def spy(*args, **kw):
        seen.append((args[2:], kw))
        return real(*args, **kw)

    monkeypatch.setattr(zoo, "VideoCLIP", spy)
    with torch.device("meta"):
        zoo._REGISTRY["CLIP_OPENAI_VITL14"](temperature_init=0.05,
                                            project_embed_dim=64)
    assert seen == [((768,), {"use_image_projection": False})]
    with pytest.raises(TypeError):
        build_model("CLIP_OPENAI_VITB16", device="meta", unknown=1)


def test_state_dict_from_jax_maps_the_vit_trees():
    """Both JAX ViT trees (``vision_model/vit/...``) land on OpenAI's
    names: the conv kernel HWIO → OIHW, ``in_proj`` packed, fc1/fc2 →
    c_fc/c_proj."""
    _, params, _ = _dual_pair()
    sd = state_dict_from_jax(params)
    vit = params["vision_model"]["vit"]
    np.testing.assert_array_equal(
        sd["visual.conv1.weight"].numpy(),
        vit["conv1"]["kernel"].transpose(3, 2, 0, 1))
    blk = vit["transformer"]["resblocks_1"]
    np.testing.assert_array_equal(
        sd["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy(),
        blk["attn"]["in_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["visual.transformer.resblocks.1.mlp.c_proj.weight"].numpy(),
        blk["mlp"]["fc2"]["kernel"].T)
    assert {"visual.class_embedding", "visual.positional_embedding",
            "visual.proj", "visual.ln_pre.weight",
            "visual.ln_post.bias"} <= set(sd)


# ------------------------------------------------- OpenAI's layout

def _openai_state_dict(model, seed=9):
    """Seeded values under OpenAI's CLIP keys (the port model's own names,
    fp16 as OpenAI releases them) and the three metadata entries."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: (0.1 * torch.randn(v.shape, generator=g)).half()
          for k, v in model.state_dict().items()}
    sd["logit_scale"] = torch.tensor(4.6052).half()
    sd.update(input_resolution=torch.tensor(IMG), context_length=torch.tensor(
        77), vocab_size=torch.tensor(49408))
    return sd


def _openai_port():
    return VideoCLIP(FrameMeanViT(**_geom()),
                     TextTransformer(**TEXT, embed_dim=16), 16,
                     use_image_projection=False)


def _scripted(sd):
    """A TorchScript archive holding ``sd`` under its dotted names (the
    released CLIP files' kind)."""
    root = torch.nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        mod = root
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        if value.is_floating_point():
            mod.register_parameter(leaf, torch.nn.Parameter(value))
        else:
            mod.register_buffer(leaf, value)
    return torch.jit.script(root)


@pytest.mark.parametrize("kind", ["pickle", "torchscript"])
def test_openai_layout_loads_strict_and_matches_jax_import(tmp_path, kind):
    pm = _openai_port()
    sd = _openai_state_dict(pm)
    path = tmp_path / "clip.pt"
    if kind == "pickle":
        torch.save(sd, path)
    else:
        torch.jit.save(_scripted(sd), str(path))
    loaded = load_reference_checkpoint(str(path))
    assert not set(OPENAI_METADATA) & set(loaded)
    assert all(v.dtype == torch.float32 for v in loaded.values())
    pm.load_state_dict(loaded, strict=True)
    # the JAX package's importers over the same arrays
    np_sd = {k: v.float().numpy() for k, v in sd.items()}
    params = {"vision_model": {"vit": imp.import_clip_vit(np_sd, 2)},
              "text_model": imp.import_clip_text(np_sd, 1, prefix=""),
              "logit_scale": np_sd["logit_scale"]}
    wrapper = type(jax_build_model("CLIP_OPENAI_VITB16").vision_model)
    jm = JaxVideoCLIP(vision_model=wrapper(vit=JaxViT(**_geom())),
                      text_model=JaxText(**TEXT, embed_dim=16),
                      vision_width=16, embed_dim=16,
                      use_image_projection=False)
    frames, text = _clip_batches(1, B=2)[0]
    want = jm.apply({"params": params}, jnp.asarray(frames),
                    jnp.asarray(text))
    with torch.inference_mode():
        got = pm.eval()(_t(frames), torch.from_numpy(text).long())
    for k in ("image_embed", "text_embed", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_openai_layout_missing_or_extra_key_raises(tmp_path):
    pm = _openai_port()
    sd = _openai_state_dict(pm)
    for name, bad in (("missing", {k: v for k, v in sd.items()
                                   if k != "visual.ln_post.bias"}),
                      ("extra", {**sd, "visual.attnpool.weight":
                                 torch.zeros(1)})):
        path = tmp_path / f"{name}.pt"
        torch.save(bad, path)
        with pytest.raises(RuntimeError, match="visual.ln_post.bias|"
                           "visual.attnpool.weight"):
            pm.load_state_dict(load_reference_checkpoint(str(path)), strict=True)
