"""The TimeSformer dual encoder's init from OpenAI CLIP's released ViT
(``models/openai_weights.py``, ``convert.remap_clip_visual_to_timesformer``)
against ``lavila_tpu.models.openai_weights`` on the same synthetic
checkpoint in OpenAI's layout at MINI widths (a ViT 64 wide, 2 blocks,
patch 16 at 64², and a text tower 64 wide, 2 blocks; the projections
the MINI dual encoder's shape, so they and the logit scale are copied
too): the same embeddings, atol 1e-5; and the cache's sha256 check, its
refusal without download, and a download from a ``file://`` URL."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models import openai_weights as JW
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models import openai_weights as OW
from lavila_tpu_torch.models.convert import remap_clip_visual_to_timesformer

torch.set_num_threads(1)

MINI = "CLIP_OPENAI_TIMESFORMER_MINI"
NAME = "ViT-B/16"


def _block(prefix, w, rng):
    def t(*shape, scale=0.05):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))
    out = {}
    for i in range(2):
        b = f"{prefix}transformer.resblocks.{i}."
        out.update({
            b + "attn.in_proj_weight": t(3 * w, w),
            b + "attn.in_proj_bias": t(3 * w),
            b + "attn.out_proj.weight": t(w, w),
            b + "attn.out_proj.bias": t(w),
            b + "ln_1.weight": 1 + t(w), b + "ln_1.bias": t(w),
            b + "ln_2.weight": 1 + t(w), b + "ln_2.bias": t(w),
            b + "mlp.c_fc.weight": t(4 * w, w), b + "mlp.c_fc.bias": t(4 * w),
            b + "mlp.c_proj.weight": t(w, 4 * w),
            b + "mlp.c_proj.bias": t(w)})
    return out


def _openai_state_dict(seed=0):
    """OpenAI's CLIP layout at MINI widths, seeded."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.05):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))
    sd = {"visual.class_embedding": t(64),
          "visual.positional_embedding": t(17, 64),
          "visual.conv1.weight": t(64, 3, 16, 16),
          "visual.ln_pre.weight": 1 + t(64), "visual.ln_pre.bias": t(64),
          "visual.ln_post.weight": 1 + t(64), "visual.ln_post.bias": t(64),
          "visual.proj": t(64, 64, scale=0.1),
          "token_embedding.weight": t(49408, 64),
          "positional_embedding": t(77, 64),
          "ln_final.weight": 1 + t(64), "ln_final.bias": t(64),
          "text_projection": t(64, 64, scale=0.1),
          "logit_scale": torch.tensor(3.0),
          "input_resolution": torch.tensor(64),
          "context_length": torch.tensor(77),
          "vocab_size": torch.tensor(49408)}
    sd.update(_block("visual.", 64, rng))
    sd.update(_block("", 64, rng))
    return sd


def _publish(tmp_path, sd):
    """``sd`` saved under ``<tmp>/<sha256>/ViT-B-16.pt``: its URL and
    digest."""
    src = tmp_path / "src.pt"
    torch.save(sd, src)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    (tmp_path / digest).mkdir()
    path = tmp_path / digest / "ViT-B-16.pt"
    src.rename(path)
    return f"file://{path}", digest


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """A released ViT-B/16 in OpenAI's layout published at a ``file://``
    URL, both packages' ``MODELS`` pointed at it and their caches at an
    empty directory."""
    sd = _openai_state_dict()
    url, digest = _publish(tmp_path, sd)
    for mod in (OW, JW):
        monkeypatch.setitem(mod.MODELS, NAME, url)
        monkeypatch.setattr(mod, "CACHE_DIR", str(tmp_path / "cache"))
    return sd, digest


def test_init_matches_jax(cache):
    """JAX's and the port's init from the same checkpoint: the same image
    and text embeddings; the time attention keeps its zero init."""
    sd, _ = cache
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    text = rng.integers(1, 49407, size=(2, 77)).astype(np.int32)
    text[:, 7] = 49407
    jm = jax_build_model(MINI)
    params = jm.init(jax.random.key(0), jnp.asarray(frames),
                     jnp.asarray(text))["params"]
    params = JW.load_into_timesformer_dual_encoder(NAME, params, layers=2,
                                                   text_layers=2)
    model = build_model(MINI, device="cpu")
    assert OW.load_into_timesformer_dual_encoder(
        NAME, model, layers=2, text_layers=2) is model
    blk = model.visual.blocks[1]
    assert not blk.timeattn.qkv.weight.any()
    assert (blk.timeattn.proj.weight == 1).all()
    assert torch.equal(model.visual.blocks[1].attn.qkv.weight,
                       sd["visual.transformer.resblocks.1.attn."
                          "in_proj_weight"])
    assert torch.equal(model.image_projection, sd["visual.proj"])
    assert model.logit_scale.item() == 3.0
    v = {"params": params}
    with torch.inference_mode():
        got_i = model.encode_image(torch.from_numpy(frames))
        got_t = model.encode_text(torch.from_numpy(text))
    np.testing.assert_allclose(
        got_i.numpy(), np.asarray(jm.apply(v, jnp.asarray(frames),
                                           method="encode_image")),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got_t.numpy(), np.asarray(jm.apply(v, jnp.asarray(text),
                                           method="encode_text")),
        atol=1e-5, rtol=0)


def test_projections_of_another_shape_keep_their_init(cache):
    """At project_embed_dim 32 the projections do not fit the checkpoint's
    and keep their init, as the logit scale does."""
    model = build_model(MINI, device="cpu", project_embed_dim=32)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k in ("image_projection", "text_projection",
                       "logit_scale")}
    OW.load_into_timesformer_dual_encoder(NAME, model, 2, 2)
    after = model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


def test_remap_names_every_vit_weight():
    """The remap's names are the port's TimeSformer's, each tensor its
    OpenAI counterpart's."""
    sd = _openai_state_dict()
    got = remap_clip_visual_to_timesformer(sd, 2)
    own = build_model(MINI, device="cpu").visual.state_dict()
    assert set(got) <= set(own)
    assert set(own) - set(got) == {
        "temporal_embed", *(f"blocks.{i}.{n}" for i in range(2) for n in (
            "norm3.weight", "norm3.bias", "timeattn.qkv.weight",
            "timeattn.qkv.bias", "timeattn.proj.weight",
            "timeattn.proj.bias"))}
    assert got["cls_token"].shape == (1, 1, 64)
    assert torch.equal(got["norm.weight"], sd["visual.ln_post.weight"])


def test_checkpoint_path_downloads_from_a_file_url(cache):
    _, digest = cache
    path = OW.checkpoint_path(NAME)
    assert path == f"{OW.CACHE_DIR}/ViT-B-16.pt"
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == digest


def test_checkpoint_path_without_download_names_the_cache(cache):
    with pytest.raises(FileNotFoundError, match="not cached at .*ViT-B-16"):
        OW.checkpoint_path(NAME, download=False)


def test_checkpoint_path_refuses_a_wrong_digest(cache, tmp_path):
    OW.checkpoint_path(NAME)
    (tmp_path / "cache" / "ViT-B-16.pt").write_bytes(b"not the weights")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        OW.checkpoint_path(NAME)


def test_checkpoint_path_unreachable_url_names_the_cache(cache,
                                                        monkeypatch,
                                                        tmp_path):
    """A URL that cannot be fetched (a missing local file here) raises
    FileNotFoundError naming the path to fill."""
    _, digest = cache
    monkeypatch.setitem(OW.MODELS, NAME,
                        f"file://{tmp_path}/absent/{digest}/ViT-B-16.pt")
    with pytest.raises(FileNotFoundError, match="pre-populate"):
        OW.checkpoint_path(NAME)
