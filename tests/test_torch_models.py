"""The port's towers and dual encoder against ``lavila_tpu`` on the same
weights and numpy inputs: MINI end to end, and one BASE-width case (video
768 wide with 12 heads at 224², text 512 wide with 8 heads over 77
tokens) at depth 1. The time-attention weights are moved away from their
zero init so the temporal phase is exercised. fp32, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.dual_encoder import VideoCLIP as JaxVideoCLIP
from lavila_tpu.models.openai_clip import TextTransformer as JaxText
from lavila_tpu.models.timesformer import SpaceTimeTransformer as JaxTSF
from lavila_tpu_torch.models import build_model, zoo
from lavila_tpu_torch.models.convert import state_dict_from_jax
from lavila_tpu_torch.models.dual_encoder import VideoCLIP, VideoCLIPHF
from lavila_tpu_torch.models.openai_clip import TextTransformer
from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer

torch.set_num_threads(1)


def _params(jax_model, frames, text, seed):
    """Init the JAX model, then give its time attention seeded noise."""
    params = jax_model.init(jax.random.key(seed), jnp.asarray(frames),
                            jnp.asarray(text))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    vm = params["vision_model"]
    for name, blk in vm.items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return params


def _inputs(B, F, size, L, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, F, size, size, 3)).astype(np.float32)
    text = rng.integers(1, 49407, size=(B, L)).astype(np.int32)
    text[:, L // 2] = 49407  # an EOT token: pooling takes its position
    return frames, text


def _compare(jax_model, port_model, params, frames, text, atol):
    port_model.load_state_dict(state_dict_from_jax(params), strict=True)
    port_model.eval()
    v = {"params": params}
    f, t = jnp.asarray(frames), jnp.asarray(text)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(text)
    with torch.inference_mode():
        got_i = port_model.encode_image(tf)
        got_t = port_model.encode_text(tt)
        got = port_model(tf, tt, norm_embed=True)
    want_i = jax_model.apply(v, f, method="encode_image")
    want_t = jax_model.apply(v, t, method="encode_text")
    want = jax_model.apply(v, f, t, norm_embed=True)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=atol,
                               rtol=0)
    for k in ("image_embed", "text_embed", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_mini_matches_jax():
    frames, text = _inputs(2, 4, 64, 77, seed=0)
    jm = jax_build_model("CLIP_OPENAI_TIMESFORMER_MINI")
    params = _params(jm, frames, text, seed=1)
    pm = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    _compare(jm, pm, params, frames, text, atol=1e-4)


def test_mini_fewer_frames_than_num_frames():
    """A clip shorter than ``num_frames`` takes the first temporal PEs."""
    frames, text = _inputs(1, 2, 64, 77, seed=2)
    jm = jax_build_model("CLIP_OPENAI_TIMESFORMER_MINI", num_frames=4)
    params = _params(jm, frames, text, seed=3)
    pm = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    _compare(jm, pm, params, frames, text, atol=1e-4)


def test_mini_joint_sequence_matches_jax():
    """``cls_at_last=False``: the normed (B, 1 + T·N, D) token sequence
    that the narrator's attention pooler reads."""
    frames, text = _inputs(2, 4, 64, 77, seed=6)
    jm = jax_build_model("CLIP_OPENAI_TIMESFORMER_MINI")
    params = _params(jm, frames, text, seed=7)
    pm = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    want = jm.apply({"params": params}, jnp.asarray(frames),
                    method=lambda m, x: m.visual(x, cls_at_last=False))
    with torch.inference_mode():
        got = pm.visual(torch.from_numpy(frames), cls_at_last=False)
    assert got.shape == (2, 1 + 4 * 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_base_width_depth1_matches_jax():
    frames, text = _inputs(1, 4, 224, 77, seed=4)
    jm = JaxVideoCLIP(
        vision_model=JaxTSF(img_size=224, patch_size=16, embed_dim=768,
                            depth=1, num_heads=12, num_frames=4,
                            ln_pre=True, act="quick_gelu"),
        text_model=JaxText(width=512, heads=8, layers=1, embed_dim=256),
        vision_width=768, embed_dim=256)
    params = _params(jm, frames, text, seed=5)
    pm = VideoCLIP(
        SpaceTimeTransformer(img_size=224, patch_size=16, embed_dim=768,
                             depth=1, num_heads=12, num_frames=4),
        TextTransformer(width=512, heads=8, layers=1, embed_dim=256),
        embed_dim=256)
    _compare(jm, pm, params, frames, text, atol=1e-4)


def test_fresh_time_attention_is_zero_init():
    m = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    generator=torch.Generator().manual_seed(7))
    for blk in m.visual.blocks:
        assert not blk.timeattn.qkv.weight.any()
        assert not blk.timeattn.qkv.bias.any()
        assert (blk.timeattn.proj.weight == 1).all()
    assert m.visual.patch_embed.proj.bias is None  # CLIP-style conv
    assert m.logit_scale.item() == pytest.approx(np.log(1 / 0.07))


def test_build_model_is_seeded_and_strict():
    a = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    bf = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                     dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    with pytest.raises(TypeError):  # an unknown keyword argument
        build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                    projection="default")
    with pytest.raises(KeyError):  # a name the zoo does not know
        build_model("CLIP_OPENAI_TIMESFORMER_HUGE", device="cpu")
    # the DistilBERT towers are in the zoo (built on the meta device: a
    # CPU init of TSF-L's 0.5 B parameters would take most of a minute)
    with torch.device("meta"):
        hf = zoo._REGISTRY["CLIP_OPENAI_TIMESFORMER_LARGE_DISTILBERT_BASE"]()
    assert isinstance(hf, VideoCLIPHF) and hf.textual.dim == 768
    assert len(hf.textual.transformer.layer) == 6
    assert hf.visual.embed_dim == 1024 and hf.visual.ln_pre is not None
