"""The weight bridge: JAX ``VideoCLIP`` params → the port's state dict
(strict load, every leaf consumed), and reference ``.pt`` checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.import_torch import (import_video_clip,
                                            inflate_temporal_embed)
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import (inflate_temporal_embed as
                                             port_inflate,
                                             load_reference_checkpoint,
                                             state_dict_from_jax)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini_params():
    model = jax_build_model("CLIP_OPENAI_TIMESFORMER_MINI")
    params = model.init(jax.random.key(0), jnp.zeros((1, 4, 64, 64, 3)),
                        jnp.zeros((1, 77), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _as_dict(tree):
    return {k: _as_dict(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


def test_state_dict_from_jax_loads_strict(mini_params):
    sd = state_dict_from_jax(mini_params)
    model = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    model.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree.leaves(mini_params))
    assert len(sd) == n_leaves == len(model.state_dict())
    # layouts: Dense (in, out) → (out, in); Conv (kh, kw, I, O) → (O, I, ..)
    vm = mini_params["vision_model"]
    np.testing.assert_array_equal(
        sd["visual.blocks.0.attn.qkv.weight"].numpy(),
        vm["blocks_0"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["visual.patch_embed.proj.weight"].numpy(),
        vm["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    tm = mini_params["text_model"]["transformer"]["resblocks_1"]
    np.testing.assert_array_equal(
        sd["transformer.resblocks.1.attn.in_proj_weight"].numpy(),
        tm["attn"]["in_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["transformer.resblocks.1.mlp.c_fc.bias"].numpy(),
        tm["mlp"]["fc1"]["bias"])
    assert sd["logit_scale"].shape == ()


# (the time gate, blocks_0/alpha_timeattn, maps to the port's
# visual.blocks.0.alpha_timeattn: tests/test_torch_gate_remat.py)
@pytest.mark.parametrize("extra", [
    ("vision_model", "blocks_0", "alpha_spaceattn"),
    ("vision_model", "patch_embed", "scale"),
    ("text_model", "transformer", "resblocks_0", "ln_1", "gamma"),
    ("extra_head",),
])
def test_state_dict_from_jax_rejects_leftovers(mini_params, extra):
    params = _as_dict(mini_params)
    node = params
    for k in extra[:-1]:
        node = node.setdefault(k, {})
    node[extra[-1]] = np.zeros((3,), np.float32)
    with pytest.raises(KeyError, match="no port counterpart"):
        state_dict_from_jax(params)


def test_reference_checkpoint_round_trip(mini_params, tmp_path):
    """A DDP-prefixed reference checkpoint loads strict into the port, and
    the JAX importer reads the same file back to the same params."""
    sd = state_dict_from_jax(mini_params)
    path = tmp_path / "ckpt.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, path)
    loaded = load_reference_checkpoint(str(path))
    assert set(loaded) == set(sd)
    model = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu")
    model.load_state_dict(loaded, strict=True)
    back = import_video_clip({k: v.numpy() for k, v in loaded.items()},
                             strict=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mini_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_inflates_temporal_embed(mini_params,
                                                      tmp_path):
    sd = state_dict_from_jax(mini_params)
    sd["visual.temporal_embed"] = torch.randn(1, 4, 64)
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path)
    loaded = load_reference_checkpoint(str(path), num_frames=8)
    model = build_model("CLIP_OPENAI_TIMESFORMER_MINI", device="cpu",
                        num_frames=8)
    model.load_state_dict(loaded, strict=True)
    np.testing.assert_allclose(
        loaded["visual.temporal_embed"].numpy(),
        inflate_temporal_embed(sd["visual.temporal_embed"].numpy(), 8),
        atol=1e-6)


@pytest.mark.parametrize("frames", [1, 2, 4, 5, 7, 8, 16, 32])
def test_inflate_temporal_embed_matches_jax(frames):
    te = np.random.default_rng(frames).normal(size=(1, 4, 8)).astype(
        np.float32)
    got = port_inflate(torch.from_numpy(te), frames).numpy()
    np.testing.assert_allclose(got, inflate_temporal_embed(te, frames),
                               atol=1e-6)
