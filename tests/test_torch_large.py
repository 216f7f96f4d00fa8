"""The port's TimeSformer over frames of more than 256 patches, and the
TSF-L zoo entries, against ``lavila_tpu``.

  * A small tower at an N > 256 geometry (288², patch 16: N = 324; depth
    2, width 64, 4 heads) on weights carried by ``convert.py``: its
    embeddings, its joint token sequence and the gradients of every
    parameter against the JAX tower on the Pallas backend (spatial phase
    through ``spatial_phase_big`` in interpret mode), with remat off and
    on. fp32, atol 1e-4.
  * Remat with drop-path: the same masks in the recompute, so remat on
    and off give the same gradients.
  * Every new zoo entry (TSF-L, TSF-L@336 and the three TSF-L narrators)
    holds exactly the JAX package's parameters, name for name through
    ``convert.torch_key`` and shape for shape (the JAX tree abstractly,
    the port's on the meta device: nothing is allocated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models.dual_encoder import VideoCLIP as JaxVideoCLIP
from lavila_tpu.models.openai_clip import TextTransformer as JaxText
from lavila_tpu.models.timesformer import SpaceTimeTransformer as JaxTSF
from lavila_tpu.ops import attention as JA
from lavila_tpu_torch.models import zoo
from lavila_tpu_torch.models.convert import state_dict_from_jax, torch_key
from lavila_tpu_torch.models.dual_encoder import VideoCLIP
from lavila_tpu_torch.models.openai_clip import TextTransformer
from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer

torch.set_num_threads(1)

GEOM = dict(img_size=288, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            num_frames=4)
TEXT = dict(width=32, heads=2, layers=1, embed_dim=32)


def _port(remat=False, drop_path_rate=0.0):
    return VideoCLIP(SpaceTimeTransformer(**GEOM, remat=remat,
                                          drop_path_rate=drop_path_rate),
                     TextTransformer(**TEXT), embed_dim=32)


@pytest.fixture(scope="module")
def tower():
    """The JAX model, its params (time attention given seeded noise, so
    the temporal phase is exercised), frames and a cotangent."""
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 4, 288, 288, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 32)).astype(np.float32)
    jm = JaxVideoCLIP(vision_model=JaxTSF(**GEOM, ln_pre=True,
                                          act="quick_gelu"),
                      text_model=JaxText(**TEXT), vision_width=64,
                      embed_dim=32)
    params = jm.init(jax.random.key(1), jnp.asarray(frames),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
    return jm, params, frames, cot


@pytest.fixture()
def pallas_backend():
    old = JA.get_attention_backend()
    JA.set_attention_backend("pallas")
    yield
    JA.set_attention_backend(old)


def test_n324_tower_forward_matches_jax(tower, pallas_backend):
    jm, params, frames, _ = tower
    pm = _port()
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert pm.visual.num_patches == 324
    v, f = {"params": params}, jnp.asarray(frames)
    with torch.inference_mode():
        got = pm.encode_image(torch.from_numpy(frames))
        got_seq = pm.visual(torch.from_numpy(frames), cls_at_last=False)
    want = jm.apply(v, f, method="encode_image")
    want_seq = jm.apply(v, f, method=lambda m, x: m.visual(
        x, cls_at_last=False))
    assert got_seq.shape == (2, 1 + 4 * 324, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_n324_tower_gradients_match_jax(tower, pallas_backend, remat):
    """The gradient of Σ embed·cot for every parameter: JAX's against the
    port's (the video tower's backward kernels' plain versions, K6's among
    them), with remat off and on."""
    jm, params, frames, cot = tower

    def loss(p):
        emb = jm.apply({"params": p}, jnp.asarray(frames),
                       method="encode_image")
        return jnp.sum(emb * cot)

    want = state_dict_from_jax(jax.grad(loss)(params))
    pm = _port(remat=remat)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    (pm.encode_image(torch.from_numpy(frames))
     * torch.from_numpy(cot)).sum().backward()
    for name, p in pm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_remat_with_drop_path_gives_the_same_gradients(tower):
    """drop_path_rate > 0 in train mode: the masks come from one seeded
    generator and are drawn before each checkpointed block, so the
    recompute uses them too and remat changes no gradient."""
    _, params, frames, cot = tower
    grads = []
    for remat in (False, True):
        pm = _port(remat=remat, drop_path_rate=0.5).train()
        pm.load_state_dict(state_dict_from_jax(params), strict=True)
        emb = pm.encode_image(torch.from_numpy(frames),
                              torch.Generator().manual_seed(3))
        (emb * torch.from_numpy(cot)).sum().backward()
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=1e-6, msg=k)
    # the masks matter: another seed gives other gradients
    pm = _port(remat=True, drop_path_rate=0.5).train()
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    emb = pm.encode_image(torch.from_numpy(frames),
                          torch.Generator().manual_seed(4))
    (emb * torch.from_numpy(cot)).sum().backward()
    w = "visual.blocks.1.mlp.fc2.weight"
    assert not torch.allclose(dict(pm.named_parameters())[w].grad,
                              grads[0][w])


@pytest.mark.parametrize("name,img", [
    ("CLIP_OPENAI_TIMESFORMER_LARGE", 224),
    ("CLIP_OPENAI_TIMESFORMER_LARGE_336PX", 336),
    ("VCLM_OPENAI_TIMESFORMER_LARGE_GPT2", 224),
    ("VCLM_OPENAI_TIMESFORMER_LARGE_GPT2_XL", 224),
    ("VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL", 336),
])
def test_zoo_large_entries_have_the_jax_parameters(name, img):
    narrator = name.startswith("VCLM")
    kw = {"gated_xattn": True} if narrator else {}
    jm = jax_build_model(name, num_frames=4, **kw)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 4, img, img, 3)),
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
    with torch.device("meta"):
        pm = zoo._REGISTRY[name](**kw)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    n = (img // 14) ** 2
    assert pm.visual.num_patches == n and len(pm.visual.blocks) == 24
    assert got["visual.pos_embed"] == (1, n + 1, 1024)
