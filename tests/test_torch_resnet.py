"""CLIP's ModifiedResNet in the port (``models/resnet_clip.py``) against
``lavila_tpu.models.resnet_clip`` on the same weights and running
statistics, read from one state dict in OpenAI's layout by each
package's ``import_resnet_clip``, at a small size (stages of one
bottleneck, width 16, 64², a 4-head pool to 32), fp32: atol 1e-5, in
``train()`` and ``eval()`` alike (the norms always use the running
statistics, as the JAX ``BatchNorm`` does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import import_torch as imp
from lavila_tpu.models.resnet_clip import ModifiedResNet as JaxResNet
from lavila_tpu_torch.kernels import flash as KF
from lavila_tpu_torch.models.convert import import_resnet_clip
from lavila_tpu_torch.models.resnet_clip import ModifiedResNet

torch.set_num_threads(1)

GEOM = dict(layers=(1, 1, 1, 1), output_dim=32, heads=4,
            input_resolution=64, width=16)


def _openai_state_dict(seed=0):
    """The port's tower's names under ``visual.`` (OpenAI's), the JAX
    initialisers' scales, the norms' scales, shifts and running
    statistics seeded away from 1, 0, 0, 1; one ``num_batches_tracked``
    as OpenAI's archives hold it."""
    model = ModifiedResNet(**GEOM)
    model.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "bias")):
            v = torch.from_numpy(rng.normal(0.0, 0.1, v.shape)
                                 .astype(np.float32))
        elif k.endswith("running_var") or (
                k.endswith("weight") and v.dim() == 1):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        sd[f"visual.{k}"] = v
    sd["visual.bn1.num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.mark.parametrize("train", [False, True])
def test_resnet_matches_jax(train):
    sd = _openai_state_dict()
    model = ModifiedResNet(**GEOM)
    model.load_state_dict(import_resnet_clip(sd), strict=True)
    model.train(train)
    params, stats = imp.import_resnet_clip(
        {k: v.numpy() for k, v in sd.items()
         if not k.endswith("num_batches_tracked")}, GEOM["layers"])
    jm = JaxResNet(**GEOM)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resnet_keeps_openai_names():
    """The state dict is OpenAI's RN layout: the stem, the downsample's
    conv and norm as ``0`` and ``1``, the attention pool's projections."""
    keys = set(ModifiedResNet(**GEOM).state_dict())
    for k in ("conv1.weight", "bn3.running_var", "layer1.0.conv3.weight",
              "layer2.0.downsample.0.weight",
              "layer2.0.downsample.1.running_mean",
              "attnpool.positional_embedding", "attnpool.q_proj.weight",
              "attnpool.c_proj.bias"):
        assert k in keys, k
    assert not any("num_batches_tracked" in k for k in keys)


def test_rn50_shapes():
    """RN50's defaults (the JAX module's): 1024 features from 224²
    images, a 7² + 1-token pool 2048 wide, on the meta device."""
    with torch.device("meta"):
        m = ModifiedResNet()
    assert m.attnpool.positional_embedding.shape == (50, 2048)
    assert [len(getattr(m, f"layer{i}")) for i in (1, 2, 3, 4)] == \
        [3, 4, 6, 3]
    assert m.attnpool.c_proj.out_features == 1024


def test_attention_pool_goes_through_the_flash_dispatch(monkeypatch):
    """The pool's attention is ``ops/attention.full_attention``: one query
    over the 1 + H·W tokens through the flash dispatch site (K7 under
    inference on a CUDA tensor), its plain version on the CPU."""
    calls = []
    ref = KF.flash_attention_reference

    def counted(q, k, v, *rest):
        calls.append((tuple(q.shape), tuple(k.shape), rest[0]))
        return ref(q, k, v, *rest)
    monkeypatch.setattr(KF, "flash_attention_reference", counted)
    model = ModifiedResNet(**GEOM)
    with torch.inference_mode():
        model(torch.zeros(2, 64, 64, 3))
    assert calls == [((2, 1, 4, 128), (2, 5, 4, 128), False)]
