"""``scripts/export_jax_checkpoint.py`` on the CPU: a MINI run of the JAX
package's ``cli.main_pretrain`` on the synthetic dataset (one step)
writes an Orbax checkpoint, the script writes it as a port checkpoint,
and the port's CLIs load it as they load their own: ``eval_zeroshot``'s
embeddings equal the JAX forward's on the restored parameters (atol
1e-5), and the narrator (``VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI``,
trained with ``--gated-xattn``) loaded by ``main_infer_narrator`` decodes
the JAX narrator's greedy ids."""

import argparse
import json
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from lavila_tpu.config import (PretrainConfig, model_kwargs_from_config,
                               parse_config)
from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli import main_infer_narrator
from test_eval_narrator_cli import gpt2_vocab_dir  # noqa: F401  (fixture)

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(__file__)), "scripts"))
import export_jax_checkpoint as X  # noqa: E402

torch.set_num_threads(1)

CLIP = "CLIP_OPENAI_TIMESFORMER_MINI"
VCLM = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"


def _jax_run(out, model, *extra):
    """One step of the JAX pretraining CLI (batch 8: the suite's 8 CPU
    devices), its checkpoint in ``out``."""
    import cli.main_pretrain as jax_cli
    jax_cli.main(parse_config(PretrainConfig, [
        "--dataset", "synthetic", "--model", model, "--steps", "1",
        "--batch-size", "8", "--workers", "1", "--output-dir", str(out),
        *extra]))
    return out


def _jax_model_and_params(path):
    """The JAX run's model, built from its sidecar's config as the JAX
    CLIs build it, and its params, restored whole by Orbax."""
    with open(path + ".json") as f:
        config = json.load(f)["config"]
    model = jax_build_model(config["model"], **model_kwargs_from_config(
        argparse.Namespace(**config)))
    return model, {"params": ocp.StandardCheckpointer().restore(path)[
        "params"]}


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_clip"), CLIP)


@pytest.fixture()
def vclm_run(tmp_path, gpt2_vocab_dir, monkeypatch):  # noqa: F811
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", gpt2_vocab_dir)
    return _jax_run(tmp_path / "jax_vclm", VCLM, "--gated-xattn")


def test_exported_dual_encoder_serves_the_jax_embeddings(clip_run,
                                                         tmp_path):
    """The exported file and sidecar, loaded by the port's
    ``eval_zeroshot`` from its sidecar's config: image and text
    embeddings equal the JAX model's on the checkpoint's params."""
    ckpt = str(clip_run / "checkpoint_latest")
    pt, meta = X.export(ckpt, str(tmp_path / "exported"))
    saved = torch.load(pt, weights_only=True)
    assert set(saved) == {"state_dict", "step"} and saved["step"] is None
    sidecar = json.loads(open(meta).read())
    assert sidecar["config"]["model"] == CLIP
    assert sidecar["exported_from"] == osp.abspath(ckpt)
    args = ez.get_args_parser().parse_args(
        ["--checkpoint", pt, "--device", "cpu"])
    model, _, name = ez.load_model_from_checkpoint(args)
    assert name == CLIP
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    text = rng.integers(1, 49407, size=(2, 77)).astype(np.int32)
    text[:, 9] = 49407
    jm, v = _jax_model_and_params(ckpt)
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


def test_export_by_tag_in_the_run_dir(clip_run, tmp_path):
    """A bare tag resolves inside ``--run-dir``, as the JAX manager
    resolves it; the same weights as the path."""
    X.main(["latest", "--run-dir", str(clip_run), "--out",
            str(tmp_path / "by_tag")])
    X.main([str(clip_run / "checkpoint_0000"), "--out",
            str(tmp_path / "by_path")])
    a = torch.load(tmp_path / "by_tag.pt", weights_only=True)["state_dict"]
    b = torch.load(tmp_path / "by_path.pt", weights_only=True)["state_dict"]
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_export_without_a_sidecar_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="sidecar"):
        X.export(str(tmp_path / "checkpoint_latest"), str(tmp_path / "x"))


def test_exported_narrator_decodes_the_jax_greedy_ids(vclm_run, tmp_path):
    """The exported narrator through ``main_infer_narrator``'s loader (the
    port layout, told by its ``step`` key): the JAX narrator's greedy
    ids on the same clips."""
    ckpt = str(vclm_run / "checkpoint_latest")
    pt, _ = X.export(ckpt, str(tmp_path / "narrator"))
    args = main_infer_narrator.get_args_parser().parse_args(
        ["--model", VCLM, "--checkpoint", pt, "--device", "cpu"])
    pm = main_infer_narrator.load_narrator(args)
    jm, v = _jax_model_and_params(ckpt)
    frames = np.random.default_rng(1).normal(
        size=(2, 4, 64, 64, 3)).astype(np.float32)
    kw = dict(bos_id=50256, eos_id=-1, pad_id=0, max_text_length=10,
              top_k=1, num_return_sequences=2)
    toks = jm.apply(v, jnp.asarray(frames), method="encode_image")
    want, _ = jm.apply(v, toks, rng=jax.random.key(0), method="generate",
                       **kw)
    with torch.no_grad():
        got, _ = pm.generate(pm.encode_image(torch.from_numpy(frames)),
                             generator=torch.Generator(), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
