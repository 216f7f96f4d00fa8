"""The port's CLIs with the CLIP ViT models, on the CPU (``--device cpu``).

  * ``eval_zeroshot`` with ``CLIP_OPENAI_VITB32`` reads a ``.pt`` in
    OpenAI's layout (seeded fp16 weights and the three metadata entries)
    strict and scores the EK-100 MIR fixture.
  * A small ViT dual encoder (``CLIP_OPENAI_VIT_MINI``: 64², patch 16, 2
    blocks 64 wide; registered here, the ViT factories' own code path)
    trains through ``main_pretrain`` and its checkpoint serves through
    ``eval_zeroshot``; ``main_finetune_retrieval`` and
    ``main_finetune_classification`` fine-tune it from an OpenAI-layout
    ``.pt`` (the tower loaded bit-equal to the file's values).
  * A small ViT narrator (``VCLM_OPENAI_VIT_MINI_GPT2_MINI``): the freeze
    predicates name the same parameters as JAX's on its JAX paths (the
    ViT has no temporal branch, so ``--freeze-visual-vclm`` freezes all
    of it); ``main_pretrain`` trains it under LaViLa's recipe with every
    ``visual.*`` tensor bit-equal in the checkpoint; ``main_infer_narrator``
    reads a checkpoint of JAX weights (its ViT depth under
    ``visual.transformer.resblocks.``) and writes, greedy, the captions
    and perplexities (rtol 1e-4) that the JAX model gives on the frames
    the CLI fed; a checkpoint of another depth raises.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.config import parse_config
from lavila_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from lavila_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from lavila_tpu.models.gpt2 import augment_config as jax_augment
from lavila_tpu.models.narrator import VCLM as JaxVCLM
from lavila_tpu.models.openai_clip import VisionTransformer as JaxViT
from lavila_tpu.models.zoo import _FrameTokensViT as JaxFrameTokens
from lavila_tpu.train import freeze as JF
from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli import main_finetune_classification as ccli
from lavila_tpu_torch.cli import main_finetune_retrieval as rcli
from lavila_tpu_torch.cli import main_infer_narrator as icli
from lavila_tpu_torch.cli import main_pretrain as pcli
from lavila_tpu_torch.models import build_model, zoo
from lavila_tpu_torch.models.convert import state_dict_from_jax, torch_key
from lavila_tpu_torch.models.dual_encoder import VideoCLIP
from lavila_tpu_torch.models.gpt2 import GPT2Config
from lavila_tpu_torch.models.narrator import VCLM
from lavila_tpu_torch.models.openai_clip import (FrameMeanViT,
                                                FrameTokensViT,
                                                TextTransformer)
from lavila_tpu_torch.train import freeze as F
from test_eval_narrator_cli import gpt2_vocab_dir  # noqa: F401  (fixture)
from test_eval_zeroshot_cli import ek100_fixture  # noqa: F401  (fixture)

torch.set_num_threads(1)

VIT_MINI = "CLIP_OPENAI_VIT_MINI"
VCLM_VIT_MINI = "VCLM_OPENAI_VIT_MINI_GPT2_MINI"
# "MINI" in a name makes the CLIs crop to 64
MINI_GEOM = dict(input_resolution=64, patch_size=16, width=64, layers=2,
                 heads=4, output_dim=32)
GPT2_MINI = dict(vocab_size=50257, n_positions=128, n_embd=64, n_layer=2,
                 n_head=4)
OPENAI_METADATA = {"input_resolution": 64, "context_length": 77,
                   "vocab_size": 49408}


def _vit_mini(num_frames=4, project_embed_dim=256, temperature_init=0.07,
              drop_path_rate=0.0, remat=False, remat_policy="full",
              timesformer_gated_xattn=False):
    """A ViT dual encoder as the zoo's CLIP_OPENAI_VIT* factories build
    one, at MINI size."""
    text = TextTransformer(width=64, heads=4, layers=2, embed_dim=32)
    return VideoCLIP(FrameMeanViT(**MINI_GEOM), text, 32,
                     use_image_projection=False)


def _vclm_vit_mini(num_frames=4, gated_xattn=False,
                   timesformer_gated_xattn=False, remat=False,
                   remat_policy="full"):
    """A ViT narrator as the zoo's VCLM_OPENAI_VIT* factories build one,
    at MINI size (cross-attention on every layer)."""
    return zoo._vclm(FrameTokensViT(**MINI_GEOM), GPT2Config(**GPT2_MINI),
                     1, gated_xattn, remat, heads=4, num_img_queries=16,
                     dim_head=16)


@pytest.fixture()
def minis(monkeypatch):
    monkeypatch.setitem(zoo._REGISTRY, VIT_MINI, _vit_mini)
    monkeypatch.setitem(zoo._REGISTRY, VCLM_VIT_MINI, _vclm_vit_mini)


def _openai_pt(model, path, seed=1):
    """``model``'s parameters as OpenAI releases them (fp16, the three
    metadata entries beside them), seeded; returns the fp32 values the
    file holds."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: (v + 0.01 * torch.randn(v.shape, generator=g)).half()
          for k, v in model.state_dict().items()}
    torch.save({**sd, **{k: torch.tensor(v)
                         for k, v in OPENAI_METADATA.items()}}, path)
    return {k: v.float() for k, v in sd.items()}


def test_eval_zeroshot_reads_an_openai_vitb32_pt(ek100_fixture, tmp_path):  # noqa: F811
    """OpenAI's layout loads strict into CLIP_OPENAI_VITB32 (224² crops,
    the text tower 512 wide), every tensor the file's value, and the
    EK-100 MIR fixture scores."""
    root, meta = ek100_fixture
    model = build_model("CLIP_OPENAI_VITB32", device="cpu")
    path = tmp_path / "ViT-B-32.pt"
    want = _openai_pt(model, path)
    del model
    args = ez.get_args_parser().parse_args(
        ["--dataset", "ek100_mir", "--root", root, "--metadata", meta,
         "--model", "CLIP_OPENAI_VITB32", "--clip-length", "4",
         "--batch-size", "2", "--workers", "2", "--checkpoint", str(path),
         "--device", "cpu"])
    model, tokenizer, name = ez.load_model_from_checkpoint(args)
    assert ez.crop_shape(name) == (224, 224, 3)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    out = ez.eval_ek100_mir(model, tokenizer, name, root=root,
                            metadata=meta, clip_length=4, clip_stride=16,
                            batch_size=2, workers=2)
    assert all(0.0 <= out[k] <= 1.0 for k in ("mAP_v2t", "mAP_t2v",
                                             "nDCG_v2t", "nDCG_t2v"))


def test_pretrain_cli_trains_a_vit_dual_encoder_and_serves_it(tmp_path,
                                                              minis):
    state = pcli.main(parse_config(pcli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--model", VIT_MINI, "--steps", "2",
        "--batch-size", "4", "--workers", "2", "--device", "cpu",
        "--drop-path-rate", "0.1", "--use-checkpoint", "--output-dir",
        str(tmp_path)]))
    assert state.step == 2 and "image_projection" not in state.params
    log = json.loads((tmp_path / "log.txt").read_text().splitlines()[-1])
    assert np.isfinite(log["train_loss"])
    fresh = build_model(VIT_MINI, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for name in ("visual.conv1.weight", "visual.proj",
                 "visual.transformer.resblocks.1.attn.in_proj_weight"):
        assert not torch.equal(state.params[name],
                               fresh.state_dict()[name]), name
    args = ez.get_args_parser().parse_args(
        ["--checkpoint", str(tmp_path / "checkpoint_latest.pt"),
         "--device", "cpu"])
    model, _, name = ez.load_model_from_checkpoint(args)
    assert name == VIT_MINI
    for k, p in model.named_parameters():
        assert torch.equal(p, state.params[k]), k
    with torch.inference_mode():
        emb = model.encode_image(torch.randn(2, 4, 64, 64, 3))
    assert emb.shape == (2, 32) and torch.isfinite(emb).all()


def test_retrieval_cli_fine_tunes_from_an_openai_pt(tmp_path, minis):
    path = tmp_path / "clip.pt"
    want = _openai_pt(build_model(VIT_MINI, device="cpu"), path)
    args = rcli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", VIT_MINI, "--clip-length", "4",
        "--batch-size", "4", "--workers", "2", "--steps", "2",
        "--pretrain-model", str(path), "--device", "cpu", "--output-dir",
        str(tmp_path / "run")])
    model, _ = rcli.build_finetune_model(args, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    state = rcli.main(args)
    assert state.step == 2
    # the fine-tune keeps logit_scale frozen
    assert torch.equal(state.params["logit_scale"], want["logit_scale"])
    assert not torch.equal(state.params["visual.proj"], want["visual.proj"])


def test_classification_cli_fine_tunes_the_vit_tower(tmp_path, minis):
    path = tmp_path / "clip.pt"
    want = _openai_pt(build_model(VIT_MINI, device="cpu"), path)
    args = ccli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", VIT_MINI, "--clip-length", "4",
        "--batch-size", "4", "--workers", "2", "--steps", "2",
        "--num-classes", "6", "--pretrain-model", str(path), "--device",
        "cpu", "--output-dir", str(tmp_path / "run")])
    clf, _ = ccli.build_classifier(args, 6, torch.device("cpu"))
    tower = clf.vision_model.state_dict()
    assert set(tower) == {k.removeprefix("visual.") for k in want
                          if k.startswith("visual.")}
    for k, v in tower.items():
        assert torch.equal(v, want[f"visual.{k}"]), k
    assert clf.fc_cls.in_features == 32  # the ViT's projected feature
    state = ccli.main(args)
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.params.values())


# ------------------------------------------------------------ narrator

def _jax_narrator():
    jcfg = jax_augment(JaxGPT2Config(**GPT2_MINI), cross_attn_freq=1,
                       gated_xattn=True)
    return JaxVCLM(vision_model=JaxFrameTokens(vit=JaxViT(**MINI_GEOM)),
                   text_decoder=JaxGPT2(jcfg), vision_width=64,
                   text_width=64, num_img_queries=16, dim_head=16, heads=4)


@pytest.fixture(scope="module")
def jax_narrator():
    """The JAX counterpart of VCLM_OPENAI_VIT_MINI_GPT2_MINI on key(0),
    its gates seeded non-zero."""
    jm = _jax_narrator()
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 64, 64, 3)),
        jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    for blk in params["text_decoder"].values():
        if isinstance(blk, dict) and "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    return jm, params


def test_freeze_predicates_match_jax_on_the_vit_narrator(jax_narrator):
    """Each VCLM freeze flag names the same parameters under the port's
    names as under JAX's paths; ``--freeze-visual-vclm`` takes the whole
    ViT, ``--freeze-visual-vclm-temporal`` none of it."""
    _, params = jax_narrator
    names = [("/".join(k.key for k in path),
              torch_key(tuple(k.key for k in path))[0])
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    flags = [dict(freeze_visual_vclm=True),
             dict(freeze_visual_vclm_temporal=True),
             dict(freeze_lm_vclm=True),
             dict(freeze_lm_vclm=True, freeze_visual_vclm=True)]
    for f in flags:
        tp, jp = F.build_freeze_predicate(**f), JF.build_freeze_predicate(**f)
        assert {n for p, n in names if jp(p)} == {n for _, n in names
                                                  if tp(n)}
    visual = {n for _, n in names if n.startswith("visual.")}
    assert visual and visual == {
        n for _, n in names
        if F.build_freeze_predicate(freeze_visual_vclm=True)(n)}
    assert not any(F.build_freeze_predicate(
        freeze_visual_vclm_temporal=True)(n) for n in visual)


def test_pretrain_cli_trains_the_vit_narrator_under_the_recipe(
        tmp_path, gpt2_vocab_dir, monkeypatch, minis):  # noqa: F811
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", gpt2_vocab_dir)
    state = pcli.main(parse_config(pcli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--model", VCLM_VIT_MINI, "--gated-xattn",
        "--freeze-lm-vclm", "--freeze-visual-vclm", "--device", "cpu",
        "--batch-size", "4", "--workers", "1", "--steps", "2",
        "--output-dir", str(tmp_path), "--seed", "3"]))
    fresh = dict(build_model(VCLM_VIT_MINI, device="cpu", gated_xattn=True,
                             generator=torch.Generator().manual_seed(3))
                 .named_parameters())
    ckpt = torch.load(tmp_path / "checkpoint_latest.pt", weights_only=True)
    visual = {n for n in fresh if n.startswith("visual.")}
    assert visual <= state.frozen
    for name in visual:
        assert torch.equal(ckpt["state_dict"][name], fresh[name]), name
    gate = "text_decoder.transformer.h.0.alpha_cattn"
    assert not torch.equal(ckpt["state_dict"][gate], fresh[gate])


def test_infer_narrator_cli_on_a_vit_narrator_matches_jax(
        tmp_path, monkeypatch, minis, jax_narrator):
    jm, params = jax_narrator
    path = tmp_path / "vclm_vit.pt"
    torch.save({"state_dict": state_dict_from_jax(params), "step": 0}, path)
    fed = []
    encode = VCLM.encode_image

    def spy(self, frames):
        fed.append(frames.clone())
        return encode(self, frames)

    monkeypatch.setattr(VCLM, "encode_image", spy)
    records = icli.main(icli.get_args_parser().parse_args([
        "--dataset", "synthetic", "--model", VCLM_VIT_MINI, "--clip-length",
        "4", "--batch-size", "3", "--workers", "2", "--max-samples", "5",
        "--num-return-sequences", "2", "--max-text-length", "10",
        "--top-k", "1", "--checkpoint", str(path), "--device", "cpu",
        "--output-dir", str(tmp_path / "out")]))
    assert len(fed) == 2 and len(records) == 5
    assert pickle.loads((tmp_path / "out" / "total.pkl").read_bytes()) \
        == records
    decode, bos, eos, pad = icli.tokenizer_ids(VCLM_VIT_MINI)
    v = {"params": params}
    want = []
    for frames in fed:
        toks = jm.apply(v, jnp.asarray(frames.numpy()),
                        method="encode_image")
        ids, ppl = jm.apply(v, toks, rng=jax.random.key(0),
                            method="generate", bos_id=bos, eos_id=eos,
                            pad_id=pad, max_text_length=10, temperature=0.7,
                            top_k=1, top_p=0.95, num_return_sequences=2)
        caps = icli.captions(np.asarray(ids), eos, decode)
        ppl = np.asarray(ppl)
        want += [(caps[2 * j:2 * j + 2], ppl[2 * j:2 * j + 2])
                 for j in range(frames.shape[0])]
    for rec, (caps, ppl) in zip(records, want):
        assert rec[3] == caps
        np.testing.assert_allclose(rec[4], ppl, rtol=1e-4)


def test_infer_narrator_cli_checks_the_vit_depth(tmp_path, minis,
                                                 jax_narrator):
    _, params = jax_narrator
    sd = {k: v for k, v in state_dict_from_jax(params).items()
          if not k.startswith("visual.transformer.resblocks.1.")}
    path = tmp_path / "shallow.pt"
    torch.save({"state_dict": sd, "step": 0}, path)
    args = icli.get_args_parser().parse_args([
        "--model", VCLM_VIT_MINI, "--checkpoint", str(path), "--device",
        "cpu"])
    with pytest.raises(ValueError, match="visual.transformer.resblocks."):
        icli.load_narrator(args)
