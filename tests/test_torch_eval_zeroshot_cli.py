"""The port's zero-shot CLI on the EK-100 MIR fixture of
tests/test_eval_zeroshot_cli.py, on the CPU: with the MINI weights the
JAX CLI builds from ``jax.random.key(0)``, saved as a reference ``.pt``,
the port must score the same mAP/nDCG as the JAX CLI (within 1e-4). A
DistilBERT dual encoder at MINI size (:func:`bert_mini`, with a fixture
WordPiece vocabulary) runs the CLI end to end, its masks reaching the
text tower. A checkpoint of the MINI dual encoder with the time gate
(:func:`gated_mini`, registered in both zoos) serves the JAX model's
embeddings."""

import json

import numpy as np
import pytest
import torch

from test_eval_zeroshot_cli import ek100_fixture  # noqa: F401  (fixture)

torch.set_num_threads(1)

_METRICS = ("mAP_v2t", "mAP_t2v", "mAP_avg", "nDCG_v2t", "nDCG_t2v",
            "nDCG_avg")


def _argv(root, meta, *extra):
    return ["--dataset", "ek100_mir", "--root", root, "--metadata", meta,
            "--model", "CLIP_OPENAI_TIMESFORMER_MINI", "--clip-length", "4",
            "--batch-size", "2", "--workers", "2", *extra]


@pytest.fixture()
def jax_run(ek100_fixture, tmp_path):  # noqa: F811
    """The JAX CLI's metrics, and its key(0) MINI weights as a .pt."""
    import jax

    import cli.eval_zeroshot as jax_cli
    from lavila_tpu_torch.models.convert import state_dict_from_jax
    root, meta = ek100_fixture
    args = jax_cli.get_args_parser().parse_args(_argv(root, meta))
    want = jax_cli.main(args)
    _, variables, _, _ = jax_cli.load_model_from_checkpoint(args)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    ckpt = tmp_path / "mini_key0.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    return root, meta, str(ckpt), want


def test_port_cli_matches_jax_cli(jax_run):
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    root, meta, ckpt, want = jax_run
    args = port_cli.get_args_parser().parse_args(
        _argv(root, meta, "--checkpoint", ckpt, "--device", "cpu"))
    got = port_cli.main(args)
    for k in _METRICS:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


def test_port_cli_bf16(jax_run):
    """--bf16 casts the model; the scores stay valid metrics."""
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    root, meta, ckpt, _ = jax_run
    args = port_cli.get_args_parser().parse_args(
        _argv(root, meta, "--checkpoint", ckpt, "--device", "cpu",
              "--bf16"))
    model, _, _ = port_cli.load_model_from_checkpoint(args)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    out = port_cli.main(args)
    for k in _METRICS:
        assert 0.0 <= out[k] <= 1.0


def test_port_cli_cuda_without_card_raises():
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = port_cli.get_args_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.load_model_from_checkpoint(args)


def test_port_cli_rejects_orbax_checkpoint(tmp_path):
    """An Orbax checkpoint directory is refused, naming the exporter that
    writes it as a ``.pt``."""
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    args = port_cli.get_args_parser().parse_args(
        ["--checkpoint", str(tmp_path / "checkpoint_best"), "--device",
         "cpu"])
    with pytest.raises(NotImplementedError,
                       match="Orbax.*scripts/export_jax_checkpoint.py"):
        port_cli.load_model_from_checkpoint(args)


# ---- the DistilBERT dual encoders through the CLI

# a DistilBERT dual encoder at MINI size, registered by the fixture below:
# the name ends in DISTILBERT_BASE, so the tokenizer factory picks the
# WordPiece vocabulary, and holds MINI, so the CLIs crop to 64
BERT_MINI = "CLIP_OPENAI_TIMESFORMER_MINI_DISTILBERT_BASE"
BERT_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "synthetic",
               "clip", "narration", "#", "c", ",", "."]
              + [str(i) for i in range(10)] + [f"##{i}" for i in range(10)])


def _bert_mini(num_frames=4, project_embed_dim=64, temperature_init=0.07,
               drop_path_rate=0.0, remat=False, remat_policy="full",
               timesformer_gated_xattn=False):
    from lavila_tpu_torch.models.distilbert import DistilBertModel
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat,
        remat_policy=remat_policy, is_tanh_gating=timesformer_gated_xattn)
    text = DistilBertModel(vocab_size=len(BERT_VOCAB), dim=64, num_heads=4,
                           hidden_dim=256, n_layers=2,
                           max_position_embeddings=77)
    return VideoCLIPHF(vision, text, project_embed_dim,
                       temperature_init=temperature_init)


@pytest.fixture()
def bert_mini(tmp_path, monkeypatch):
    """:data:`BERT_MINI` in the port's zoo, and a fixture WordPiece
    vocabulary under ``$LAVILA_TOKENIZER_DIR/distilbert-base-uncased``
    (the pattern of tests/test_tokenizers.py's ``tiny_bert_dir``)."""
    from lavila_tpu_torch.models import zoo
    vocab = tmp_path / "tokenizers" / "distilbert-base-uncased"
    vocab.mkdir(parents=True)
    (vocab / "vocab.txt").write_text("\n".join(BERT_VOCAB) + "\n")
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", str(vocab.parent))
    monkeypatch.setitem(zoo._REGISTRY, BERT_MINI, _bert_mini)
    return BERT_MINI


def test_port_cli_distilbert_end_to_end(ek100_fixture, bert_mini):  # noqa: F811
    """EK-100 MIR through the CLI with a DistilBERT dual encoder: the
    WordPiece tokenizer's masks go with the text, the scores are
    metrics."""
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    from lavila_tpu_torch.data.tokenizers import WordPieceTokenizer
    root, meta = ek100_fixture
    argv = _argv(root, meta, "--device", "cpu")
    argv[argv.index("--model") + 1] = bert_mini
    args = port_cli.get_args_parser().parse_args(argv)
    _, tokenizer, _ = port_cli.load_model_from_checkpoint(args)
    assert isinstance(tokenizer, WordPieceTokenizer)
    out = port_cli.main(args)
    for k in _METRICS:
        assert 0.0 <= out[k] <= 1.0, k


def test_port_cli_passes_the_distilbert_mask(bert_mini):
    """``embed_dataset`` (one and several narrations a clip) and
    ``build_label_embeddings`` hand the text tower each caption's mask:
    ids past it can change without moving an embedding, which they do
    move when the mask is withheld."""
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    args = port_cli.get_args_parser().parse_args(
        ["--model", bert_mini, "--device", "cpu"])
    model, tokenizer, _ = port_cli.load_model_from_checkpoint(args)
    ids, mask = tokenizer(["a synthetic clip 1", "narration 22",
                           "a clip 305", "a"])
    other = np.where(mask > 0, ids, 7)
    frames = np.random.default_rng(0).normal(
        size=(2, 4, 64, 64, 3)).astype(np.float32)

    def embed(text, has_mask):
        batches = [{"frames": frames, "text": t, "mask": m}
                   for t, m in ((text[:2], mask[:2]), (text[2:], mask[2:]))]
        flat = port_cli.embed_dataset(model, batches, has_mask)[1]
        # the same captions as two narrations of one clip
        listed = [{"frames": frames[:1], "text": text[None, :2],
                   "mask": mask[None, :2]},
                  {"frames": frames[1:], "text": text[None, 2:],
                   "mask": mask[None, 2:]}]
        return flat, port_cli.embed_dataset(model, listed, has_mask)[1]

    for a, b in zip(embed(ids, True), embed(other, True)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(*embed(ids, True), rtol=0, atol=1e-6)
    assert not np.allclose(embed(ids, False)[0], embed(other, False)[0],
                           atol=1e-3)
    labels = ["a clip", "narration 5", "synthetic 123"]
    want = port_cli.build_label_embeddings(model, tokenizer, labels)
    padded = port_cli.build_label_embeddings(
        model, lambda t: (np.where(tokenizer(t)[1] > 0, tokenizer(t)[0], 9),
                          tokenizer(t)[1]), labels)
    np.testing.assert_allclose(want, padded, rtol=0, atol=1e-6)


# the MINI dual encoder with the tanh gate on its time attention, which
# the zoos' TSF-B/L factories build under timesformer_gated_xattn (their
# MINI takes the keyword and builds none); registered in both zoos by
# the fixture below
GATED_MINI = "CLIP_OPENAI_TIMESFORMER_MINI_GATED"


def _gated_mini(num_frames=4, project_embed_dim=64, temperature_init=0.07,
                drop_path_rate=0.0, remat=False, remat_policy="full",
                timesformer_gated_xattn=False):
    from lavila_tpu_torch.models.dual_encoder import VideoCLIP
    from lavila_tpu_torch.models.openai_clip import TextTransformer
    from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat,
        remat_policy=remat_policy, is_tanh_gating=timesformer_gated_xattn)
    text = TextTransformer(width=64, heads=4, layers=2,
                           embed_dim=project_embed_dim)
    return VideoCLIP(vision, text, project_embed_dim, temperature_init)


def _jax_gated_mini(num_frames=4, project_embed_dim=64,
                    timesformer_gated_xattn=False, remat=False,
                    remat_policy="full", **_unused):
    from lavila_tpu.models.dual_encoder import VideoCLIP
    from lavila_tpu.models.openai_clip import TextTransformer
    from lavila_tpu.models.timesformer import SpaceTimeTransformer
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, ln_pre=True, act="quick_gelu",
        is_tanh_gating=timesformer_gated_xattn, remat=remat,
        remat_policy=remat_policy)
    return VideoCLIP(vision_model=vision,
                     text_model=TextTransformer(width=64, heads=4, layers=2,
                                                embed_dim=project_embed_dim),
                     vision_width=64, embed_dim=project_embed_dim)


@pytest.fixture()
def gated_mini(monkeypatch):
    """:data:`GATED_MINI` in the port's zoo and in the JAX package's."""
    from lavila_tpu.models import zoo as jax_zoo
    from lavila_tpu_torch.models import zoo
    monkeypatch.setitem(zoo._REGISTRY, GATED_MINI, _gated_mini)
    monkeypatch.setitem(jax_zoo._REGISTRY, GATED_MINI, _jax_gated_mini)
    return GATED_MINI


def gated_checkpoint(path, seed=0):
    """The JAX gated MINI dual encoder's params, its gates and time
    attention seeded (at their zero init both are vacuous), written to
    ``path`` as a ``.pt`` in the port's names with a sidecar whose config
    asks for the gate. Returns ``(jax_model, params)``."""
    import jax
    import jax.numpy as jnp

    from lavila_tpu.models import build_model as jax_build_model
    from lavila_tpu_torch.models.convert import state_dict_from_jax
    jm = jax_build_model(GATED_MINI, project_embed_dim=256,
                         timesformer_gated_xattn=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 4, 64, 64, 3)),
        jnp.zeros((1, 77), jnp.int32))["params"])
    rng = np.random.default_rng(seed + 1)
    for name, blk in params["vision_model"].items():
        if name.startswith("blocks_"):
            for lin in blk["timeattn"].values():
                for k, v in lin.items():
                    lin[k] = (rng.normal(size=v.shape) * 0.1).astype(
                        np.float32)
            blk["alpha_timeattn"] = np.float32(rng.uniform(0.3, 0.9))
    torch.save({"state_dict": state_dict_from_jax(params)}, path)
    with open(f"{path}.json", "w") as f:
        json.dump({"config": {"model": GATED_MINI, "clip_length": 4,
                              "project_embed_dim": 256,
                              "timesformer_gated_xattn": True}}, f)
    return jm, params


def test_port_cli_serves_a_gated_checkpoint(gated_mini, tmp_path):
    """A checkpoint whose config asks for timesformer_gated_xattn builds
    the gated tower, loads strict, and serves the JAX model's image and
    text embeddings on the same params (atol 1e-5)."""
    import jax.numpy as jnp

    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    ckpt = tmp_path / "gated.pt"
    jm, params = gated_checkpoint(ckpt)
    args = port_cli.get_args_parser().parse_args(
        ["--checkpoint", str(ckpt), "--device", "cpu"])
    model, _, name = port_cli.load_model_from_checkpoint(args)
    assert name == gated_mini
    assert model.visual.blocks[1].alpha_timeattn.item() == pytest.approx(
        float(params["vision_model"]["blocks_1"]["alpha_timeattn"]))
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    text = rng.integers(1, 49407, size=(2, 77)).astype(np.int32)
    text[:, 5] = 49407
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
