"""The port's zero-shot CLI on the EK-100 MIR fixture of
tests/test_eval_zeroshot_cli.py, on the CPU: with the MINI weights the
JAX CLI builds from ``jax.random.key(0)``, saved as a reference ``.pt``,
the port must score the same mAP/nDCG as the JAX CLI (within 1e-4). A
DistilBERT dual encoder at MINI size (:func:`bert_mini`, with a fixture
WordPiece vocabulary) runs the CLI end to end, its masks reaching the
text tower."""

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
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    args = port_cli.get_args_parser().parse_args(
        ["--checkpoint", str(tmp_path / "checkpoint_best"), "--device",
         "cpu"])
    with pytest.raises(NotImplementedError, match="Orbax"):
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
               drop_path_rate=0.0, remat=False):
    from lavila_tpu_torch.models.distilbert import DistilBertModel
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    from lavila_tpu_torch.models.timesformer import SpaceTimeTransformer
    vision = SpaceTimeTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
        num_frames=num_frames, drop_path_rate=drop_path_rate, remat=remat)
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


def test_port_cli_gated_xattn_names_its_roadmap_subject(tmp_path):
    """A checkpoint whose config asks for timesformer_gated_xattn is
    refused, naming ROADMAP queue 1 item 7a."""
    from lavila_tpu_torch.cli import eval_zeroshot as port_cli
    ckpt = tmp_path / "gated.pt"
    (tmp_path / "gated.pt.json").write_text(json.dumps({"config": {
        "model": "CLIP_OPENAI_TIMESFORMER_MINI",
        "timesformer_gated_xattn": True}}))
    args = port_cli.get_args_parser().parse_args(
        ["--checkpoint", str(ckpt), "--device", "cpu"])
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1: timesformer_gated_xattn"):
        port_cli.load_model_from_checkpoint(args)
