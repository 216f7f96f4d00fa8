"""The port's narrator evaluation and the beam modes of its narrator CLIs
against the JAX CLIs, on the CPU at MINI size: the same weights (a
released-layout ``.pt`` that both read, gates non-zero), the
``ego4d_val`` clips and the fixture GPT-2 vocabulary.

``eval_narrator`` greedy (``--top-k 1``) gives the JAX CLI's captions,
references and NLG scores and its teacher-forced perplexity within 1e-4
relative; beam search and group beam search give its captions; every
``--decoding`` mode runs. ``main_infer_narrator``'s and
``demo_narrator``'s beam modes run, their deterministic ones holding
the JAX CLIs' outputs. Sampled draws (torch's generator against
``jax.random``) and beam sample over these near-uniform random logits
(where fp32 rounding moves a draw) are held by their shape and
finiteness here; ``tests/test_torch_beam.py`` holds beam sample's draws
on the same numpy seed by equality on peaked logits."""

import pickle

import numpy as np
import pytest
import torch

from lavila_tpu.data.video import encode_test_video
from lavila_tpu_torch.cli import demo_narrator, demo_narrator_3rd_person
from lavila_tpu_torch.cli import eval_narrator as port_eval
from lavila_tpu_torch.cli import main_infer_narrator
from test_eval_narrator_cli import ego4d_val, gpt2_vocab_dir  # noqa: F401
from test_torch_narrator_cli import _jax_params, _reference_checkpoint

torch.set_num_threads(1)

MINI = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
NLG = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, params = _jax_params(seed=7)
    path = tmp_path_factory.mktemp("ckpt") / "vclm_mini.pt"
    _reference_checkpoint(params, path)
    return str(path)


def _eval_argv(root, meta, ckpt, *extra):
    return ["--dataset", "ego4d", "--root", root, "--metadata", meta,
            "--model", MINI, "--clip-length", "4", "--batch-size", "3",
            "--workers", "1", "--eval-freq", "1", "--max-text-length", "10",
            "--checkpoint", ckpt, *extra]


def _run_eval(module, argv, monkeypatch):
    """``module``'s ``main`` on ``argv``, its NLG inputs caught: (scores,
    hypotheses, references)."""
    seen = {}
    orig = module.nlg_scores

    def spy(hyps, refs):
        seen.update(hyps=list(hyps), refs=list(refs))
        return orig(hyps, refs)

    monkeypatch.setattr(module, "nlg_scores", spy)
    out = module.main(module.get_args_parser().parse_args(argv))
    return out, seen["hyps"], seen["refs"]


@pytest.mark.parametrize("decoding,extra", [
    ("sample", ["--top-k", "1"]),
    ("beam", ["--num-beams", "3", "--num-return-sequences", "2"]),
    ("group_beam", ["--num-beams", "4", "--num-beam-groups", "2"]),
])
def test_eval_cli_matches_jax_cli(ego4d_val, gpt2_vocab_dir,  # noqa: F811
                                  checkpoint, monkeypatch, decoding, extra):
    """Greedy sampling, beam search and group beam search: the JAX CLI's
    hypotheses, references and NLG scores; teacher-forced perplexity
    within 1e-4 relative. Both command lines carry ``--early-stop`` and
    ``--sparse-sample``, which both CLIs take and neither reads."""
    import cli.eval_narrator as jax_eval
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", gpt2_vocab_dir)
    root, meta = ego4d_val
    argv = _eval_argv(root, meta, checkpoint, "--decoding", decoding,
                      "--early-stop", "--sparse-sample", *extra)
    want, want_hyps, want_refs = _run_eval(jax_eval, argv, monkeypatch)
    got, hyps, refs = _run_eval(port_eval, argv + ["--device", "cpu"],
                                monkeypatch)
    nrs = 2 if "--num-return-sequences" in extra else 1
    assert len(hyps) == len(refs) == 4 * nrs
    assert hyps == want_hyps and refs == want_refs
    assert got.keys() == want.keys() == {*NLG, "teacher_ppl"}
    for k in NLG:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert got["teacher_ppl"] == pytest.approx(want["teacher_ppl"],
                                               rel=1e-4)


@pytest.mark.parametrize("decoding", ["sample", "beam_sample"])
def test_eval_cli_sampled_modes_run(ego4d_val, gpt2_vocab_dir,  # noqa: F811
                                    checkpoint, monkeypatch, tmp_path,
                                    decoding):
    """The sampled modes at the CLI's defaults (temperature 0.7, top-p
    0.95): two candidates a clip, each scored against the clip's
    references; the NLG scores and a finite perplexity in the JSON."""
    import json
    monkeypatch.setenv("LAVILA_TOKENIZER_DIR", gpt2_vocab_dir)
    root, meta = ego4d_val
    out_json = tmp_path / "nlg.json"
    out, hyps, refs = _run_eval(port_eval, _eval_argv(
        root, meta, checkpoint, "--decoding", decoding,
        "--num-return-sequences", "2", "--device", "cpu", "--output-json",
        str(out_json)), monkeypatch)
    assert len(hyps) == len(refs) == 8
    assert refs[0] == refs[1] == ["the narration 0"]
    assert np.isfinite(out["teacher_ppl"]) and out["teacher_ppl"] > 1
    assert all(0.0 <= out[k] <= 10.0 for k in NLG)
    assert json.loads(out_json.read_text()) == out


def test_eval_cli_refuses_uneven_groups(ego4d_val, checkpoint):  # noqa: F811
    root, meta = ego4d_val
    args = port_eval.get_args_parser().parse_args(_eval_argv(
        root, meta, checkpoint, "--decoding", "group_beam", "--num-beams",
        "4", "--num-beam-groups", "3", "--device", "cpu"))
    with pytest.raises(SystemExit, match="num-beam-groups"):
        port_eval.main(args)


def _infer_argv(out, ckpt, *extra):
    return ["--dataset", "synthetic", "--model", MINI, "--clip-length", "4",
            "--batch-size", "3", "--workers", "2", "--max-samples", "5",
            "--num-return-sequences", "2", "--max-text-length", "10",
            "--checkpoint", ckpt, "--output-dir", str(out), *extra]


@pytest.mark.parametrize("decoding,exact", [("group_beam", True),
                                            ("beam_sample", False)])
def test_infer_cli_beams(checkpoint, tmp_path, decoding, exact):
    """``main_infer_narrator --decoding group_beam`` writes the JAX CLI's
    records (captions as raw ids, the beams' joint scores within 1e-4);
    ``beam_sample`` writes well-formed ones."""
    import cli.main_infer_narrator as jax_cli
    flags = ["--decoding", decoding, "--num-beams", "4",
             "--num-beam-groups", "2"]
    main_infer_narrator.main(main_infer_narrator.get_args_parser().parse_args(
        _infer_argv(tmp_path / "port", checkpoint, *flags, "--device",
                    "cpu")))
    got = pickle.loads((tmp_path / "port" / "total.pkl").read_bytes())
    assert len(got) == 5
    assert all(len(r[3]) == len(r[4]) == 2 and np.isfinite(r[4]).all()
               for r in got)
    if not exact:
        return
    jax_cli.main(jax_cli.get_args_parser().parse_args(
        _infer_argv(tmp_path / "jax", checkpoint, *flags)))
    want = pickle.loads((tmp_path / "jax" / "total.pkl").read_bytes())
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        np.testing.assert_allclose(g[4], w[4], rtol=1e-4, atol=1e-4)


def test_infer_cli_refuses_uneven_groups(checkpoint, tmp_path):
    args = main_infer_narrator.get_args_parser().parse_args(_infer_argv(
        tmp_path, checkpoint, "--decoding", "group_beam", "--num-beams",
        "5", "--device", "cpu"))
    with pytest.raises(SystemExit, match="num-beam-groups"):
        main_infer_narrator.main(args)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "clip.mp4"
    encode_test_video(str(path), 96, 96, 30, 60)
    return str(path)


@pytest.mark.parametrize("decoding,exact", [("beam", True),
                                            ("group_beam", True),
                                            ("beam_sample", False)])
def test_demo_beams(checkpoint, video, capsys, decoding, exact):
    """The demo's beam modes (5 beams, or 6 in 3 groups) on one clip:
    the JAX demo's ids for the deterministic ones, from a command line
    with ``--third-person``, which both demos take and neither reads."""
    argv = ["--video-path", video, "--checkpoint", checkpoint,
            "--decoding", decoding, "--num-return-sequences", "2",
            "--third-person"]
    ids = demo_narrator.main(demo_narrator.get_args_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert ids.shape == (2, 77) and (ids[:, 0] == 50256).all()
    assert "[1] (score" in capsys.readouterr().out
    if exact:
        import cli.demo_narrator as jax_demo
        want = jax_demo.main(jax_demo.get_args_parser().parse_args(argv))
        np.testing.assert_array_equal(ids, np.asarray(want))


def test_demo_3rd_person(checkpoint, video, capsys):
    """The third-person demo is the demo with the JAX script's default
    model and ``third_person`` set, and captions a clip from a
    checkpoint."""
    args = demo_narrator_3rd_person.get_args().parse_args(
        ["--video-path", video, "--device", "cpu",
         "--num-return-sequences", "2", "--checkpoint", checkpoint])
    assert args.model == MINI and args.third_person
    ids = demo_narrator_3rd_person.main(args)
    assert ids.shape == (2, 77)
    assert "image tokens: (1, 16, 64)" in capsys.readouterr().out
