"""The narrator's weight bridge and entry points on the CPU, at MINI size.

A released narrator checkpoint is stood in for by one these tests write
in the reference layout (HF Conv1D weights ``(in, out)``, the tied
``lm_head``, the attention-mask buffers, the CoCa norms' ``gamma`` and
zero ``beta``) from the JAX MINI weights with non-zero gates. The JAX
package reads it with ``import_vclm``; the port with
``narrator_state_dict``; both must give the same logits. Then the port's
inference CLI on that checkpoint, greedy (``--top-k 1``), must write the
JAX CLI's records."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.models import build_model as jax_build_model
from lavila_tpu.models import import_torch as imp
from lavila_tpu_torch.cli import demo_narrator, main_infer_narrator
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import (_CONV1D, count_layers,
                                             load_reference_checkpoint,
                                             narrator_state_dict,
                                             state_dict_from_jax)

torch.set_num_threads(1)

MINI = "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"


def _jax_params(seed=0):
    jm = jax_build_model(MINI, num_frames=4, gated_xattn=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 4, 64, 64, 3)),
        jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(seed + 1)
    for blk in params["text_decoder"].values():
        if "alpha_cattn" in blk:
            blk["alpha_cattn"] = np.float32(rng.uniform(0.3, 0.9))
            blk["alpha_dense"] = np.float32(rng.uniform(0.3, 0.9))
    return jm, params


def _reference_checkpoint(params, path):
    """The JAX params as a released narrator ``.pt`` would hold them."""
    sd = state_dict_from_jax(params)
    ref = {}
    for k, v in sd.items():
        ref[k] = v.T.contiguous() if _CONV1D.fullmatch(k) else v
        if k.endswith(".gamma"):
            ref[k.removesuffix("gamma") + "beta"] = torch.zeros_like(v)
    ref["text_decoder.lm_head.weight"] = sd[
        "text_decoder.transformer.wte.weight"]
    n = sd["text_decoder.transformer.wpe.weight"].shape[0]
    for i in range(count_layers(sd, "text_decoder.transformer.h.")):
        pre = f"text_decoder.transformer.h.{i}"
        ref[f"{pre}.attn.bias"] = torch.ones(n, n).tril()[None, None]
        ref[f"{pre}.attn.masked_bias"] = torch.tensor(-1e4)
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()},
                "args": None}, path)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jm, params = _jax_params()
    path = tmp_path_factory.mktemp("ckpt") / "vclm_mini.pt"
    _reference_checkpoint(params, path)
    return jm, params, str(path)


def test_checkpoint_is_the_reference_layout(checkpoint):
    """JAX's own importer reads the written checkpoint back to the same
    params (it leaves the buffers the port also drops): the layout is the
    one it expects."""
    _, params, path = checkpoint
    sd = imp.load_torch_state_dict(path)
    got = imp.import_vclm(sd, count_layers(sd, "visual.blocks."),
                          count_layers(sd, "text_decoder.transformer.h."))
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(params))
    assert len(dict(flat(got))) == len(want)
    for key, leaf in flat(got):
        np.testing.assert_array_equal(np.asarray(leaf), want[key], str(key))


def test_weight_bridge_logits_match_jax(checkpoint):
    """JAX params → port, and the ``.pt`` → port: the same teacher-forced
    logits as JAX. atol 1e-4."""
    jm, params, path = checkpoint
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    text = rng.integers(1, 50257, (2, 6)).astype(np.int32)
    want = jm.apply({"params": params}, jnp.asarray(frames),
                    jnp.asarray(text))["logits"]
    from_jax = build_model(MINI, device="cpu", gated_xattn=True)
    from_jax.load_state_dict(state_dict_from_jax(params), strict=True)
    from_pt = build_model(MINI, device="cpu", gated_xattn=True)
    from_pt.load_state_dict(narrator_state_dict(
        load_reference_checkpoint(path, num_frames=4)), strict=True)
    for model in (from_jax, from_pt):
        with torch.no_grad():
            got = model(torch.from_numpy(frames),
                        torch.from_numpy(text).long())["logits"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_nonzero_coca_beta_raises():
    sd = {"img_attn_pool.norm.gamma": torch.ones(4),
          "img_attn_pool.norm.beta": torch.full((4,), 0.5)}
    with pytest.raises(ValueError, match="beta"):
        narrator_state_dict(sd)


def _argv(out, ckpt, *extra):
    return ["--dataset", "synthetic", "--model", MINI, "--clip-length", "4",
            "--batch-size", "3", "--workers", "2", "--max-samples", "5",
            "--num-return-sequences", "2", "--max-text-length", "10",
            "--top-k", "1", "--checkpoint", ckpt, "--output-dir", str(out),
            *extra]


def test_infer_cli_matches_jax_cli(checkpoint, tmp_path):
    """The port's CLI on the synthetic dataset, --device cpu, greedy: the
    JAX CLI's records (uid, times, captions as raw ids) in cache.0.pkl
    and total.pkl, perplexities within 1e-4 relative. Both command lines
    carry ``--early-stop``, which both CLIs take and neither reads."""
    import cli.main_infer_narrator as jax_cli
    _, _, ckpt = checkpoint
    jax_cli.main(jax_cli.get_args_parser().parse_args(
        _argv(tmp_path / "jax", ckpt, "--early-stop")))
    main_infer_narrator.main(main_infer_narrator.get_args_parser().parse_args(
        _argv(tmp_path / "port", ckpt, "--early-stop", "--device", "cpu")))
    for name in ("cache.0.pkl", "total.pkl"):
        want = pickle.loads((tmp_path / "jax" / name).read_bytes())
        got = pickle.loads((tmp_path / "port" / name).read_bytes())
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g[:4] == w[:4]
            assert all(len(c.split()) <= 9 for c in g[3])
            np.testing.assert_allclose(g[4], w[4], rtol=1e-4)


def test_cli_defaults_on_cuda_name_the_way_out():
    """The CLIs' default narrator (MINI, heads 16 wide) cannot decode on
    the card: the check names --device cpu and a GPT-2 narrator; the
    GPT-2 narrators and the CPU pass."""
    args = main_infer_narrator.get_args_parser().parse_args([])
    assert args.model == "VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI"
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="--device cpu.*GPT2_XL"):
        main_infer_narrator.check_decode_device(args.model, 16, cuda)
    main_infer_narrator.check_decode_device(args.model, 16,
                                            torch.device("cpu"))
    main_infer_narrator.check_decode_device(
        "VCLM_OPENAI_TIMESFORMER_BASE_GPT2_XL", 1600 // 25, cuda)


def test_demo_captions_a_clip(tmp_path, capsys):
    from lavila_tpu.data.video import encode_test_video
    video = tmp_path / "clip.mp4"
    encode_test_video(str(video), 96, 96, 30, 60)
    ids = demo_narrator.main(demo_narrator.get_args_parser().parse_args(
        ["--video-path", str(video), "--device", "cpu",
         "--num-return-sequences", "3"]))
    assert ids.shape == (3, 77) and (ids[:, 0] == 50256).all()
    out = capsys.readouterr().out
    assert "image tokens: (1, 16, 64)" in out and "[2] (score" in out
