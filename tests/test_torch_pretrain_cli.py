"""The port's pretraining CLI on the CPU: MINI for 2 steps on the
synthetic dataset writes a checkpoint that the port's zero-shot loader
serves, resumes from its output directory, trains under each remat
policy and with the time gate, trains with --contrastive-use-vissl,
holds --mesh-model and --mesh-data to the world size (the SSL options,
the probe and --wandb
are tested in tests/test_torch_ssl.py); a DistilBERT dual encoder at MINI
size trains through it with its masks."""

import json
import math

import pytest
import torch

from lavila_tpu.config import parse_config
from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli import main_pretrain as cli
from test_torch_eval_zeroshot_cli import bert_mini  # noqa: F401  (fixture)
from test_torch_eval_zeroshot_cli import gated_mini  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _cfg(out, *extra):
    return parse_config(cli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--model", "CLIP_OPENAI_TIMESFORMER_MINI",
        "--steps", "2", "--batch-size", "4", "--workers", "2",
        "--device", "cpu", "--output-dir", str(out), *extra])


def test_cli_trains_saves_and_serves(tmp_path, capsys):
    state = cli.main(_cfg(tmp_path, "--print-freq", "1"))
    assert state.step == 2
    printed = capsys.readouterr().out
    assert "compute dtype bfloat16" in printed and "=> done" in printed
    files = {p.name for p in tmp_path.iterdir()}
    assert {"checkpoint_0000.pt", "checkpoint_0000.pt.json",
            "checkpoint_latest.pt", "checkpoint_latest.pt.json",
            "log.txt"} <= files
    log = json.loads((tmp_path / "log.txt").read_text().splitlines()[-1])
    assert log["epoch"] == 0 and log["train_loss"] > 0
    meta = json.loads((tmp_path / "checkpoint_latest.pt.json").read_text())
    assert meta["config"]["model"] == "CLIP_OPENAI_TIMESFORMER_MINI"
    ckpt = torch.load(tmp_path / "checkpoint_latest.pt", weights_only=True)
    assert set(ckpt) == {"state_dict", "optimizer", "scheduler", "step"}
    assert ckpt["step"] == 2

    args = ez.get_args_parser().parse_args(
        ["--checkpoint", str(tmp_path / "checkpoint_latest.pt"),
         "--device", "cpu"])
    model, _, name = ez.load_model_from_checkpoint(args)
    assert name == "CLIP_OPENAI_TIMESFORMER_MINI" and not model.training
    for k, p in model.named_parameters():
        assert torch.equal(p, state.params[k]), k
    with torch.inference_mode():
        emb = model.encode_image(torch.randn(2, 4, 64, 64, 3))
    assert emb.shape == (2, 256) and torch.isfinite(emb).all()


def test_cli_resumes_from_output_dir(tmp_path):
    """A checkpoint in --output-dir wins over --resume and starts the
    next epoch from the saved step."""
    cli.main(_cfg(tmp_path, "--steps", "1", "--epochs", "2"))
    state = cli.main(_cfg(tmp_path, "--steps", "1", "--epochs", "2",
                          "--resume", str(tmp_path / "nowhere.pt"),
                          "--disable-amp"))
    assert state.step == 2
    assert not state.has_copy  # --disable-amp: fp32 throughout
    meta = json.loads((tmp_path / "checkpoint_latest.pt.json").read_text())
    assert meta["epoch"] == 1


def test_cli_use_checkpoint_trains_with_remat(tmp_path):
    """--use-checkpoint builds the video tower with remat (policy full)
    and trains through it."""
    state = cli.main(_cfg(tmp_path, "--use-checkpoint", "--disable-amp"))
    assert state.step == 2 and state.model.visual.remat
    meta = json.loads((tmp_path / "checkpoint_latest.pt.json").read_text())
    assert meta["config"]["use_checkpoint"] is True


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir traces steps 5-10, as the JAX CLI does, with the
    port's spans in the trace; recording is off again after it."""
    from lavila_tpu_torch.utils import tracing
    cli.main(_cfg(tmp_path / "run", "--steps", "11", "--batch-size", "2",
                  "--profile-dir", str(tmp_path / "prof")))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    for name in ("train.step", "train.forward", "train.backward",
                 "train.update", "encode.image"):
        assert names.count(name) == 6, name  # steps 5 to 10
    assert not tracing.enabled()


def _fresh_params(cfg):
    """The parameters the CLI starts from (its seeded init)."""
    from lavila_tpu_torch.config import model_kwargs_from_config
    from lavila_tpu_torch.models import build_model
    kw = model_kwargs_from_config(cfg)
    kw.pop("timesformer_gated_xattn")
    kw.pop("remat_policy")
    model = build_model(cfg.model, device="cpu", train=True,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        **kw)
    return dict(model.named_parameters())


@pytest.mark.parametrize("flags", [
    ["--freeze-temperature"],
    ["--timesformer-freeze-space"],
    ["--update-freq", "2", "--steps", "3"],
])
def test_cli_freeze_and_accumulation_as_the_jax_cli(tmp_path, flags):
    """The options the JAX CLI implements with optax: a frozen parameter
    (``freeze_by_predicate``: logit_scale; the video tower but its
    temporal branch) keeps its initial value and every other one moves;
    ``--update-freq 2`` (``optax.MultiSteps``) makes one update of two
    micro-steps, so three steps make one update and leave one micro-step
    in the running mean, and the schedule counts updates."""
    from lavila_tpu.train import freeze as JF
    cfg = _cfg(tmp_path, *flags)
    state = cli.main(cfg)
    frozen = {"--freeze-temperature": JF.logit_scale_only,
              "--timesformer-freeze-space": JF.spatial_parts}.get(
                  flags[0], lambda n: False)
    updates = 1 if "--update-freq" in flags else 2
    moved = 0
    for name, p in _fresh_params(cfg).items():
        same = torch.equal(p, state.params[name])
        # after one update the zero-init time attention's proj has kept
        # every gradient before it at zero: two updates move all
        assert same if frozen(name) else (not same or updates == 1), name
        moved += not same
    assert moved > 0
    assert state.optimizer.scheduler.last_epoch == updates
    if "--update-freq" in flags:
        assert state.step == 3 and state.optimizer.micro_step == 1
        ckpt = torch.load(tmp_path / "checkpoint_latest.pt",
                          weights_only=True)
        assert ckpt["accumulate"]["micro_step"] == 1


@pytest.mark.parametrize("flags,error,match", [
    (["--contrastive-use-vissl"], None, None),
    (["--mesh-model", "2"], ValueError,
     "--mesh-model 2: the 1 process"),
    (["--mesh-data", "4"], ValueError, "--mesh-data 4 does not match"),
], ids=["vissl_trains", "mesh_model_2", "mesh_data_4"])
def test_cli_options_not_ported_raise(tmp_path, monkeypatch, flags, error,
                                      match):
    """The JAX CLI's multi-device options at a world of one:
    ``--contrastive-use-vissl`` trains, on the local loss; ``--mesh-model
    2`` (tensor parallelism, which runs over 2 ranks in
    tests/test_torch_tensor_parallel.py) and ``--mesh-data`` other than
    -1 or the world size (1 here) raise ``ValueError``, as
    ``create_mesh`` does for a device count the axes do not divide."""
    if error is not None:
        with pytest.raises(error, match=match):
            cli.main(_cfg(tmp_path, *flags))
        return
    made = []
    real = cli.make_clip_train_step
    monkeypatch.setattr(cli, "make_clip_train_step",
                        lambda **kw: made.append(kw) or real(**kw))
    state = cli.main(_cfg(tmp_path, *flags))
    assert state.step == 2 and made[0]["local_loss"] is True
    log = json.loads((tmp_path / "log.txt").read_text().splitlines()[-1])
    assert math.isfinite(log["train_loss"])


@pytest.mark.parametrize("policy", ["dots", "save_attn", "dots_attn"])
def test_cli_remat_policy_trains_as_no_remat(tmp_path, policy):
    """``--use-checkpoint --remat-policy`` (the JAX CLI's options) reaches
    the video tower, and training under it gives the masters of a run
    without remat bit for bit (a policy only chooses what the recompute
    keeps)."""
    state = cli.main(_cfg(tmp_path / policy, "--use-checkpoint",
                          "--remat-policy", policy))
    assert state.model.visual.remat
    assert state.model.visual.remat_policy == policy
    plain = cli.main(_cfg(tmp_path / "none"))
    for name, p in plain.params.items():
        assert torch.equal(state.params[name], p), name


def test_cli_timesformer_gated_xattn_trains_and_serves(tmp_path,
                                                      gated_mini):
    """``--timesformer-gated-xattn`` builds the time gate (a TimeSformer
    dual encoder's; the MINI one of the zoo takes the flag and builds
    none, as the JAX MINI); the checkpoint holds each block's
    ``alpha_timeattn`` and the zero-shot loader serves it strict."""
    state = cli.main(_cfg(tmp_path, "--model", gated_mini,
                          "--timesformer-gated-xattn"))
    gates = [f"visual.blocks.{i}.alpha_timeattn" for i in range(2)]
    assert all(g in state.params for g in gates)
    ckpt = tmp_path / "checkpoint_latest.pt"
    saved = torch.load(ckpt, weights_only=True)["state_dict"]
    assert all(saved[g].shape == () for g in gates)
    args = ez.get_args_parser().parse_args(
        ["--checkpoint", str(ckpt), "--device", "cpu"])
    model, _, _ = ez.load_model_from_checkpoint(args)
    assert model.visual.blocks[0].alpha_timeattn is not None
    plain = cli.main(_cfg(tmp_path / "mini", "--timesformer-gated-xattn"))
    assert not any(k.endswith("alpha_timeattn") for k in plain.params)


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = parse_config(cli.TorchPretrainConfig, [
        "--dataset", "synthetic", "--output-dir", str(tmp_path)])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(cfg)


def _spy_masks(monkeypatch):
    """The ``mask`` each ``VideoCLIPHF`` forward receives."""
    from lavila_tpu_torch.models.dual_encoder import VideoCLIPHF
    seen, forward = [], VideoCLIPHF.forward

    def spy(self, image, text, mask=None, **kw):
        seen.append(mask)
        return forward(self, image, text, mask, **kw)
    monkeypatch.setattr(VideoCLIPHF, "forward", spy)
    return seen


def test_cli_trains_a_distilbert_model(tmp_path, bert_mini, monkeypatch):
    """A DistilBERT dual encoder (MINI size, fixture vocabulary) trains
    through the CLI, each step's forward given the batch's mask, and the
    checkpoint serves."""
    seen = _spy_masks(monkeypatch)
    state = cli.main(_cfg(tmp_path / "run", "--model", bert_mini))
    assert state.step == 2 and len(seen) == 2
    assert all(m is not None and m.shape == (4, 77)
               and m.dtype == torch.float32 for m in seen)
    assert all(bool((m[:, 0] == 1).all()) for m in seen)  # [CLS] kept
    log = json.loads((tmp_path / "run" / "log.txt").read_text()
                     .splitlines()[-1])
    assert log["train_loss"] > 0
    args = ez.get_args_parser().parse_args(
        ["--checkpoint", str(tmp_path / "run" / "checkpoint_latest.pt"),
         "--device", "cpu"])
    model, tokenizer, name = ez.load_model_from_checkpoint(args)
    assert name == bert_mini
    ids, mask = tokenizer(["a synthetic clip 7"])
    with torch.inference_mode():
        emb = model.encode_text(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    assert emb.shape == (1, 256) and torch.isfinite(emb).all()
