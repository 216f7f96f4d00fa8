"""Run configuration: dataclasses + an argparse shim keeping the
reference's flag surface (reference: main_pretrain.py:59-148 and the
other get_args_parser()s), so existing launch commands port 1:1.

The config dict is embedded in checkpoints (checkpoint-as-config,
reference eval_zeroshot.py:75) — downstream tools rebuild the model from
``config['model']`` + kwargs without re-specifying flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class PretrainConfig:
    # data
    dataset: str = "ego4d"
    root: str = "datasets/Ego4D/video_288px"
    metadata: str = "datasets/Ego4D/ego4d_train.pkl"
    metadata_aux: Optional[str] = None     # pseudo-narration pkl(s)
    clip_length: int = 4
    clip_stride: int = 16
    sparse_sample: bool = False
    narration_selection: str = "random"
    num_hard_neg: int = 0
    # model
    model: str = "CLIP_OPENAI_TIMESFORMER_BASE"
    norm_embed: bool = False
    resume: str = ""
    load_visual_pretrained: Optional[str] = None
    project_embed_dim: int = 256
    use_cls_token: bool = False
    contrastive_use_vissl: bool = False
    gated_xattn: bool = False
    random_init_gpt2: bool = False
    timesformer_gated_xattn: bool = False
    timesformer_freeze_space: bool = False
    drop_path_rate: float = 0.0
    temperature_init: float = 0.07
    freeze_temperature: bool = False
    # SSL pseudo-pair temperature (reference main_pretrain.py:106-109 —
    # the CLI default is 0.07 even though SSLCLIPLoss's class default
    # is 0.08; the flag value is what training actually uses)
    pseudo_temperature_init: float = 0.07
    freeze_pseudo_temperature: bool = False
    freeze_lm_vclm: bool = False
    freeze_visual_vclm: bool = False
    freeze_visual_vclm_temporal: bool = False
    find_unused_parameters: bool = False
    load_temporal_fix: str = "bilinear"
    # training
    epochs: int = 5
    warmup_epochs: int = 1
    start_epoch: int = 0
    batch_size: int = 32           # per host
    temperature: float = 0.07
    lr: float = 3e-5
    fix_lr: bool = False
    lr_start: float = 1e-6
    lr_end: float = 1e-5
    clip_grad_type: str = "norm"
    clip_grad_value: Optional[float] = None
    update_freq: int = 1
    wd: float = 0.01
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    eval_freq: int = 99
    eval_in_middle_freq: int = -1
    disable_amp: bool = False       # amp == bf16 compute on TPU
    use_zero: bool = True           # ZeRO falls out of sharding; kept for parity
    use_checkpoint: bool = False    # activation checkpointing (remat)
    # remat granularity when use_checkpoint: full | dots | save_attn |
    # dots_attn (dots_attn measured best at TSF-L@336; docs/PERF.md)
    remat_policy: str = "full"
    use_half: bool = False
    # in-training zero-shot probe (reference --eval-in-middle-freq &
    # per-epoch EK-100 probe, main_pretrain.py:359-379)
    val_metadata: Optional[str] = None
    val_root: Optional[str] = None
    # multi-view in-train MIR probe (defaults match the reference's
    # single-view probe transform, main_pretrain.py:275-286; the 16-frame
    # BASELINE rows need the multi-view protocol at final-eval time)
    val_num_clips: int = 1
    val_num_crops: int = 1
    # system
    print_freq: int = 10
    workers: int = 8
    seed: int = 0
    output_dir: str = "./output"
    wandb: bool = False
    save_freq: int = 1
    profile_dir: Optional[str] = None  # torch.profiler trace output
    # TPU mesh
    mesh_data: int = -1
    mesh_model: int = 1
    steps: Optional[int] = None     # cap optimizer steps (debug/bench)

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["betas"] = list(self.betas)
        return d


def add_flags(parser: argparse.ArgumentParser, cfg) -> None:
    """Register every dataclass field as '--kebab-case' flag."""
    for f in dataclasses.fields(cfg):
        name = "--" + f.name.replace("_", "-")
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
            if default:
                parser.add_argument(
                    "--no-" + f.name.replace("_", "-"),
                    dest=f.name, action="store_false")
        elif isinstance(default, tuple):
            parser.add_argument(name, nargs=len(default), type=float,
                                default=default)
        elif default is None:
            parser.add_argument(name, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def parse_config(cls, argv=None):
    parser = argparse.ArgumentParser()
    cfg = cls()
    add_flags(parser, cfg)
    ns = parser.parse_args(argv)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in vars(ns).items() if k in fields}
    if "betas" in kwargs and isinstance(kwargs["betas"], list):
        kwargs["betas"] = tuple(kwargs["betas"])
    if "clip_grad_value" in kwargs and kwargs["clip_grad_value"] is not None:
        kwargs["clip_grad_value"] = float(kwargs["clip_grad_value"])
    if "steps" in kwargs and kwargs["steps"] is not None:
        kwargs["steps"] = int(kwargs["steps"])
    return cls(**kwargs)


def model_kwargs_from_config(cfg) -> dict:
    """kwargs forwarded to the zoo factory, mirroring the reference's
    getattr(models, args.model)(**vars-ish) call."""
    get = lambda n, d=None: getattr(cfg, n, d)  # noqa: E731
    kw = dict(
        num_frames=get("clip_length", 4),
        project_embed_dim=get("project_embed_dim", 256),
        temperature_init=get("temperature_init", 0.07),
        timesformer_gated_xattn=get("timesformer_gated_xattn", False),
        gated_xattn=get("gated_xattn", False),
        drop_path_rate=get("drop_path_rate", 0.0),
        remat=get("use_checkpoint", False),
        remat_policy=get("remat_policy", "full"),
    )
    if not str(get("model", "")).startswith("VCLM"):
        kw.pop("gated_xattn")
    else:
        kw.pop("project_embed_dim")
        kw.pop("temperature_init")
    return kw
