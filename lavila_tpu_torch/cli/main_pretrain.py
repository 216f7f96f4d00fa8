"""Dual-encoder pretraining with the PyTorch port, on one device.

Counterpart of ``cli/main_pretrain.py`` with the same flags
(``lavila_tpu_torch.config.PretrainConfig``) plus ``--device`` (default
``cuda``; with ``cuda`` and no card it raises). Data loading,
transforms and the tokenizer are the port's copies of the framework-free
modules of ``lavila_tpu``; each host batch is staged one step ahead by
``device_prefetch`` into pinned memory and copied without blocking. The
step is ``lavila_tpu_torch.train.step`` (bf16 compute on fp32 masters,
``--disable-amp`` for fp32 throughout; ``--use-checkpoint`` recomputes
each video block in the backward, remat policy ``full``; a DistilBERT
model's text mask is placed beside its ids, as the JAX CLI does);
checkpoints
are torch files with
the run config in a JSON sidecar (``utils/checkpoints.py``), one per
epoch, auto-resumed from ``--output-dir``. ``--profile-dir`` writes a
``torch.profiler`` trace over steps 5-10.

Run without data: ``python -m lavila_tpu_torch.cli.main_pretrain
--dataset synthetic --model CLIP_OPENAI_TIMESFORMER_MINI --steps 2
--batch-size 4 --device cpu --output-dir /tmp/run``.

Options of the JAX CLI that are not ported yet raise, each naming its
ROADMAP queue 1 subject; none is silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import os.path as osp
import sys

import numpy as np
import torch

from lavila_tpu_torch.cli.eval_zeroshot import crop_shape, resolve_device
from lavila_tpu_torch.config import (PretrainConfig, model_kwargs_from_config,
                                     parse_config)
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import DatasetConfig, get_dataset
from lavila_tpu_torch.data.loader import DataLoader, device_prefetch
from lavila_tpu_torch.data.tokenizers import generate_tokenizer
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.train.freeze import (build_freeze_predicate,
                                           freeze_by_predicate)
from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
from lavila_tpu_torch.train.step import TrainState, make_clip_train_step
from lavila_tpu_torch.utils.checkpoints import (CheckpointManager,
                                                resolve_resume)
from lavila_tpu_torch.utils.meters import AverageMeter, ProgressMeter, Timer
from lavila_tpu_torch.utils.random import random_seed


@dataclasses.dataclass
class TorchPretrainConfig(PretrainConfig):
    device: str = "cuda"


# option → (is it set, the ROADMAP queue 1 subject that ports it)
_NOT_PORTED = (
    (lambda c: c.model.startswith("VCLM"),
     "--model VCLM_* (the narrator's caption loss and step)",
     "the narrator's training"),
    (lambda c: c.metadata_aux is not None, "--metadata-aux (the SSL loss)",
     "the SSL loss"),
    (lambda c: c.contrastive_use_vissl, "--contrastive-use-vissl",
     "multi-GPU"),
    (lambda c: c.mesh_model > 1, "--mesh-model > 1", "multi-GPU"),
    (lambda c: c.mesh_data not in (-1, 1), "--mesh-data > 1", "multi-GPU"),
    (lambda c: c.use_checkpoint and c.remat_policy != "full",
     "--remat-policy other than full (remat)",
     "the remat policies"),
    (lambda c: any([c.freeze_visual_vclm, c.freeze_visual_vclm_temporal,
                    c.freeze_lm_vclm]),
     "the VCLM --freeze-* flags (the narrator's training)",
     "the narrator's training"),
    (lambda c: c.freeze_pseudo_temperature,
     "--freeze-pseudo-temperature (the SSL loss)", "the SSL loss"),
    (lambda c: c.val_metadata is not None,
     "--val-metadata (the in-training probe)",
     "the in-training probe"),
    (lambda c: c.wandb, "--wandb", "--wandb"),
    (lambda c: c.timesformer_gated_xattn, "--timesformer-gated-xattn",
     "timesformer_gated_xattn"),
)


def check_ported(cfg) -> None:
    for is_set, what, subject in _NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{what} is not ported to lavila_tpu_torch yet: ROADMAP "
                f"queue 1: {subject}")


def build_dataset(cfg, tokenizer, train_transform):
    dcfg = DatasetConfig(
        dataset=cfg.dataset, root=cfg.root, metadata=cfg.metadata,
        clip_length=cfg.clip_length, clip_stride=cfg.clip_stride,
        sparse_sample=cfg.sparse_sample,
        narration_selection=cfg.narration_selection)
    return get_dataset(dcfg, train_transform, tokenizer, is_training=True,
                       seed=cfg.seed)


# the batch entries a train step reads, and their dtypes on the device
BATCH_DTYPES = {"frames": torch.float32, "text": torch.long,
                "relevancy": torch.float32, "mask": torch.float32}


def make_place(device: torch.device, keys=("frames", "text")):
    """Host batch → device tensors of ``keys``, and of ``mask`` where the
    batch has one (the WordPiece tokenizer's, for the DistilBERT towers):
    pinned memory and a non-blocking copy on CUDA, so the copy of batch
    N+1 overlaps step N."""
    def place(batch):
        out = {}
        for key in (*keys, *(("mask",) if "mask" in batch else ())):
            t = torch.from_numpy(np.asarray(batch[key])).to(
                BATCH_DTYPES[key])
            if device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
        return out
    return place


def main(cfg: TorchPretrainConfig) -> TrainState:
    check_ported(cfg)
    device = resolve_device(cfg.device)
    random_seed(cfg.seed, 0)
    dtype = torch.float32 if cfg.disable_amp else torch.bfloat16
    print(f"=> building model {cfg.model} (compute dtype "
          f"{str(dtype).removeprefix('torch.')})")
    kw = model_kwargs_from_config(cfg)
    kw.pop("timesformer_gated_xattn")  # raises above when set
    kw.pop("remat_policy")  # only 'full' passes check_ported
    model = build_model(cfg.model, device=device, train=True,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        **kw)
    tokenizer = generate_tokenizer(cfg.model)

    mean, std = T.normalization_for_model(cfg.model)
    train_transform = T.TrainTransform(crop_shape(cfg.model)[0], mean, std)
    dataset = build_dataset(cfg, tokenizer, train_transform)
    loader = DataLoader(dataset, cfg.batch_size, shuffle=True,
                        num_workers=cfg.workers, drop_last=True,
                        seed=cfg.seed)
    iters_per_epoch = max(len(loader) // cfg.update_freq, 1)
    print(f"=> dataset {cfg.dataset}: {len(dataset)} samples, "
          f"{iters_per_epoch} optim iters/epoch")

    schedule = (cfg.lr if cfg.fix_lr else cosine_schedule(
        cfg.lr, cfg.lr_end, cfg.epochs, iters_per_epoch,
        warmup_epochs=cfg.warmup_epochs, start_warmup_lr=cfg.lr_start))
    clip = (None if cfg.clip_grad_value is None
            else float(cfg.clip_grad_value))
    # --freeze-temperature and --timesformer-freeze-space leave their
    # parameters out of the optimizer (train/freeze.py)
    frozen = build_freeze_predicate(
        freeze_temperature=cfg.freeze_temperature,
        timesformer_freeze_space=cfg.timesformer_freeze_space)
    state = TrainState.create(
        model, lambda params: make_optimizer(
            freeze_by_predicate(params, frozen), schedule,
            weight_decay=cfg.wd, betas=cfg.betas,
            eps=cfg.eps, clip_grad_value=clip,
            clip_grad_type=cfg.clip_grad_type,
            update_freq=cfg.update_freq),
        dtype=dtype,
        generator=torch.Generator(device).manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in state.params.values())
    print(f"=> {n_params/1e6:.1f}M params")

    mgr = CheckpointManager(cfg.output_dir)
    start_epoch = cfg.start_epoch
    best_metric = float("-inf")
    resume = resolve_resume(cfg.output_dir, cfg.resume or None)
    if resume:
        print(f"=> resuming from {resume}")
        tree, meta = mgr.restore(resume, map_location=device)
        state.load_state_dict(tree)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_metric = float(meta.get("metrics", {}).get(
            "best_metric", float("-inf")))

    step_fn = make_clip_train_step(norm_embed=cfg.norm_embed)
    metric_names = ["loss", "clip_loss", "clip_acc"]
    place = make_place(device)
    os.makedirs(cfg.output_dir, exist_ok=True)

    total_steps = 0
    profiler = None
    for epoch in range(start_epoch, cfg.epochs):
        loader.set_epoch(epoch)
        meters = {k: AverageMeter(k, ":.4f") for k in metric_names}
        batch_time = AverageMeter("time", ":.3f")
        data_time = AverageMeter("data", ":.3f")
        mem = AverageMeter("mem(GB)", ":.1f")  # device memory in use
        progress = ProgressMeter(
            len(loader),
            [batch_time, data_time, mem] + list(meters.values()),
            prefix=f"Epoch [{epoch}]")
        timer = Timer()
        for it, batch in enumerate(device_prefetch(loader, place)):
            data_time.update(timer.lap())
            if cfg.profile_dir and total_steps == 5:
                profiler = _start_profiler(device)
            state, metrics = step_fn(state, batch)
            if profiler is not None and total_steps == 10:
                _stop_profiler(profiler, cfg.profile_dir)
                profiler = None
            if it % cfg.print_freq == 0:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    print(f"loss is {loss}, aborting")
                    sys.exit(1)
                for k in metric_names:
                    meters[k].update(float(metrics[k]), cfg.batch_size)
                if device.type == "cuda":
                    mem.update(torch.cuda.memory_allocated(device) / 1e9)
                batch_time.update(timer.lap())
                progress.display(it)
            else:
                batch_time.update(timer.lap())
            total_steps += 1
            if cfg.steps is not None and total_steps >= cfg.steps:
                break
        if profiler is not None:  # fewer than 10 steps in all
            _stop_profiler(profiler, cfg.profile_dir)
            profiler = None

        mgr.save(state.state_dict(), epoch=epoch, config=cfg.asdict(),
                 metrics={"best_metric": best_metric}, is_best=False,
                 keep_epoch=(epoch + 1) % cfg.save_freq == 0)
        log = {f"train_{k}": m.avg for k, m in meters.items()}
        log["epoch"] = epoch
        with open(osp.join(cfg.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(log) + "\n")
        if cfg.steps is not None and total_steps >= cfg.steps:
            break
    print("=> done")
    return state


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"=> profiler trace written to {path}")


if __name__ == "__main__":
    main(parse_config(TorchPretrainConfig))
