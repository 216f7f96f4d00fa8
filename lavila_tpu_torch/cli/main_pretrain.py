"""Pretraining with the PyTorch port: the dual encoder and, with
``--model VCLM_*``, the narrator, on one device or data-parallel over
the ranks of a process group.

Counterpart of ``cli/main_pretrain.py`` with the same flags
(``lavila_tpu_torch.config.PretrainConfig``) plus ``--device`` (default
``cuda``; with ``cuda`` and no card it raises). Data loading,
transforms and the tokenizer are the port's copies of the framework-free
modules of ``lavila_tpu``; each host batch is staged one step ahead by
``device_prefetch`` into pinned memory and copied without blocking. The
step is ``lavila_tpu_torch.train.step`` (bf16 compute on fp32 masters,
``--disable-amp`` for fp32 throughout; ``--use-checkpoint`` recomputes
each video block in the backward under ``--remat-policy``: ``full``,
``dots``, ``save_attn`` or ``dots_attn``, ``models/timesformer.py``;
``--timesformer-gated-xattn`` puts the tanh gate on the TimeSformer's
time attention; a DistilBERT
model's text mask is placed beside its ids, as the JAX CLI does);
checkpoints
are torch files with
the run config in a JSON sidecar (``utils/checkpoints.py``), one per
epoch, auto-resumed from ``--output-dir``. ``--profile-dir`` writes a
``torch.profiler`` trace over steps 5-10, with the port's spans
(``utils/tracing.py``: the step, its forward, backward and update phases)
recorded over those steps and in the trace as user annotations.

``--metadata-aux`` (comma-separated pseudo-narration metadata) trains
on the human narrations plus the narrator's, each sample marked by its
``gt_indicators``, with the two-temperature SSL loss; its pseudo
temperature starts at ``--pseudo-temperature-init``, learns unless
``--freeze-pseudo-temperature``, and is saved and resumed with the
masters. ``--val-metadata`` runs the zero-shot EK-100 MIR probe after
every epoch (and every ``--eval-in-middle-freq`` iterations), its
metrics in ``log.txt`` and ``checkpoint_best.pt`` following its
``mAP_avg``. ``--wandb`` logs to Weights & Biases where it can start.

A ``VCLM_*`` model trains the narrator (LaViLa's step 1,
``docs/TRAINING.md:31-42``): the caption step
(``make_caption_train_step``: teacher-forced cross entropy over the
GPT-2 tokenizer's ids, its padding masked out), the metrics ``loss
caption_loss caption_acc ppl``, ``--gated-xattn`` and the VCLM freeze
flags (``--freeze-lm-vclm``: GPT-2 but its cross-attention insertions;
``--freeze-visual-vclm``: the video tower but its temporal branch;
``--freeze-visual-vclm-temporal``: that branch), whose parameters get
no gradient (``TrainState``); ``--use-checkpoint`` recomputes GPT-2's
blocks too. No SSL loss (``--metadata-aux`` only adds the aux
narrations as captions) and no EK-100 probe, as in the JAX CLI; the
JAX narrators take no drop-path, so ``--drop-path-rate`` is not passed
to them either. Its ``checkpoint_*.pt`` loads in the port's
``main_infer_narrator``, ``demo_narrator`` and ``eval_narrator``.
LaViLa's recipe on the synthetic dataset (the GPT-2 vocabulary under
``$LAVILA_TOKENIZER_DIR/gpt2-xl``):
``--model VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL --gated-xattn
--freeze-lm-vclm --freeze-visual-vclm --disable-amp``.

Run without data: ``python -m lavila_tpu_torch.cli.main_pretrain
--dataset synthetic --model CLIP_OPENAI_TIMESFORMER_MINI --steps 2
--batch-size 4 --device cpu --output-dir /tmp/run``.

Data parallelism (``parallel/mesh.py``; started by
``lavila_tpu_torch.cli.launch`` or by a caller that joined a group
itself, else a world of one): ``--batch-size`` is the global batch, each
rank's loader yielding its ``batch / world`` rows of its shard
(``shard_index=rank``, as the JAX CLI's per-process loaders); the
generators are seeded ``--seed`` + rank, rank 0's weights are broadcast
after the build or the restore, the gradients are averaged over the
ranks (``train/step.py``), ``--contrastive-use-vissl`` takes the local
losses (each rank's rows of the logits only; at a world of one too),
``--mesh-data`` must be -1 or the world size over ``--mesh-model``;
rank 0 writes the checkpoints, ``log.txt`` and wandb. No option is
silently ignored.

Tensor parallelism (``--mesh-model`` M > 1, the JAX CLI's
``param_sharding_rules`` over its ``model`` axis): the world splits into
``world // M`` replicas of M consecutive ranks (``mesh.
init_model_parallel``); every rank builds the whole model from the seed,
the world's rank 0's weights are broadcast, and each rank keeps only its
slices of the wide layers (``parallel/sharding.py``: column- and
row-parallel layers on whole heads). The data axis is the replicas:
the loader's shard, the generators (drop-path, dropout) and the
gradient average follow the data rank, so the ranks of one replica
read the same rows and draw the same masks; the optimizer state stays
sharded like its parameter. A checkpoint is the whole layout, the
sharded masters and their optimizer state gathered over the model
group, so it serves in one process and resumes at any ``--mesh-model``;
a resume shards it again.
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
from lavila_tpu_torch import losses
from lavila_tpu_torch.config import (PretrainConfig, model_kwargs_from_config,
                                     parse_config)
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import (ConcatDataset, DatasetConfig,
                                            get_dataset)
from lavila_tpu_torch.data.loader import DataLoader, device_prefetch
from lavila_tpu_torch.data.tokenizers import generate_tokenizer
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.parallel import mesh, sharding
from lavila_tpu_torch.train.freeze import (build_freeze_predicate,
                                           freeze_by_predicate)
from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
from lavila_tpu_torch.train.step import (TrainState, make_caption_train_step,
                                         make_clip_train_step)
from lavila_tpu_torch.utils import tracing
from lavila_tpu_torch.utils.checkpoints import (CheckpointManager,
                                                resolve_resume)
from lavila_tpu_torch.utils.meters import AverageMeter, ProgressMeter, Timer
from lavila_tpu_torch.utils.random import random_seed
from lavila_tpu_torch.utils.tracking import init_wandb


@dataclasses.dataclass
class TorchPretrainConfig(PretrainConfig):
    device: str = "cuda"


def build_dataset(cfg, tokenizer, train_transform):
    """The human narrations' dataset; with ``--metadata-aux``, each aux
    metadata's dataset (a random narration of each clip's) after it, the
    samples marked 1 and 0 in ``gt_indicators``."""
    def dataset(metadata, narration_selection):
        dcfg = DatasetConfig(
            dataset=cfg.dataset, root=cfg.root, metadata=metadata,
            clip_length=cfg.clip_length, clip_stride=cfg.clip_stride,
            sparse_sample=cfg.sparse_sample,
            narration_selection=narration_selection)
        return get_dataset(dcfg, train_transform, tokenizer,
                           is_training=True, seed=cfg.seed)

    base = dataset(cfg.metadata, cfg.narration_selection)
    if cfg.metadata_aux is None:
        return base
    aux = [dataset(p, "random") for p in cfg.metadata_aux.split(",")]
    return ConcatDataset([base, *aux], [1] + [0] * len(aux))


# the batch entries a train step reads, and their dtypes on the device
BATCH_DTYPES = {"frames": torch.float32, "text": torch.long,
                "relevancy": torch.float32, "mask": torch.float32,
                "gt_indicators": torch.float32}


def to_device(array, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``: through pinned
    memory and a non-blocking copy on CUDA, so the copy of batch N+1
    overlaps step N."""
    t = torch.from_numpy(np.asarray(array)).to(dtype)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_place(device: torch.device, keys=("frames", "text")):
    """Host batch → device tensors of ``keys``, and of ``mask`` where the
    batch has one (the WordPiece tokenizer's, for the DistilBERT
    towers)."""
    def place(batch):
        return {key: to_device(batch[key], BATCH_DTYPES[key], device)
                for key in (*keys, *(("mask",) if "mask" in batch else ()))}
    return place


def main(cfg: TorchPretrainConfig) -> TrainState:
    mesh.check_mesh_data(cfg.mesh_data, cfg.mesh_model)
    mesh.init_model_parallel(cfg.mesh_model)
    # the data axis: the replicas (every rank at --mesh-model 1)
    world, rank = mesh.data_world(), mesh.data_rank()
    if cfg.batch_size % world:
        raise ValueError(
            f"--batch-size {cfg.batch_size} must be divisible by the "
            + (f"{world} processes of the group" if cfg.mesh_model == 1
               else f"{world} data-parallel replicas ({mesh.world()} "
               f"processes over --mesh-model {cfg.mesh_model})"))
    device = resolve_device(cfg.device)
    random_seed(cfg.seed, rank)
    is_vclm = cfg.model.startswith("VCLM")
    dtype = torch.float32 if cfg.disable_amp else torch.bfloat16
    print(f"=> building model {cfg.model} (compute dtype "
          f"{str(dtype).removeprefix('torch.')})")
    kw = model_kwargs_from_config(cfg)
    if is_vclm:  # the JAX narrators ignore it
        kw.pop("drop_path_rate")
    # the weights are drawn on the device: seconds there for the 2.4 B
    # parameters of the flagship narrator, minutes on the host
    model = build_model(cfg.model, device=device, train=True,
                        generator=torch.Generator(device).manual_seed(
                            cfg.seed), **kw)
    if mesh.model_world() > 1:
        # the same whole weights on every rank, then this rank's slices
        mesh.broadcast_tensors([p.detach() for p in model.parameters()],
                               mesh.world_group())
        sharding.shard_model(model)
    tokenizer = generate_tokenizer(cfg.model)

    mean, std = T.normalization_for_model(cfg.model)
    train_transform = T.TrainTransform(crop_shape(cfg.model)[0], mean, std)
    dataset = build_dataset(cfg, tokenizer, train_transform)
    # --batch-size is the global batch: each rank's loader yields its
    # 1/world slice of its shard
    loader = DataLoader(dataset, cfg.batch_size // world, shuffle=True,
                        num_workers=cfg.workers, drop_last=True,
                        shard_index=rank, num_shards=world, seed=cfg.seed)
    iters_per_epoch = max(len(loader) // cfg.update_freq, 1)
    print(f"=> dataset {cfg.dataset}: {len(dataset)} samples, "
          f"{iters_per_epoch} optim iters/epoch")

    schedule = (cfg.lr if cfg.fix_lr else cosine_schedule(
        cfg.lr, cfg.lr_end, cfg.epochs, iters_per_epoch,
        warmup_epochs=cfg.warmup_epochs, start_warmup_lr=cfg.lr_start))
    clip = (None if cfg.clip_grad_value is None
            else float(cfg.clip_grad_value))
    # the freeze flags leave their parameters out of the optimizer
    # (train/freeze.py)
    frozen = build_freeze_predicate(
        freeze_temperature=cfg.freeze_temperature,
        timesformer_freeze_space=cfg.timesformer_freeze_space,
        freeze_visual_vclm=cfg.freeze_visual_vclm,
        freeze_visual_vclm_temporal=cfg.freeze_visual_vclm_temporal,
        freeze_lm_vclm=cfg.freeze_lm_vclm,
        freeze_pseudo_temperature=cfg.freeze_pseudo_temperature)
    use_ssl = cfg.metadata_aux is not None and not is_vclm
    # the reference passes --pseudo-temperature-init (default 0.07) as
    # SSLCLIPLoss's scale_init (reference main_pretrain.py:195)
    criterion = ({"logit_scale_pseudo": math.log(
        1 / cfg.pseudo_temperature_init)} if use_ssl else None)
    state = TrainState.create(
        model, lambda params: make_optimizer(
            freeze_by_predicate(params, frozen), schedule,
            weight_decay=cfg.wd, betas=cfg.betas,
            eps=cfg.eps, clip_grad_value=clip,
            clip_grad_type=cfg.clip_grad_type,
            update_freq=cfg.update_freq),
        dtype=dtype,
        generator=torch.Generator(device).manual_seed(cfg.seed + rank),
        criterion=criterion)
    n_params = sum(p.numel() for p in state.params.values())
    n_frozen = sum(state.params[n].numel() for n in state.frozen)
    print(f"=> {n_params/1e6:.1f}M params, {n_frozen/1e6:.1f}M frozen"
          + (f" (rank {mesh.model_rank()}'s shards of {mesh.model_world()})"
             if mesh.model_world() > 1 else ""))

    mgr = CheckpointManager(cfg.output_dir)
    start_epoch = cfg.start_epoch
    best_metric = float("-inf")
    resume = resolve_resume(cfg.output_dir, cfg.resume or None)
    if resume:
        print(f"=> resuming from {resume}")
        tree, meta = mgr.restore(resume, map_location=device)
        state.load_state_dict(sharding.shard_train_state(tree, state))
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_metric = float(meta.get("metrics", {}).get(
            "best_metric", float("-inf")))
    mesh.broadcast_params(state)

    step_fn = (make_caption_train_step(pad_id=tokenizer.pad_token_id)
               if is_vclm else
               make_clip_train_step(norm_embed=cfg.norm_embed,
                                    use_ssl=use_ssl,
                                    local_loss=cfg.contrastive_use_vissl))
    metric_names = losses.get_metric_names(cfg.model)
    probe = bool(cfg.val_metadata) and not is_vclm
    place = make_place(device, ("frames", "text", "gt_indicators")
                       if use_ssl else ("frames", "text"))

    def run_probe() -> dict:
        """The zero-shot EK-100 MIR probe on the working copy, in eval
        mode (reference main_pretrain.py:359-379)."""
        from lavila_tpu_torch.cli.eval_zeroshot import eval_ek100_mir
        state.model.eval()
        try:
            return eval_ek100_mir(
                state.model, tokenizer, cfg.model,
                root=cfg.val_root or cfg.root, metadata=cfg.val_metadata,
                clip_length=cfg.clip_length, clip_stride=cfg.clip_stride,
                batch_size=cfg.batch_size, workers=cfg.workers,
                num_clips=cfg.val_num_clips, num_crops=cfg.val_num_crops)
        finally:
            state.model.train()

    os.makedirs(cfg.output_dir, exist_ok=True)
    wandb_run = (init_wandb(cfg.asdict()) if cfg.wandb and mesh.rank() == 0
                 else None)

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
                if wandb_run is not None:
                    wandb_run.log({k: m.val for k, m in meters.items()})
            else:
                batch_time.update(timer.lap())
            total_steps += 1
            if (probe and cfg.eval_in_middle_freq > 0 and it > 0
                    and it % cfg.eval_in_middle_freq == 0):
                run_probe()
            if cfg.steps is not None and total_steps >= cfg.steps:
                break
        if profiler is not None:  # fewer than 10 steps in all
            _stop_profiler(profiler, cfg.profile_dir)
            profiler = None

        probe_metrics = run_probe() if probe else {}
        # the best checkpoint follows the probe's mAP (reference
        # main_pretrain.py:394-403)
        is_best = probe_metrics.get("mAP_avg", float("-inf")) > best_metric
        if is_best:
            best_metric = probe_metrics["mAP_avg"]
        # best_metric stays out of the sidecar until a probe has run: -inf
        # would be written as the non-JSON -Infinity
        # the whole layout (the model group's shards gathered)
        mgr.save(sharding.gather_train_state(state.state_dict(), state),
                 epoch=epoch, config=cfg.asdict(),
                 metrics={**probe_metrics,
                          **({"best_metric": best_metric}
                             if math.isfinite(best_metric) else {})},
                 is_best=is_best,
                 keep_epoch=(epoch + 1) % cfg.save_freq == 0)
        log = {f"train_{k}": m.avg for k, m in meters.items()}
        log.update(probe_metrics)
        log["epoch"] = epoch
        if mesh.rank() == 0:
            with open(osp.join(cfg.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(log) + "\n")
        if wandb_run is not None:
            wandb_run.log(log)
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
    tracing.enable()  # the spans enter the trace as user annotations
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    tracing.disable()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"=> profiler trace written to {path}")


if __name__ == "__main__":
    main(parse_config(TorchPretrainConfig))
