"""Retrieval fine-tuning with the PyTorch port, on one device or
data-parallel over a process group: EK-100 MIR
(adaptive max-margin with relevancy weights) or CharadesEgo (the CLIP
loss on trimmed clips, validated by multilabel classification mAP on the
untrimmed val set).

Counterpart of ``cli/main_finetune_retrieval.py`` with the same flags,
plus ``--device`` (default ``cuda``; with ``cuda`` and no card it raises)
and ``--bf16`` (compute in bf16 on fp32 masters, as ``main_pretrain``;
the default computes in fp32, as the JAX CLI does). It rebuilds the
pretrained dual encoder from the checkpoint's sidecar config (else
``--model``), loads ``--pretrain-model`` (a port checkpoint or a
reference ``.pt``/``.pth``, the temporal embedding fitted to
``--clip-length``), freezes ``logit_scale`` always (reference :142),
trains with ``lavila_tpu_torch.train.step.make_retrieval_train_step``
and validates every ``--eval-freq`` epochs: EK-100 MIR mAP/nDCG through
``eval_zeroshot.eval_ek100_mir``, CharadesEgo video mAP through
``eval_zeroshot.eval_classification``; both run the text tower under
``inference_mode``, so through K7 (a DistilBERT tower, plain
attention, through the batch's ``mask``, which the step takes too, as
in the JAX CLI). Auto-resume from ``--output-dir``
restores the masters, the optimizer and the best metric; the best
checkpoint follows the validation metric.

Run without data:

    python -m lavila_tpu_torch.cli.main_finetune_retrieval \\
        --dataset synthetic --model CLIP_OPENAI_TIMESFORMER_MINI \\
        --clip-length 4 --batch-size 4 --steps 2 --device cpu \\
        --output-dir /tmp/ft

In a process group (``parallel/mesh.py``; ``lavila_tpu_torch.cli.launch
finetune_retrieval``) ``--batch-size`` is each rank's, as in the JAX CLI,
each rank's loader its shard (``shard_index=rank``), the ranking and CLIP
losses over the gathered global batch; every rank validates, rank 0
writes the checkpoints and ``log.txt``.

``--wandb`` logs to Weights & Biases where it can start.
``--use-checkpoint`` recomputes the video tower's blocks under
``--remat-policy`` (``full``, ``dots``, ``save_attn``, ``dots_attn``:
``models/timesformer.py``). ``--pretrain-model`` reads a reference or
port ``.pt``; a JAX run's Orbax checkpoint loads once
``scripts/export_jax_checkpoint.py`` has written it as one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import os.path as osp

import torch

from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli.main_pretrain import make_place
from lavila_tpu_torch.config import model_kwargs_from_config
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import DatasetConfig, VideoCaptionDataset
from lavila_tpu_torch.data.loader import DataLoader, device_prefetch
from lavila_tpu_torch.data.tokenizers import generate_tokenizer
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import load_reference_checkpoint
from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.train.freeze import freeze_by_predicate, \
    logit_scale_only
from lavila_tpu_torch.train.optim import cosine_schedule, make_optimizer
from lavila_tpu_torch.train.step import TrainState, \
    make_retrieval_train_step
from lavila_tpu_torch.utils.checkpoints import CheckpointManager, \
    resolve_resume
from lavila_tpu_torch.utils.meters import AverageMeter, Timer
from lavila_tpu_torch.utils.random import random_seed
from lavila_tpu_torch.utils.tracking import init_wandb


def get_args_parser():
    p = argparse.ArgumentParser("retrieval fine-tune (PyTorch port)")
    p.add_argument("--dataset", default="ek100_mir",
                   choices=["ek100_mir", "charades_ego",
                            "charades_ego_trimmed", "synthetic"],
                   help="charades_ego trains on the trimmed-pkl clips "
                        "and validates classification-style on the "
                        "untrimmed csv; charades_ego_trimmed is the "
                        "train-only alias")
    p.add_argument("--root", default="")
    p.add_argument("--metadata", default="")
    p.add_argument("--metadata-val", default="")
    p.add_argument("--label-metadata", default="",
                   help="Charades_v1_classes.txt for charades_ego "
                        "validation")
    p.add_argument("--pretrain-model", default="")
    p.add_argument("--resume", default="")
    p.add_argument("--model", default="CLIP_OPENAI_TIMESFORMER_MINI")
    p.add_argument("--clip-length", type=int, default=16)
    p.add_argument("--clip-stride", type=int, default=4)
    p.add_argument("--num-clips", type=int, default=1)
    p.add_argument("--num-crops", type=int, default=1)
    p.add_argument("--sparse-sample", action="store_true")
    p.add_argument("--norm-embed", action="store_true", default=True)
    p.add_argument("--loss", default="adaptive_max_margin",
                   choices=["max_margin", "adaptive_max_margin", "clip"])
    p.add_argument("--margin", type=float, default=0.4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--warmup-epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr-end", type=float, default=1e-6)
    p.add_argument("--lr-start", type=float, default=1e-6)
    p.add_argument("--fix-lr", action="store_true",
                   help="constant lr, no schedule")
    p.add_argument("--wd", type=float, default=0.01)
    p.add_argument("--betas", nargs=2, type=float, default=(0.9, 0.999))
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--update-freq", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--clip-grad-type", default="norm",
                   choices=["norm", "value"])
    p.add_argument("--clip-grad-value", type=float, default=None)
    p.add_argument("--drop-path-rate", type=float, default=0.1,
                   help="stochastic depth for fine-tuning (the fine-tune "
                        "value, not the pretrain config's)")
    p.add_argument("--freeze-temperature", action="store_true",
                   help="accepted for reference parity; logit_scale is "
                        "always frozen here")
    p.add_argument("--relevancy-path", default="",
                   help="explicit EK-100 relevancy pkl for validation; "
                        "the default derives it from the metadata dir")
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--eval-freq", type=int, default=5)
    p.add_argument("--save-freq", type=int, default=1)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--use-checkpoint", action="store_true")
    p.add_argument("--remat-policy", default="full",
                   choices=("full", "dots", "save_attn", "dots_attn"))
    p.add_argument("--evaluate", action="store_true",
                   help="validate once and exit")
    p.add_argument("--output-dir", default="./ft_retrieval")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 on fp32 masters (default fp32)")
    return p


def build_finetune_model(args, device: torch.device):
    """The dual encoder of the run (fp32, train mode): its config from
    the pretrain checkpoint's sidecar (else ``--model``), the fine-tune's
    drop-path rate and remat, the pretrain weights when given. Returns
    ``(model, config)``."""
    config = {"model": args.model, "clip_length": args.clip_length}
    if args.pretrain_model and osp.exists(args.pretrain_model + ".json"):
        with open(args.pretrain_model + ".json") as f:
            config.update(json.load(f).get("config", {}))
        config["clip_length"] = args.clip_length  # the PE is fitted below
    # the fine-tune recipe's values win over the pretrain config's
    config["drop_path_rate"] = args.drop_path_rate
    config["use_checkpoint"] = args.use_checkpoint
    config["remat_policy"] = args.remat_policy
    kw = model_kwargs_from_config(argparse.Namespace(**config))
    model = build_model(config["model"], device=device, train=True,
                        generator=torch.Generator().manual_seed(args.seed),
                        **kw)
    if args.pretrain_model:
        sd = load_reference_checkpoint(args.pretrain_model,
                                       num_frames=kw["num_frames"])
        model.load_state_dict(sd, strict=True)
        print(f"=> loaded pretrain weights from {args.pretrain_model}")
    return model, config


def validate(args, model, tokenizer, model_name) -> tuple[dict, float]:
    """One validation pass in eval mode: ``(metrics, key metric)``."""
    was_training = model.training
    model.eval()
    try:
        if args.dataset == "ek100_mir":
            out = ez.eval_ek100_mir(
                model, tokenizer, model_name, root=args.root,
                metadata=args.metadata_val, clip_length=args.clip_length,
                clip_stride=args.clip_stride, batch_size=args.batch_size,
                workers=args.workers, num_clips=args.num_clips,
                num_crops=args.num_crops,
                relevancy_path=args.relevancy_path or None)
            return out, out["mAP_avg"]
        if args.dataset in ("charades_ego", "charades_ego_trimmed"):
            # prompt-ensembled label embeddings and multilabel video mAP
            # on the untrimmed val csv (reference validate_cls, :569-644)
            from lavila_tpu_torch.data.label_maps import generate_label_map
            labels, mapping = generate_label_map(
                "charades_ego", metadata=args.label_metadata)
            ns = argparse.Namespace(
                dataset="charades_ego", root=args.root,
                metadata=args.metadata_val, metadata_val=args.metadata_val,
                clip_length=args.clip_length, clip_stride=args.clip_stride,
                num_clips=args.num_clips, num_crops=args.num_crops,
                batch_size=args.batch_size, sparse_sample=args.sparse_sample,
                workers=args.workers)
            out = ez.eval_classification(ns, model, tokenizer, model_name,
                                         labels, mapping, multilabel=True)
            return out, out["video_mAP"]
    finally:
        model.train(was_training)
    raise ValueError(
        f"no validation protocol for dataset {args.dataset!r}: this CLI "
        "validates ek100_mir (retrieval mAP/nDCG) or charades_ego "
        "(classification video mAP); omit --metadata-val to train without "
        "per-epoch validation")


def main(args):
    world, rank = mesh.world(), mesh.rank()
    device = ez.resolve_device(args.device)
    random_seed(args.seed, rank)
    model, config = build_finetune_model(args, device)
    model_name = config["model"]
    tokenizer = generate_tokenizer(model_name)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    mean, std = T.normalization_for_model(model_name)
    train_transform = T.TrainTransform(ez.crop_shape(model_name)[0], mean,
                                       std)
    # charades_ego trains on the trimmed action instances (pkl) and
    # validates on the untrimmed csv (reference :281-295)
    train_name = ("charades_ego_trimmed" if args.dataset == "charades_ego"
                  else args.dataset)
    dcfg = DatasetConfig(dataset=train_name, root=args.root,
                         metadata=args.metadata,
                         clip_length=args.clip_length,
                         clip_stride=args.clip_stride)
    ds = VideoCaptionDataset(dcfg, train_transform, tokenizer,
                             is_training=True, seed=args.seed)
    loader = DataLoader(ds, args.batch_size, shuffle=True, drop_last=True,
                        num_workers=args.workers, shard_index=rank,
                        num_shards=world, seed=args.seed)
    iters = max(len(loader), 1)

    optim_iters = max(iters // args.update_freq, 1)
    schedule = (args.lr if args.fix_lr else
                cosine_schedule(args.lr, args.lr_end, args.epochs,
                                optim_iters, args.warmup_epochs,
                                args.lr_start))
    # logit_scale is frozen unconditionally, as the reference's
    # model.logit_scale.requires_grad = False (:142)
    state = TrainState.create(
        model, lambda params: make_optimizer(
            freeze_by_predicate(params, logit_scale_only), schedule,
            weight_decay=args.wd, betas=tuple(args.betas), eps=args.eps,
            clip_grad_value=args.clip_grad_value,
            clip_grad_type=args.clip_grad_type,
            update_freq=args.update_freq),
        dtype=dtype,
        generator=torch.Generator(device).manual_seed(args.seed + rank))
    print(f"=> {model_name} on {device}, compute dtype "
          f"{str(dtype).removeprefix('torch.')}, {len(ds)} clips, "
          f"{iters} iters/epoch")

    mgr = CheckpointManager(args.output_dir)
    wandb_run = (init_wandb(vars(args)) if args.wandb and rank == 0
                 else None)
    start_epoch = args.start_epoch
    best_metric = float("-inf")
    # auto-resume: a checkpoint in output_dir wins over --resume
    # (reference :182-217, best_acc1 included)
    resume = resolve_resume(args.output_dir, args.resume or None)
    if resume:
        print(f"=> resuming from {resume}")
        tree, meta = mgr.restore(resume, map_location=device)
        state.load_state_dict(tree)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_metric = float(meta.get("metrics", {}).get(
            "best_metric", float("-inf")))
    mesh.broadcast_params(state)

    if args.evaluate:
        out, _ = validate(args, state.model, tokenizer, model_name)
        print(json.dumps(out))
        return out

    loss_type = ("clip" if args.dataset.startswith("charades")
                 else args.loss)
    step_fn = make_retrieval_train_step(loss_type=loss_type,
                                        margin=args.margin,
                                        norm_embed=args.norm_embed)
    place = make_place(device, ("frames", "text", "relevancy")
                       if loss_type == "adaptive_max_margin"
                       else ("frames", "text"))
    os.makedirs(args.output_dir, exist_ok=True)
    total = 0
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_m = AverageMeter("loss", ":.4f")
        timer = Timer()
        for it, batch in enumerate(device_prefetch(loader, place)):
            state, metrics = step_fn(state, batch)
            if it % args.print_freq == 0:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss is {loss}")
                loss_m.update(loss, args.batch_size)
                print(f"Epoch [{epoch}][{it}/{len(loader)}] "
                      f"loss {loss_m.val:.4f} ({loss_m.avg:.4f}) "
                      f"t {timer.lap():.2f}s", flush=True)
                if wandb_run is not None:
                    wandb_run.log({"loss": loss_m.val})
            total += 1
            if args.steps and total >= args.steps:
                break

        val_metrics = {}
        is_best = False
        if args.metadata_val and (epoch + 1) % args.eval_freq == 0:
            val_metrics, key_metric = validate(args, state.model, tokenizer,
                                               model_name)
            if key_metric > best_metric:
                is_best, best_metric = True, key_metric
        # best_metric stays out of the sidecar until a validation has
        # run: -inf would be written as the non-JSON -Infinity
        mgr.save(state.state_dict(), epoch=epoch, config=config,
                 metrics={**val_metrics,
                          **({"best_metric": best_metric}
                             if math.isfinite(best_metric) else {})},
                 is_best=is_best,
                 keep_epoch=(epoch + 1) % args.save_freq == 0)
        log = {"train_loss": loss_m.avg, **val_metrics, "epoch": epoch}
        if rank == 0:
            with open(osp.join(args.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(log) + "\n")
        if wandb_run is not None and val_metrics:
            wandb_run.log({**val_metrics, "epoch": epoch})
        if args.steps and total >= args.steps:
            break
    print("=> done")
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
