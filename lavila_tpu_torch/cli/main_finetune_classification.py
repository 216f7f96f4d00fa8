"""Classification fine-tuning of the video tower with the PyTorch port, on
one device or data-parallel over a process group: EK-100 CLS (with
``--use-vn-classifier`` the verb, noun and action heads), EGTEA and
CharadesEgo (multi-label).

Counterpart of ``cli/main_finetune_classification.py`` with the same
flags, plus ``--device`` (default ``cuda``; with ``cuda`` and no card it
raises) and ``--bf16`` (compute in bf16 on fp32 masters, as
``main_pretrain``; the default computes in fp32, as the JAX CLI does).
The pretrained dual encoder's video tower (its config from the
checkpoint's sidecar, else ``--model``; the fine-tune's drop-path rate
and remat) goes under a ``VideoClassifier[MultiHead]``; ``--pretrain-model``
loads only its ``visual.*`` weights, from a port checkpoint (the
pretraining CLI's ``.pt``) or a reference LaViLa ``.pt``, the temporal
embedding fitted to ``--clip-length``. The head and the backbone train
as two groups (``optax.multi_transform``): the backbone at
``--lr-multiplier-on-backbone`` times the head's rate, each group
clipped by its own norm, AdamW or ``--use-sgd`` (momentum 0.9), with
label smoothing. Every ``--eval-freq`` epochs it validates with
softmax averaging over the clips and crops: top-1/5 accuracy, EK-100's
verb and noun accuracy by marginalising the action head, EGTEA's mean
class accuracy, CharadesEgo's mAP; the best checkpoint follows the
mAP or the top-1. Auto-resume from ``--output-dir`` restores the
masters, the optimizer and the best metric.

Run without data:

    python -m lavila_tpu_torch.cli.main_finetune_classification \\
        --dataset synthetic --model CLIP_OPENAI_TIMESFORMER_MINI \\
        --clip-length 4 --batch-size 4 --steps 2 --device cpu \\
        --output-dir /tmp/cls

In a process group (``parallel/mesh.py``; ``lavila_tpu_torch.cli.launch
finetune_classification``) ``--batch-size`` is each rank's, as in the JAX
CLI, each rank's loader its shard (``shard_index=rank``), the gradients
averaged over the ranks; every rank validates, rank 0 writes the
checkpoints and ``log.txt``.

``--use-checkpoint`` recomputes the video tower's blocks under
``--remat-policy`` (``full``, ``dots``, ``save_attn``, ``dots_attn``:
``models/timesformer.py``). A JAX run's Orbax checkpoint serves as
``--pretrain-model`` once ``scripts/export_jax_checkpoint.py`` has written
it as a ``.pt``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import os.path as osp

import numpy as np
import torch

from lavila_tpu_torch.cli import eval_zeroshot as ez
from lavila_tpu_torch.cli.main_pretrain import to_device
from lavila_tpu_torch.config import model_kwargs_from_config
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import (DatasetConfig,
                                            VideoCaptionDataset,
                                            VideoClassyDataset)
from lavila_tpu_torch.data.label_maps import (actions_to_parts,
                                              generate_label_map)
from lavila_tpu_torch.data.loader import DataLoader, device_prefetch
from lavila_tpu_torch.eval import metrics as M
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import load_reference_checkpoint
from lavila_tpu_torch.models.dual_encoder import (VideoClassifier,
                                                  VideoClassifierMultiHead)
from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.train.optim import (cosine_schedule,
                                          lr_multiplier_labels,
                                          make_multi_optimizer)
from lavila_tpu_torch.train.step import (TrainState,
                                         make_classifier_train_step)
from lavila_tpu_torch.utils.checkpoints import (CheckpointManager,
                                                resolve_resume)
from lavila_tpu_torch.utils.meters import AverageMeter, Timer
from lavila_tpu_torch.utils.random import random_seed
from lavila_tpu_torch.utils.tracking import init_wandb


def get_args_parser():
    p = argparse.ArgumentParser("classification fine-tune (PyTorch port)")
    p.add_argument("--dataset", default="ek100_cls",
                   choices=["ek100_cls", "egtea", "charades_ego",
                            "synthetic"])
    p.add_argument("--root", default="")
    p.add_argument("--metadata-train", default="")
    p.add_argument("--metadata-val", default="")
    p.add_argument("--label-metadata", default="")
    p.add_argument("--pretrain-model", default="")
    p.add_argument("--resume", default="")
    p.add_argument("--model", default="CLIP_OPENAI_TIMESFORMER_MINI")
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--use-vn-classifier", action="store_true",
                   help="verb+noun+action multi-head (EK-100)")
    p.add_argument("--clip-length", type=int, default=16)
    p.add_argument("--clip-stride", type=int, default=2)
    p.add_argument("--num-clips", type=int, default=1)
    p.add_argument("--num-crops", type=int, default=1)
    p.add_argument("--sparse-sample", action="store_true")
    p.add_argument("--dropout", "--dropout-ratio", dest="dropout",
                   type=float, default=0.5,
                   help="head dropout (reference --dropout-ratio)")
    p.add_argument("--drop-path-rate", type=float, default=0.1,
                   help="stochastic depth for fine-tuning (the fine-tune "
                        "value, not the pretrain config's)")
    p.add_argument("--remat-policy", default="full",
                   choices=("full", "dots", "save_attn", "dots_attn"))
    p.add_argument("--use-checkpoint", action="store_true",
                   help="activation remat on the backbone")
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--warmup-epochs", type=int, default=2)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--lr-end", type=float, default=1e-5)
    p.add_argument("--lr-start", type=float, default=1e-6,
                   help="warm-up start lr")
    p.add_argument("--fix-lr", action="store_true",
                   help="constant lr, no schedule")
    p.add_argument("--lr-multiplier-on-backbone", type=float, default=0.1)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--betas", nargs=2, type=float, default=(0.9, 0.999))
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--update-freq", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--clip-grad-type", default="norm",
                   choices=["norm", "value"])
    p.add_argument("--clip-grad-value", type=float, default=None)
    p.add_argument("--use-sgd", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--freeze-temperature", action="store_true",
                   help="accepted for reference parity; unused (the "
                        "classifier has no logit_scale)")
    p.add_argument("--relevancy-path", default="",
                   help="accepted for reference parity; unused "
                        "(classification has no relevancy matrix)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--eval-freq", type=int, default=1)
    p.add_argument("--save-freq", type=int, default=1)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--evaluate", action="store_true",
                   help="validate once and exit")
    p.add_argument("--output-dir", default="./ft_cls")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 on fp32 masters (default fp32)")
    return p


class SyntheticClassDataset(VideoCaptionDataset):
    """The synthetic clips, clip ``i`` of class ``i % num_classes``."""

    def __init__(self, cfg, transform, num_classes: int):
        super().__init__(cfg, transform, tokenizer=None, seed=0)
        self.num_classes = num_classes

    def __getitem__(self, i: int):
        item = super().__getitem__(i)
        return {"frames": item["frames"],
                "label": np.int32(i % self.num_classes)}


def label_space(args):
    """``(labels, mapping, num_classes, multihead_parts, heads)``: the
    class texts and the raw label → class map (None for synthetic), the
    action → (verb, noun) table of EK-100 (else None), and the classes
    of each head (a list under ``--use-vn-classifier``, else an int)."""
    multihead_parts = None
    if args.dataset == "synthetic":
        labels = [f"class {i}" for i in range(args.num_classes or 10)]
        mapping = None
    else:
        labels, mapping = generate_label_map(
            args.dataset, metadata=args.label_metadata or args.metadata_train)
    num_classes = len(labels)
    if args.dataset == "ek100_cls":
        multihead_parts = actions_to_parts(mapping)
    heads = num_classes
    if args.use_vn_classifier:
        if args.dataset != "ek100_cls":
            raise ValueError("--use-vn-classifier needs --dataset ek100_cls")
        heads = [int(multihead_parts[:, 0].max()) + 1,
                 int(multihead_parts[:, 1].max()) + 1, num_classes]
    return labels, mapping, num_classes, multihead_parts, heads


def build_classifier(args, heads, device: torch.device):
    """The classifier over the pretrained dual encoder's video tower
    (fp32, train mode), its heads seeded from ``--seed``. Returns
    ``(classifier, config)``."""
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
    gen = torch.Generator().manual_seed(args.seed)
    vision = build_model(config["model"], device=device, generator=gen,
                         **kw).visual
    if args.pretrain_model:
        sd = load_reference_checkpoint(args.pretrain_model,
                                       num_frames=kw["num_frames"])
        vision.load_state_dict({k.removeprefix("visual."): v
                                for k, v in sd.items()
                                if k.startswith("visual.")}, strict=True)
        print(f"=> loaded the video tower from {args.pretrain_model}")
    clf = (VideoClassifierMultiHead(vision, heads, args.dropout)
           if isinstance(heads, list)
           else VideoClassifier(vision, heads, args.dropout))
    clf.init_weights(gen, backbone=False)
    return clf.to(device).train(), config


@torch.inference_mode()
def validate(args, model, mapping, num_classes, multihead_parts,
             model_name) -> dict:
    """Multi-clip / multi-crop validation in eval mode, the softmax
    averaged over the views: top-1/5 accuracy, EK-100's verb and noun
    accuracy by marginalising the action head, EGTEA's mean class
    accuracy, CharadesEgo's mAP (reference
    main_finetune_classification.py:543-709)."""
    mean, std = T.normalization_for_model(model_name)
    transform = T.EvalTransform(ez.crop_shape(model_name)[0], mean, std,
                                num_spatial_crops=args.num_crops)
    dcfg = DatasetConfig(
        dataset=args.dataset, root=args.root, metadata=args.metadata_val,
        clip_length=args.clip_length, clip_stride=args.clip_stride,
        num_clips=args.num_clips, sparse_sample=args.sparse_sample,
        is_trimmed=args.dataset != "charades_ego")
    ds = VideoClassyDataset(dcfg, transform, mapping, is_training=False)
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    probs_all, labels_all = [], []
    try:
        for batch in loader:
            frames = np.asarray(batch["frames"])
            views = 1
            if frames.ndim == 6:  # (B, views, T, H, W, C)
                views = frames.shape[1]
                frames = frames.reshape((-1,) + frames.shape[2:])
            outs = model(torch.from_numpy(frames).to(device))
            if args.use_vn_classifier:
                outs = outs[-1]  # the action head; verb/noun marginalised
            probs = torch.softmax(outs.float(), -1).cpu().numpy()
            if views > 1:
                probs = probs.reshape(-1, views, probs.shape[-1]).mean(1)
            probs_all.append(probs)
            labels_all.append(np.asarray(batch["label"]))
    finally:
        model.train(was_training)
    probs = np.concatenate(probs_all)
    labels_arr = np.concatenate(labels_all)
    if args.dataset == "charades_ego":
        return {"video_mAP": M.multilabel_map(probs, labels_arr)[0]}
    out = {}
    out["acc1"], out["acc5"] = M.topk_accuracy(probs, labels_arr, ks=(1, 5))
    if args.dataset == "egtea":
        cm = M.confusion_matrix(probs.argmax(1), labels_arr, num_classes)
        out["mean_class_acc"] = M.mean_class_accuracy(cm)[0]
    if multihead_parts is not None:
        for part, name in ((0, "verb_acc1"), (1, "noun_acc1")):
            marginal = M.marginalize(
                probs, M.marginal_indexes(multihead_parts, part))
            out[name] = M.topk_accuracy(
                marginal, multihead_parts[labels_arr, part], ks=(1,))[0]
    return out


def make_place(device: torch.device, multihead_parts, multihead: bool):
    """Host batch → device tensors: ``frames``, and ``label`` (class ids
    or a multi-hot) or, for the verb/noun/action heads, ``labels``."""
    def place(batch):
        lab = np.asarray(batch["label"])
        out = {"frames": to_device(batch["frames"], torch.float32, device)}
        if multihead:
            out["labels"] = tuple(
                to_device(x, torch.long, device)
                for x in (multihead_parts[lab, 0], multihead_parts[lab, 1],
                          lab))
        else:
            out["label"] = to_device(lab, torch.float32 if lab.ndim > 1
                                     else torch.long, device)
        return out
    return place


def main(args):
    world, rank = mesh.world(), mesh.rank()
    device = ez.resolve_device(args.device)
    random_seed(args.seed, rank)
    labels, mapping, num_classes, multihead_parts, heads = label_space(args)
    clf, config = build_classifier(args, heads, device)
    model_name = config["model"]
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    mean, std = T.normalization_for_model(model_name)
    train_transform = T.TrainTransform(ez.crop_shape(model_name)[0], mean,
                                       std, flip=True)
    if args.dataset == "synthetic":
        ds = SyntheticClassDataset(
            DatasetConfig(dataset="synthetic", root="", metadata="",
                          clip_length=args.clip_length),
            train_transform, num_classes)
    else:
        dcfg = DatasetConfig(
            dataset=args.dataset, root=args.root,
            metadata=args.metadata_train, clip_length=args.clip_length,
            clip_stride=args.clip_stride, num_clips=args.num_clips,
            sparse_sample=args.sparse_sample)
        ds = VideoClassyDataset(dcfg, train_transform, mapping,
                                is_training=True, seed=args.seed)
    loader = DataLoader(ds, args.batch_size, shuffle=True, drop_last=True,
                        num_workers=args.workers, shard_index=rank,
                        num_shards=world, seed=args.seed)
    iters = max(len(loader), 1)

    # the head and the backbone as two groups (reference
    # --lr-multiplier-on-backbone), each with its own schedule and its
    # own clipping norm
    optim_iters = max(iters // args.update_freq, 1)
    lr_bb = args.lr * args.lr_multiplier_on_backbone
    lrs = ({"head": args.lr, "backbone": lr_bb} if args.fix_lr else
           {label: cosine_schedule(lr, args.lr_end, args.epochs, optim_iters,
                                   args.warmup_epochs, args.lr_start)
            for label, lr in (("head", args.lr), ("backbone", lr_bb))})
    state = TrainState.create(
        clf, lambda params: make_multi_optimizer(
            params, lr_multiplier_labels(n for n, _ in clf.named_parameters()),
            lrs, weight_decay=args.wd, betas=tuple(args.betas),
            eps=args.eps, clip_grad_value=args.clip_grad_value,
            clip_grad_type=args.clip_grad_type,
            update_freq=args.update_freq, use_sgd=args.use_sgd),
        dtype=dtype,
        generator=torch.Generator(device).manual_seed(args.seed + 7 + rank))
    print(f"=> {model_name} classifier ({heads} classes) on {device}, "
          f"compute dtype {str(dtype).removeprefix('torch.')}, {len(ds)} "
          f"clips, {iters} iters/epoch")

    mgr = CheckpointManager(args.output_dir)
    wandb_run = (init_wandb(vars(args)) if args.wandb and rank == 0
                 else None)
    start_epoch = args.start_epoch
    best_metric = float("-inf")
    # auto-resume: a checkpoint in output_dir wins over --resume
    # (reference main_finetune_classification.py:252-287, best_acc1
    # included)
    resume = resolve_resume(args.output_dir, args.resume or None)
    if resume:
        print(f"=> resuming from {resume}")
        tree, meta = mgr.restore(resume, map_location=device)
        state.load_state_dict(tree)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_metric = float(meta.get("metrics", {}).get(
            "best_metric", float("-inf")))
    mesh.broadcast_params(state)

    def run_validation() -> dict:
        return validate(args, state.model, mapping, num_classes,
                        multihead_parts, model_name)

    if args.evaluate:
        out = run_validation()
        print(json.dumps(out))
        return out

    step_fn = make_classifier_train_step(
        multihead=args.use_vn_classifier,
        label_smoothing=args.label_smoothing)
    place = make_place(device, multihead_parts, args.use_vn_classifier)
    os.makedirs(args.output_dir, exist_ok=True)
    total = 0
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_m = AverageMeter("loss", ":.4f")
        acc_m = AverageMeter("acc1", ":.2f")
        timer = Timer()
        for it, batch in enumerate(device_prefetch(loader, place)):
            state, metrics = step_fn(state, batch)
            if it % args.print_freq == 0:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss is {loss}")
                loss_m.update(loss, args.batch_size)
                acc_m.update(float(metrics["acc1"]), args.batch_size)
                print(f"Epoch [{epoch}][{it}/{len(loader)}] "
                      f"loss {loss_m.avg:.4f} acc1 {acc_m.avg:.2f} "
                      f"t {timer.lap():.2f}s", flush=True)
                if wandb_run is not None:
                    wandb_run.log({"loss": loss_m.val, "acc1": acc_m.val})
            total += 1
            if args.steps and total >= args.steps:
                break

        val_metrics = {}
        is_best = False
        if (args.metadata_val and args.dataset != "synthetic"
                and (epoch + 1) % args.eval_freq == 0):
            val_metrics = run_validation()
            print(json.dumps(val_metrics))
            key = val_metrics.get("video_mAP", val_metrics.get("acc1"))
            if key > best_metric:
                is_best, best_metric = True, key
        # best_metric stays out of the sidecar until a validation has
        # run: -inf would be written as the non-JSON -Infinity
        mgr.save(state.state_dict(), epoch=epoch,
                 config={**config, "num_classes": num_classes},
                 metrics={**val_metrics,
                          **({"best_metric": best_metric}
                             if math.isfinite(best_metric) else {})},
                 is_best=is_best,
                 keep_epoch=(epoch + 1) % args.save_freq == 0)
        log = {"train_loss": loss_m.avg, "train_acc1": acc_m.avg,
               **val_metrics, "epoch": epoch}
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
