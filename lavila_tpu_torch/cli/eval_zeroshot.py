"""Zero-shot evaluation with the PyTorch port.

Counterpart of ``cli/eval_zeroshot.py``, with the same flags and
functions: EK-100 MIR retrieval (graded mAP/nDCG), EK-100 CLS / EGTEA /
Charades-Ego zero-shot classification from prompt-ensembled label
embeddings with multi-view logit pooling, and EgoMCQ. Data loading,
tokenisation and metrics are the port's own copies of the framework-free
modules of ``lavila_tpu`` (``lavila_tpu_torch.data``, ``.eval``).
Everything runs under ``torch.inference_mode()``.

``--device`` (default ``cuda``) names the device; with ``cuda`` and no
card it raises. ``--bf16`` casts the model to bf16. Checkpoints are
reference ``.pt``/``.pth`` files or the port's own from
``main_pretrain`` (their JSON sidecar names the model); a JAX run's
Orbax checkpoint loads once ``scripts/export_jax_checkpoint.py`` has
written it as such a ``.pt`` and sidecar.

The DistilBERT dual encoders (``*_DISTILBERT_BASE``) take each caption's
attention mask beside its ids, where the JAX CLI passes it: the
dataset's ``mask`` (flattened with the text when a clip has several
narrations), the label prompts' tokenizer mask, EgoMCQ's
``query_mask``. Their WordPiece vocabulary is read from
``$LAVILA_TOKENIZER_DIR/distilbert-base-uncased/vocab.txt``.

    python -m lavila_tpu_torch.cli.eval_zeroshot --dataset ek100_mir \\
        --root ... --metadata ... --model CLIP_OPENAI_TIMESFORMER_BASE

The TSF-L models (``CLIP_OPENAI_TIMESFORMER_LARGE``, ``..._LARGE_336PX``,
the high-resolution one, whose frames are cropped to 336) serve the
same way, as do the CLIP ViTs (``CLIP_OPENAI_VIT{B32,B16,L14,
L14_336PX}``), whose ``--checkpoint`` may be OpenAI's released ``.pt``
(``models/convert.py:load_reference_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

import numpy as np
import torch

from lavila_tpu_torch.config import model_kwargs_from_config
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import (DatasetConfig,
                                            VideoCaptionDataset,
                                            VideoClassyDataset,
                                            VideoMcqDataset)
from lavila_tpu_torch.data.loader import DataLoader
from lavila_tpu_torch.data.tokenizers import generate_tokenizer
from lavila_tpu_torch.eval import metrics as M
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.convert import load_reference_checkpoint
from lavila_tpu_torch.parallel import mesh


def get_args_parser():
    p = argparse.ArgumentParser("zero-shot evaluation (PyTorch port)")
    p.add_argument("--dataset", default="ek100_mir",
                   choices=["ek100_mir", "ek100_cls", "charades_ego",
                            "egtea", "ego4d_mcq"])
    p.add_argument("--root", default="")
    p.add_argument("--metadata", default="")
    p.add_argument("--metadata-val", default="")
    p.add_argument("--relevancy-path", default="")
    p.add_argument("--checkpoint", required=False, default="")
    p.add_argument("--resume", default="",
                   help="alias for --checkpoint")
    p.add_argument("--output-dir", default="",
                   help="when no --checkpoint/--resume is given, load "
                        "checkpoint_best.pt from here")
    p.add_argument("--model", default="CLIP_OPENAI_TIMESFORMER_MINI",
                   help="used when no checkpoint config is available")
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--clip-stride", type=int, default=16)
    p.add_argument("--num-clips", type=int, default=1)
    p.add_argument("--num-crops", type=int, default=1)
    p.add_argument("--sparse-sample", action="store_true",
                   help="evenly-spaced multi-clip sampling over the whole "
                        "video (EGTEA/classification protocol)")
    p.add_argument("--narration-selection", default="random",
                   choices=["random", "concat", "list"],
                   help="how list-valued narrations are used; 'list' "
                        "scores every narration and pools")
    p.add_argument("--narration-pool", default="max",
                   choices=["max", "mean"],
                   help="pooling over narrations when "
                        "--narration-selection list")
    p.add_argument("--bf16", action="store_true",
                   help="cast the model to bf16 (the reference's "
                        "--use-half)")
    p.add_argument("--cls-use-template", action="store_true",
                   help="egocentric prompt templates '#C C {}' / '#C {}' "
                        "for classification label embeddings")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--output-json", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


def resolve_device(name: str) -> torch.device:
    """``name`` as this rank's device (a bare ``cuda`` is the rank's
    card in a process group: ``parallel/mesh.py:rank_device``); a CUDA
    device without a card raises."""
    device = mesh.rank_device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def load_model_from_checkpoint(args):
    """Build the model from the checkpoint's sidecar config (else
    ``--model``) on ``--device``, load a reference ``.pt``/``.pth`` when
    given (strict), and cast to bf16 with ``--bf16``. Returns
    ``(model, tokenizer, model_name)``.

    Checkpoint precedence: ``--checkpoint``/``--resume``, else
    ``checkpoint_best.pt`` under ``--output-dir`` when one exists."""
    if not args.checkpoint and getattr(args, "resume", ""):
        args.checkpoint = args.resume
    if not args.checkpoint and getattr(args, "output_dir", ""):
        best = osp.join(args.output_dir, "checkpoint_best.pt")
        if osp.exists(best):
            args.checkpoint = best
    config = {}
    if args.checkpoint:
        if not args.checkpoint.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{args.checkpoint}: only .pt/.pth checkpoints load into "
                "the port; write a JAX run's Orbax checkpoint as one with "
                "scripts/export_jax_checkpoint.py")
        meta_path = args.checkpoint + ".json"
        if osp.exists(meta_path):
            with open(meta_path) as f:
                config = json.load(f).get("config", {})
    model_name = config.get("model", args.model)
    config.setdefault("model", model_name)
    config.setdefault("clip_length", args.clip_length)
    kw = model_kwargs_from_config(argparse.Namespace(**config))
    for name in ("drop_path_rate", "remat", "remat_policy"):
        kw.pop(name)  # training-only: no effect on an eval forward
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else \
        torch.float32
    model = build_model(model_name, device=resolve_device(args.device),
                        dtype=dtype, **kw)
    if args.checkpoint:
        sd = load_reference_checkpoint(args.checkpoint,
                                       num_frames=kw["num_frames"])
        model.load_state_dict(sd, strict=True)
    return model, generate_tokenizer(model_name), model_name


def crop_shape(model_name):
    crop = 336 if "336PX" in model_name else (
        64 if "MINI" in model_name else 224)
    return (crop, crop, 3)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _encode_image(model, frames: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(_device(model))
    return model.encode_image(x).float().cpu().numpy()


def _encode_text(model, text: np.ndarray,
                 mask: np.ndarray | None = None) -> np.ndarray:
    """Text embeddings of token ids, under their {0, 1} attention mask
    when one is given (the DistilBERT towers)."""
    device = _device(model)
    t = torch.from_numpy(np.asarray(text, np.int64)).to(device)
    if mask is None:
        return model.encode_text(t).float().cpu().numpy()
    m = torch.from_numpy(np.asarray(mask, np.float32)).to(device)
    return model.encode_text(t, m).float().cpu().numpy()


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)


@torch.inference_mode()
def embed_dataset(model, loader, has_mask: bool = False):
    """Encode all (video, text) pairs → L2-normalised embedding arrays
    ``(v, t, n_narrations)``. Multi-view batches (B, views, T, H, W, C)
    are encoded per view and mean-pooled over normalised view embeddings
    (then re-normalised). Multiple-narration batches, text of shape
    (B, n, L), are flattened for encoding, so ``t`` has B·n rows. With
    ``has_mask`` each batch's ``mask`` goes with its text."""
    vids, txts = [], []
    n_narr = 1
    for batch in loader:
        frames = np.asarray(batch["frames"])
        views = 1
        if frames.ndim == 6:
            views = frames.shape[1]
            frames = frames.reshape((-1,) + frames.shape[2:])
        iv = _encode_image(model, frames)
        if views > 1:
            iv = _l2(iv).reshape(-1, views, iv.shape[-1]).mean(axis=1)
        text = np.asarray(batch["text"])
        mask = np.asarray(batch["mask"]) if has_mask else None
        if text.ndim == 3:  # (B, n_narrations, L)
            if txts and text.shape[1] != n_narr:
                raise ValueError(
                    f"ragged narration lists: batch has {text.shape[1]} "
                    f"narrations/clip but earlier batches had {n_narr}; "
                    "--narration-selection list needs a constant count")
            n_narr = text.shape[1]
            text = text.reshape(-1, text.shape[-1])
            if mask is not None:
                mask = mask.reshape(-1, mask.shape[-1])
        elif n_narr != 1:
            raise ValueError(
                "ragged narration lists: batch has a single narration "
                f"per clip but earlier batches had {n_narr}")
        vids.append(iv)
        txts.append(_encode_text(model, text, mask))
    return _l2(np.concatenate(vids)), _l2(np.concatenate(txts)), n_narr


@torch.inference_mode()
def eval_ek100_mir(model, tokenizer, model_name, *, root, metadata,
                   clip_length, clip_stride, batch_size, workers,
                   num_clips=1, num_crops=1, narration_selection="random",
                   narration_pool="max", relevancy_path=None):
    """EK-100 MIR retrieval, scored as the JAX CLI does: the raw
    (n_videos × n_videos) similarity matrix, columns selected through the
    sentence csv onto the (n_videos × n_sentences) relevancy matrix, then
    graded mAP and nDCG."""
    from lavila_tpu_torch.data.datasets import (load_ek100_mir_relevancy,
                                                load_ek100_video_ids)
    mean, std = T.normalization_for_model(model_name)
    crop = crop_shape(model_name)[0]
    transform = T.EvalTransform(crop, mean, std,
                                num_spatial_crops=num_crops,
                                num_temporal_clips=num_clips,
                                frames_per_clip=clip_length)
    dcfg = DatasetConfig(dataset="ek100_mir", root=root, metadata=metadata,
                         clip_length=clip_length, clip_stride=clip_stride,
                         num_clips=num_clips,
                         narration_selection=narration_selection,
                         relevancy_path=relevancy_path)
    ds = VideoCaptionDataset(dcfg, transform, tokenizer, is_training=False)
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False,
                        num_workers=workers)
    v, t, n_narr = embed_dataset(model, loader,
                                 has_mask="DISTILBERT" in model_name)
    sim = v @ t.T
    if n_narr > 1:  # (V, V·n) → (V, V, n) → pool over narrations
        sim = sim.reshape(v.shape[0], v.shape[0], n_narr)
        sim = sim.max(axis=2) if narration_pool == "max" else \
            sim.mean(axis=2)
    sim = (sim + 1) / 2
    mir = load_ek100_mir_relevancy(metadata, relevancy_path)
    video_ids = load_ek100_video_ids(metadata)
    row_of = {}
    for k, vid in enumerate(video_ids):
        row_of.setdefault(vid, k)  # first occurrence wins
    missing = [sid for sid in mir.sentence_ids if sid not in row_of]
    if missing:
        raise ValueError(
            f"{len(missing)} sentence ids absent from the metadata csv "
            f"(e.g. {missing[:3]}): sentence csv / metadata csv disagree")
    sim = sim[:, [row_of[sid] for sid in mir.sentence_ids]]
    if sim.shape != mir.rel.shape:
        raise ValueError(
            f"similarity {sim.shape} vs relevancy {mir.rel.shape}: "
            "metadata csv / sentence csv / relevancy pkl disagree")
    v_map, t_map, avg_map = M.retrieval_map(sim, mir.rel)
    v_ndcg, t_ndcg, avg_ndcg = M.retrieval_ndcg(sim, mir.rel)
    out = {"mAP_v2t": v_map, "mAP_t2v": t_map, "mAP_avg": avg_map,
           "nDCG_v2t": v_ndcg, "nDCG_t2v": t_ndcg, "nDCG_avg": avg_ndcg}
    print(json.dumps(out))
    return out


@torch.inference_mode()
def build_label_embeddings(model, tokenizer, labels, templates=("{}",)):
    """Prompt-ensembled class text embeddings: each label (or list of
    narrations) is expanded through ``templates`` and the normalised
    member embeddings are averaged, then re-normalised. A tokenizer that
    returns (ids, mask), the WordPiece one, has its mask passed on."""
    out = []
    for label in labels:
        members = label if isinstance(label, list) else [label]
        variants = [t.format(m) for t in templates for m in members]
        toks = tokenizer(variants)
        toks = toks if isinstance(toks, tuple) else (toks,)
        out.append(_l2(_encode_text(model, *toks)).mean(0))
    return _l2(np.stack(out))


@torch.inference_mode()
def eval_classification(args, model, tokenizer, model_name, labels,
                        label_mapping, multilabel=False):
    mean, std = T.normalization_for_model(model_name)
    crop = crop_shape(model_name)[0]
    transform = T.EvalTransform(crop, mean, std,
                                num_spatial_crops=args.num_crops,
                                num_temporal_clips=args.num_clips,
                                frames_per_clip=args.clip_length)
    dcfg = DatasetConfig(dataset=args.dataset, root=args.root,
                         metadata=args.metadata_val or args.metadata,
                         clip_length=args.clip_length,
                         clip_stride=args.clip_stride,
                         num_clips=args.num_clips,
                         sparse_sample=args.sparse_sample,
                         is_trimmed=args.dataset != "charades_ego")
    ds = VideoClassyDataset(dcfg, transform, label_mapping,
                            is_training=False)
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers)
    templates = (("#C C {}", "#C {}")
                 if getattr(args, "cls_use_template", False) else ("{}",))
    class_emb = build_label_embeddings(model, tokenizer, labels, templates)
    all_logits, all_labels = [], []
    for batch in loader:
        frames = np.asarray(batch["frames"])
        views = 1
        if frames.ndim == 6:  # (B, views, T, H, W, C): crops and/or clips
            views = frames.shape[1]
            frames = frames.reshape((-1,) + frames.shape[2:])
        logits = _l2(_encode_image(model, frames)) @ class_emb.T
        if views > 1:
            logits = logits.reshape(-1, views, logits.shape[-1]).max(axis=1)
        all_logits.append(logits)
        all_labels.append(np.asarray(batch["label"]))
    logits = np.concatenate(all_logits)
    labels_arr = np.concatenate(all_labels)
    if multilabel:
        mAP, _ = M.multilabel_map(logits, labels_arr)
        out = {"video_mAP": mAP}
    elif args.dataset == "egtea":
        cm = M.confusion_matrix(logits.argmax(axis=1), labels_arr,
                                len(labels))
        mean_acc, overall = M.mean_class_accuracy(cm)
        out = {"mean_class_acc": mean_acc, "acc": overall}
    else:
        acc1, acc5 = M.topk_accuracy(logits, labels_arr, ks=(1, 5))
        out = {"acc1": acc1, "acc5": acc5}
    print(json.dumps(out))
    return out


@torch.inference_mode()
def eval_mcq(args, model, tokenizer, model_name):
    mean, std = T.normalization_for_model(model_name)
    transform = T.EvalTransform(crop_shape(model_name)[0], mean, std)
    dcfg = DatasetConfig(dataset="ego4d_mcq", root=args.root,
                         metadata=args.metadata,
                         clip_length=args.clip_length,
                         clip_stride=args.clip_stride)
    ds = VideoMcqDataset(dcfg, transform, tokenizer, is_training=False)
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers)
    preds, answers, types = [], [], []
    for batch in loader:
        opts = batch["frames_options"]
        B, O = opts.shape[:2]
        vemb = _l2(_encode_image(model, opts.reshape((-1,) + opts.shape[2:])))
        qemb = _l2(_encode_text(model, batch["query"],
                                batch.get("query_mask")))
        preds.append(np.einsum("bd,bod->bo", qemb, vemb.reshape(B, O, -1)))
        answers.append(np.asarray(batch["answer"]))
        types.append(np.asarray(batch["type"]))
    out = M.egomcq_accuracy(np.concatenate(preds), np.concatenate(answers),
                            np.concatenate(types))
    print(json.dumps(out))
    return out


def main(args):
    model, tokenizer, model_name = load_model_from_checkpoint(args)
    if args.dataset == "ek100_mir":
        out = eval_ek100_mir(
            model, tokenizer, model_name, root=args.root,
            metadata=args.metadata, clip_length=args.clip_length,
            clip_stride=args.clip_stride, batch_size=args.batch_size,
            workers=args.workers, num_clips=args.num_clips,
            num_crops=args.num_crops,
            narration_selection=args.narration_selection,
            narration_pool=args.narration_pool,
            relevancy_path=args.relevancy_path or None)
    elif args.dataset == "ego4d_mcq":
        out = eval_mcq(args, model, tokenizer, model_name)
    else:
        from lavila_tpu_torch.data.label_maps import generate_label_map
        labels, mapping = generate_label_map(args.dataset,
                                             metadata=args.metadata)
        out = eval_classification(
            args, model, tokenizer, model_name, labels, mapping,
            multilabel=args.dataset == "charades_ego")
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main(get_args_parser().parse_args())
