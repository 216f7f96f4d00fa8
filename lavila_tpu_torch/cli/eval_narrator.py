"""Narrator evaluation with the PyTorch port: teacher-forced perplexity,
free decoding and the NLG metrics.

Counterpart of ``cli/eval_narrator.py`` (the reference eval_narrator.py)
with the same flags plus ``--device`` (default ``cuda``; with ``cuda``
and no card it raises). Per batch of clips:

  * the image tokens (``VCLM.encode_image``);
  * the teacher-forced perplexity against the clip's narration:
    ``VCLM.generate(target, teacher_forcing=True)``, the decoder fed the
    narration's tokens through its cache (K9 a layer a step on a CUDA
    tensor);
  * captions by ``--decoding``: ``sample`` (``generate`` at
    ``--temperature``, ``--top-k``, ``--top-p``), ``beam`` (beam search),
    ``beam_sample`` or ``group_beam`` (``models/beam.py``), each of the
    ``--num-return-sequences`` candidates of a clip scored against the
    clip's narrations (reference eval_narrator.py:215-261).

Then hypotheses and references are normalised as the reference does
(through a BERT tokenizer's round trip when a WordPiece vocabulary is
found under ``$LAVILA_TOKENIZER_DIR``, else its basic stage) and scored
by ``eval/nlg.py`` (BLEU-1..4, METEOR, ROUGE-L, CIDEr); the scores and
the mean teacher-forced perplexity print as one JSON line and go to
``--output-json``.

Weights are seeded random (``--seed``) unless ``--checkpoint`` (else
``checkpoint_best.pt`` under ``--output-dir``) names a narrator
``.pt``/``.pth``, released, written by the port's ``main_pretrain`` or
exported from a JAX run by ``scripts/export_jax_checkpoint.py``.
``--early-stop`` and ``--sparse-sample`` are taken and change nothing,
as in the JAX CLI.

    python -m lavila_tpu_torch.cli.eval_narrator --dataset ego4d \\
        --root datasets/Ego4D/video_288px \\
        --metadata datasets/Ego4D/ego4d_val.pkl \\
        --model VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL --bf16 \\
        --decoding beam --checkpoint vclm_flagship.pth
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from lavila_tpu_torch.cli.eval_zeroshot import crop_shape
from lavila_tpu_torch.cli.main_infer_narrator import (captions,
                                                      check_beam_groups,
                                                      load_narrator)
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import DatasetConfig, VideoCaptionDataset
from lavila_tpu_torch.data.loader import DataLoader
from lavila_tpu_torch.data.tokenizers import (WordPieceTokenizer,
                                              generate_tokenizer)
from lavila_tpu_torch.eval.nlg import bert_style_normalize, nlg_scores
from lavila_tpu_torch.models.beam import BeamDecoder


def get_args_parser():
    p = argparse.ArgumentParser("narrator evaluation (PyTorch port)")
    p.add_argument("--dataset", default="ego4d")
    p.add_argument("--root", default="")
    p.add_argument("--metadata", "--metadata-val", dest="metadata",
                   default="",
                   help="val metadata pkl (reference --metadata-val)")
    p.add_argument("--checkpoint", "--resume", dest="checkpoint",
                   default="")
    p.add_argument("--output-dir", default="",
                   help="when no --checkpoint/--resume is given, load "
                        "checkpoint_best.pt from here (reference "
                        "eval_narrator.py:93-94)")
    p.add_argument("--model",
                   default="VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI")
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--clip-stride", type=int, default=16,
                   help="reference --clip-stride (eval_narrator.py:62)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--eval-freq", type=int, default=100,
                   help="evaluate every k-th sample (val subsampling)")
    p.add_argument("--decoding", default="sample",
                   choices=["sample", "beam", "beam_sample", "group_beam"])
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--num-return-sequences", type=int, default=1,
                   help="candidates per clip, each scored against the "
                        "clip's references (reference "
                        "--caption-num-return-sequences)")
    p.add_argument("--num-beams", type=int, default=3,
                   help="reference --caption-num-beams")
    p.add_argument("--num-beam-groups", type=int, default=3,
                   help="for --decoding group_beam; must divide "
                        "--num-beams and be > 1 (reference "
                        "--caption-num-beam-groups)")
    p.add_argument("--length-penalty", type=float, default=1.0,
                   help="reference --caption-length-penalty")
    p.add_argument("--max-text-length", type=int, default=77,
                   help="reference --caption-max-len")
    p.add_argument("--num-clips", type=int, default=1,
                   help="values > 1 are refused, as by the JAX CLI: the "
                        "reference's multi-view branch cannot be scored")
    p.add_argument("--num-crops", type=int, default=1,
                   help="see --num-clips")
    p.add_argument("--early-stop", action="store_true",
                   help="accepted as the JAX CLI takes it: decoding always "
                        "stops once every row has sampled EOS")
    p.add_argument("--sparse-sample", action="store_true",
                   help="accepted as the JAX CLI takes it, unread there "
                        "too (the reference evaluates dense clips)")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-json", "--caption-output-filename",
                   dest="output_json", default="")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 weights and compute (the reference's "
                        "--use-half)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


def _wordpiece():
    """A BERT WordPiece tokenizer from ``$LAVILA_TOKENIZER_DIR`` where
    one is there, else None (the basic normalisation)."""
    assets = os.environ.get("LAVILA_TOKENIZER_DIR", "")
    for name in ("bert-base-uncased", "distilbert-base-uncased"):
        vocab = osp.join(assets, name, "vocab.txt")
        if osp.exists(vocab):
            return WordPieceTokenizer(vocab)
    return None


def decode_batch(args, model, dec: BeamDecoder, toks, gen, bos, eos,
                 pad) -> np.ndarray:
    """The ``--decoding`` captions of one batch's image tokens: ``(B·nrs,
    max_text_length)`` ids. ``beam_sample`` draws from a host generator
    seeded ``--seed`` afresh for each batch, as the JAX CLI does."""
    nrs = args.num_return_sequences
    if args.decoding == "sample":
        ids, _ = model.generate(
            toks, generator=gen, bos_id=bos, eos_id=eos, pad_id=pad,
            max_text_length=args.max_text_length,
            temperature=args.temperature, top_k=args.top_k or None,
            top_p=args.top_p, num_return_sequences=nrs)
        return ids.cpu().numpy()
    beams = dict(num_beams=args.num_beams, num_return_sequences=nrs,
                 length_penalty=args.length_penalty)
    if args.decoding == "beam":
        ids, _ = dec.beam_search(toks, **beams)
    elif args.decoding == "beam_sample":
        ids, _ = dec.beam_sample(
            toks, rng=np.random.default_rng(args.seed),
            temperature=args.temperature, top_p=args.top_p, **beams)
    else:
        ids, _ = dec.group_beam_search(
            toks, num_beam_groups=args.num_beam_groups, **beams)
    return ids


def main(args):
    if args.num_clips > 1 or args.num_crops > 1:
        raise SystemExit(
            "multi-view narrator eval is not supported (the reference's "
            "num_clips/num_crops > 1 branch is itself non-functional)")
    check_beam_groups(args)
    # the checkpoint's precedence is the reference's (eval_narrator.py:
    # 91-94): an explicit path, else checkpoint_best under --output-dir
    if not args.checkpoint and args.output_dir:
        best = osp.join(args.output_dir, "checkpoint_best.pt")
        if osp.exists(best):
            args.checkpoint = best
    model = load_narrator(args)
    device = next(model.parameters()).device
    crop = crop_shape(args.model)[0]
    transform = T.EvalTransform(crop, *T.normalization_for_model(args.model))
    tokenizer = generate_tokenizer(args.model)
    bos, eos, pad = (tokenizer.bos_token_id, tokenizer.eos_token_id,
                     tokenizer.pad_token_id)

    dcfg = DatasetConfig(dataset=args.dataset, root=args.root,
                         metadata=args.metadata,
                         clip_length=args.clip_length,
                         clip_stride=args.clip_stride,
                         subsample_stride=args.eval_freq,
                         narration_selection="random")
    ds = VideoCaptionDataset(dcfg, transform, tokenizer, is_training=False,
                             seed=args.seed)
    # the raw narrations, the NLG references
    raw = VideoCaptionDataset(dcfg, None, None, is_training=False,
                              seed=args.seed)
    if args.max_samples:
        ds.samples = ds.samples[:args.max_samples]
        raw.samples = raw.samples[:args.max_samples]
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers)
    dec = BeamDecoder(model, bos_id=bos, eos_id=eos, pad_id=pad,
                      max_text_length=args.max_text_length)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    ppls, hyps, refs = [], [], []
    sample_idx = 0
    for bi, batch in enumerate(loader):
        if bi % args.print_freq == 0:
            print(f"[{bi}/{len(loader)}]", flush=True)
        frames = torch.from_numpy(np.ascontiguousarray(batch["frames"]))
        target = torch.from_numpy(np.asarray(batch["text"])).long().to(
            device)
        with torch.inference_mode():
            toks = model.encode_image(frames.to(device))
            _, tf_ppl = model.generate(
                toks, generator=gen, bos_id=bos, eos_id=eos, pad_id=pad,
                max_text_length=target.shape[1], target=target,
                teacher_forcing=True)
            ppls.extend(tf_ppl.float().cpu().tolist())
            ids = decode_batch(args, model, dec, toks, gen, bos, eos, pad)
        hyps.extend(c.strip() for c in captions(ids, eos, tokenizer.decode))
        n = frames.shape[0]
        for j in range(n):
            narration = raw.samples[sample_idx + j][3]
            rr = narration if isinstance(narration, list) else [narration]
            # each candidate scores against the same references
            # (reference eval_narrator.py:259-261)
            refs.extend([rr] * args.num_return_sequences)
        sample_idx += n

    # hypotheses and references renormalised through a BERT tokenizer
    # before scoring (reference eval_narrator.py:267-271)
    wordpiece = _wordpiece()
    hyps = [bert_style_normalize(h, wordpiece) for h in hyps]
    refs = [[bert_style_normalize(r, wordpiece) for r in rr] for rr in refs]
    out = nlg_scores(hyps, refs)
    out["teacher_ppl"] = float(np.mean(ppls))
    print(json.dumps(out))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main(get_args_parser().parse_args())
