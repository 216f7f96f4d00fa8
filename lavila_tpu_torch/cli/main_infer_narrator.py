"""Narrator inference with the PyTorch port: pseudo-label clips.

Counterpart of ``cli/main_infer_narrator.py`` with its flags plus
``--device`` (default ``cuda``; with ``cuda`` and no card it raises).
Each batch of clips is encoded, then captioned by sampled decoding
(``VCLM.generate``: KV cache, K9 for the decoder's self-attention) or,
with ``--decoding beam_sample`` / ``group_beam``, by the beam decoders
(``models/beam.py``, ``--num-beams``, ``--num-beam-groups``,
``--length-penalty``; the stored scores are then the beams' joint
scores, as the JAX CLI and the reference store them), and
the records ``(video_uid, t_start, t_end, captions, ppls)`` are written
to ``cache.{rank}.pkl`` and, merged, to ``total.pkl``: the output
contract of the JAX CLI and of the reference, which the pretraining's
SSL path reads. In a process group (``parallel/mesh.py``, started by
``lavila_tpu_torch.cli.launch infer_narrator`` or by a caller that
joined one) each rank narrates its shard of the clips (the sampler's
round-robin slice, padded to a multiple of the world size with the first
clips again, as the JAX CLI's and the reference's), its draws seeded
``--seed`` + rank, and writes its ``cache.{rank}.pkl``; after a barrier
rank 0 merges the shards round-robin into ``total.pkl``: the clips in
dataset order, then the padding's repeats (the JAX CLI's
``total.pkl``). One process writes ``cache.0.pkl`` and ``total.pkl``
with the same records.

Weights are seeded random (``--seed``, drawn on ``--device``) unless
``--checkpoint`` names a narrator ``.pt``/``.pth``: a released one, or
one the port's ``main_pretrain`` wrote (``--gated-xattn``), or a JAX
run's written as one by ``scripts/export_jax_checkpoint.py``; its tower
depths must match ``--model``. Without the GPT-2 BPE files (looked up
under ``$LAVILA_TOKENIZER_DIR``) captions are printed as raw token ids,
as the JAX CLI does. ``--early-stop`` is taken and changes nothing, as
in the JAX CLI (decoding always stops once every row has sampled
EOS).

    python -m lavila_tpu_torch.cli.main_infer_narrator --dataset synthetic \\
        --model VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL --bf16

(``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL`` is the narrator LaViLa
used to narrate Ego4D: TSF-L at 336², its frames cropped to 336. The
CLIP ViT narrators, ``VCLM_OPENAI_VIT*``, condition on every frame's
patch tokens; a checkpoint's ViT depth is read under
``visual.transformer.resblocks.``.)
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from lavila_tpu_torch.cli.eval_zeroshot import crop_shape, resolve_device
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.datasets import DatasetConfig, VideoCaptionDataset
from lavila_tpu_torch.data.loader import DataLoader
from lavila_tpu_torch.data.tokenizers import generate_tokenizer
from lavila_tpu_torch.kernels.decode import HEAD_DIM
from lavila_tpu_torch.models import build_model
from lavila_tpu_torch.models.beam import BeamDecoder
from lavila_tpu_torch.models.convert import (checkpoint_state_dict,
                                             count_layers,
                                             is_port_checkpoint,
                                             narrator_state_dict)
from lavila_tpu_torch.parallel import mesh


def get_args_parser():
    p = argparse.ArgumentParser("narrator inference (PyTorch port)")
    p.add_argument("--dataset", default="ego4d")
    p.add_argument("--root", default="datasets/Ego4D/video_288px")
    p.add_argument("--metadata", default="datasets/Ego4D/ego4d_train.pkl")
    p.add_argument("--checkpoint", "--resume", dest="checkpoint",
                   default="", help="released narrator .pt/.pth")
    p.add_argument("--model",
                   default="VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI",
                   help="a VCLM_OPENAI_* narrator (TimeSformer or CLIP "
                        "ViT tower); LaViLa's Ego4D narrator is "
                        "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL")
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--clip-stride", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--decoding", default="sample",
                   choices=["sample", "beam_sample", "group_beam"])
    p.add_argument("--num-return-sequences", type=int, default=10)
    p.add_argument("--num-beams", type=int, default=3,
                   help="reference --caption-num-beams")
    p.add_argument("--num-beam-groups", type=int, default=3,
                   help="for --decoding group_beam (reference "
                        "--caption-num-beam-groups); must be > 1 and "
                        "divide --num-beams")
    p.add_argument("--length-penalty", type=float, default=1.0,
                   help="reference --caption-length-penalty")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--max-text-length", type=int, default=77)
    p.add_argument("--early-stop", action="store_true",
                   help="accepted as the JAX CLI takes it: decoding always "
                        "stops once every row has sampled EOS")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--output-dir", default="narrator_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 weights and compute (the reference's "
                        "--use-half)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


def check_decode_device(model_name: str, head_dim: int,
                        device: torch.device) -> None:
    """The decode kernel on the card takes one head width; a narrator
    with another (the MINI one's 16) decodes only on the CPU."""
    if device.type == "cuda" and head_dim != HEAD_DIM:
        raise ValueError(
            f"{model_name}: its decoder's heads are {head_dim} wide and the "
            f"CUDA decode kernel takes {HEAD_DIM}; run it with --device "
            "cpu, or pick a GPT-2 narrator (--model "
            "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL, LaViLa's Ego4D "
            "narrator)")


def narrator_checkpoint(path: str, num_frames: int) -> dict:
    """A narrator checkpoint's weights in the port's names: the port's
    own (``main_pretrain``'s ``checkpoint_*.pt``, already in them) or a
    released one (:func:`narrator_state_dict`), ``temporal_embed`` fitted
    to ``num_frames``. The file is mapped, not read whole: a train
    checkpoint also holds the optimizer's moments."""
    if not path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            f"{path}: only .pt/.pth checkpoints load into the port; write "
            "a JAX run's Orbax checkpoint as one with "
            "scripts/export_jax_checkpoint.py")
    # released checkpoints pickle their argparse namespace beside the
    # weights, which weights_only=True refuses
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      mmap=True)
    sd = checkpoint_state_dict(ckpt, num_frames)
    return sd if is_port_checkpoint(ckpt) else narrator_state_dict(sd)


def tower_depth(visual) -> dict[str, int]:
    """The video tower's block prefix in a narrator's state dict and its
    depth: a TimeSformer's ``visual.blocks.``, a CLIP ViT's
    ``visual.transformer.resblocks.``."""
    if hasattr(visual, "blocks"):
        return {"visual.blocks.": len(visual.blocks)}
    return {"visual.transformer.resblocks.":
            len(visual.transformer.resblocks)}


def load_narrator(args):
    """Build ``--model`` (gated cross-attention, as the JAX CLI builds
    it) on ``--device`` from a generator seeded ``--seed`` there, load
    ``--checkpoint`` when given (strict; :func:`narrator_checkpoint`),
    cast to bf16 with ``--bf16``. Returns the model in eval mode."""
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(args.model, device=device,
                        dtype=torch.bfloat16 if args.bf16 else torch.float32,
                        generator=gen, num_frames=args.clip_length,
                        gated_xattn=True)
    check_decode_device(args.model, model.text_decoder.cfg.head_dim, device)
    if args.checkpoint:
        sd = narrator_checkpoint(args.checkpoint, args.clip_length)
        # depths come from the checkpoint, never from the model name
        depths = {**tower_depth(model.visual),
                  "text_decoder.transformer.h.":
                      len(model.text_decoder.transformer.h)}
        for prefix, want in depths.items():
            if count_layers(sd, prefix) != want:
                raise ValueError(
                    f"{args.checkpoint}: {count_layers(sd, prefix)} layers "
                    f"under {prefix!r}, {args.model} has {want}")
        model.load_state_dict(sd, strict=True)
    return model


def tokenizer_ids(model_name: str):
    """``(decode, bos, eos, pad)``: the GPT-2 tokenizer's, or raw ids and
    GPT-2's ids when its BPE files are absent."""
    try:
        tok = generate_tokenizer(model_name)
        return (tok.decode, tok.bos_token_id, tok.eos_token_id,
                tok.pad_token_id)
    except (FileNotFoundError, OSError):
        return (lambda ids: " ".join(map(str, ids))), 50256, 50256, 0


def captions(ids: np.ndarray, eos: int, decode) -> list[str]:
    """Each row's text after BOS, up to its first EOS."""
    out = []
    for row in ids:
        row = list(row[1:])
        if eos in row:
            row = row[:row.index(eos)]
        out.append(decode(row))
    return out


def check_beam_groups(args) -> None:
    """``--decoding group_beam`` needs ``--num-beam-groups`` > 1 dividing
    ``--num-beams`` (reference main_infer_narrator.py:203)."""
    if args.decoding == "group_beam" and not (
            args.num_beam_groups > 1
            and args.num_beams % args.num_beam_groups == 0):
        raise SystemExit(
            "--decoding group_beam needs --num-beam-groups > 1 dividing "
            "--num-beams (reference main_infer_narrator.py:203)")


def merge_shards(shards: list[list]) -> list:
    """The ranks' records round-robin: record i of every rank in rank
    order, then record i + 1 (JAX :221-240, reference :232-251), which
    puts the sampler's round-robin shards back in dataset order."""
    return [s[i] for i in range(max(map(len, shards), default=0))
            for s in shards if i < len(s)]


def main(args):
    check_beam_groups(args)
    world, rank = mesh.world(), mesh.rank()
    os.makedirs(args.output_dir, exist_ok=True)
    model = load_narrator(args)
    device = next(model.parameters()).device
    crop = crop_shape(args.model)[0]
    transform = T.EvalTransform(crop, *T.normalization_for_model(args.model))
    dcfg = DatasetConfig(dataset=args.dataset, root=args.root,
                         metadata=args.metadata,
                         clip_length=args.clip_length,
                         clip_stride=args.clip_stride)
    ds = VideoCaptionDataset(dcfg, transform, tokenizer=None,
                             is_training=False)
    if args.max_samples:
        ds.samples = ds.samples[:args.max_samples]
    samples_meta = ds.samples
    # each batch carries the global indices of its samples, so the
    # (video_uid, captions) pairing does not depend on the sampler
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers, shard_index=rank,
                        num_shards=world, with_indices=True)
    decode, bos, eos, pad = tokenizer_ids(args.model)
    gen = torch.Generator(device=device).manual_seed(args.seed + rank)
    dec = BeamDecoder(model, bos_id=bos, eos_id=eos, pad_id=pad,
                      max_text_length=args.max_text_length)
    beam_rng = np.random.default_rng(args.seed + rank)
    nrs = args.num_return_sequences
    warp = dict(temperature=args.temperature, top_p=args.top_p,
                top_k=args.top_k or None)
    beams = dict(num_beams=args.num_beams, num_return_sequences=nrs,
                 length_penalty=args.length_penalty, **warp)
    records = []
    t0 = time.perf_counter()
    for bi, batch in enumerate(loader):
        frames = torch.from_numpy(np.ascontiguousarray(batch["frames"]))
        with torch.inference_mode():
            toks = model.encode_image(frames.to(device))
            if args.decoding == "sample":
                ids, ppls = model.generate(
                    toks, generator=gen, bos_id=bos, eos_id=eos,
                    pad_id=pad, max_text_length=args.max_text_length,
                    num_return_sequences=nrs, **warp)
                ids, ppls = ids.cpu().numpy(), ppls.float().cpu().numpy()
            elif args.decoding == "beam_sample":
                ids, ppls = dec.beam_sample(toks, rng=beam_rng, **beams)
            else:
                ids, ppls = dec.group_beam_search(
                    toks, num_beam_groups=args.num_beam_groups, **beams)
        for j in range(frames.shape[0]):
            meta = samples_meta[int(batch["index"][j])]
            rows = slice(j * nrs, (j + 1) * nrs)
            records.append((meta[0], meta[1], meta[2],
                            captions(ids[rows], eos, decode),
                            ppls[rows].tolist()))
        if bi % args.print_freq == 0:
            print(f"[rank {rank}] {bi}/{len(loader)} "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)

    shard_path = osp.join(args.output_dir, f"cache.{rank}.pkl")
    with open(shard_path, "wb") as f:
        pickle.dump(records, f)
    print(f"[rank {rank}] wrote {len(records)} records -> {shard_path}")
    mesh.barrier()
    if rank == 0:
        shards = []
        for r in range(world):
            with open(osp.join(args.output_dir, f"cache.{r}.pkl"),
                      "rb") as f:
                shards.append(pickle.load(f))
        merged = merge_shards(shards)
        total = osp.join(args.output_dir, "total.pkl")
        with open(total, "wb") as f:
            pickle.dump(merged, f)
        print(f"merged {len(merged)} records -> {total}")
    return records


if __name__ == "__main__":
    main(get_args_parser().parse_args())
