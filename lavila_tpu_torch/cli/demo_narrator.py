"""Narrator demo with the PyTorch port: caption one video clip.

Counterpart of ``cli/demo_narrator.py`` with the same flags plus
``--device`` (default ``cuda``), ``--bf16`` and the beam decoders'
``--num-beams`` (default: the JAX demo's 5, or 6 for ``group_beam``),
``--num-beam-groups`` and ``--length-penalty``. ``--decoding`` takes
sampling (``VCLM.generate``) or a beam decoder of ``models/beam.py``:
``beam``, ``beam_sample`` or ``group_beam``. ``--checkpoint`` reads a
narrator ``.pt``/``.pth``, released or written by the port's
``main_pretrain``; without one the weights are seeded random.
``--third-person`` is taken and, as in the JAX demo, never read.
Without ``--video-path`` a synthetic clip is written to the temporary
directory and captioned. Without the GPT-2 BPE files captions print as
raw token ids.

    python -m lavila_tpu_torch.cli.demo_narrator --device cpu
    python -m lavila_tpu_torch.cli.demo_narrator --bf16 \\
        --model VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL
"""

from __future__ import annotations

import argparse
import os.path as osp
import tempfile

import numpy as np
import torch

from lavila_tpu_torch.cli.eval_zeroshot import crop_shape
from lavila_tpu_torch.cli.main_infer_narrator import (captions,
                                                      load_narrator,
                                                      tokenizer_ids)
from lavila_tpu_torch.data import transforms as T
from lavila_tpu_torch.data.sampling import uniform_frame_ids
from lavila_tpu_torch.data.video import VideoReader, encode_test_video
from lavila_tpu_torch.models.beam import BeamDecoder


def get_args_parser():
    p = argparse.ArgumentParser("narrator demo (PyTorch port)")
    p.add_argument("--video-path", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--model",
                   default="VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI",
                   help="a VCLM_OPENAI_* narrator (TimeSformer or CLIP "
                        "ViT tower); LaViLa's Ego4D narrator is "
                        "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL")
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--num-return-sequences", type=int, default=5)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--decoding", default="sample",
                   choices=["sample", "beam", "beam_sample", "group_beam"])
    p.add_argument("--num-beams", type=int, default=None,
                   help="default 5, or 6 for --decoding group_beam (the "
                        "JAX demo's)")
    p.add_argument("--num-beam-groups", type=int, default=3)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--third-person", action="store_true",
                   help="accepted as the JAX demo takes it, unread there "
                        "too")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


def load_clip(args, crop: int) -> np.ndarray:
    """``--clip-length`` frames sampled uniformly over the video, centre
    cropped and normalised: ``(T, crop, crop, 3)``."""
    if not args.video_path:
        path = osp.join(tempfile.gettempdir(), "lavila_demo.mp4")
        if not osp.exists(path):
            encode_test_video(path, 256, 256, 30, 120)
        args.video_path = path
        print(f"(no --video-path; using synthetic clip {path})")
    vr = VideoReader(args.video_path)
    ids = uniform_frame_ids(0, len(vr), args.clip_length, jitter=False)
    frames = vr.get_batch(ids).astype(np.float32)
    vr.close()
    return T.EvalTransform(crop, T.OPENAI_MEAN, T.OPENAI_STD)(frames)


def main(args):
    clip = load_clip(args, crop_shape(args.model)[0])
    model = load_narrator(args)
    device = next(model.parameters()).device
    decode, bos, eos, pad = tokenizer_ids(args.model)
    with torch.inference_mode():
        image_tokens = model.encode_image(
            torch.from_numpy(np.ascontiguousarray(clip[None])).to(device))
        print(f"image tokens: {tuple(image_tokens.shape)}")
        if args.decoding == "sample":
            ids, ppl = model.generate(
                image_tokens, generator=torch.Generator(
                    device=device).manual_seed(args.seed),
                bos_id=bos, eos_id=eos, pad_id=pad, max_text_length=77,
                temperature=args.temperature, top_k=args.top_k or None,
                top_p=args.top_p,
                num_return_sequences=args.num_return_sequences)
            ids = ids.cpu().numpy()
            scores = -np.log(ppl.float().cpu().numpy())
        else:
            ids, scores = beam_decode(args, model, image_tokens, bos, eos,
                                      pad)
    for i, (text, score) in enumerate(zip(captions(ids, eos, decode),
                                          scores)):
        print(f"[{i}] (score {float(score):.3f}) {text}")
    return ids


def beam_decode(args, model, image_tokens, bos: int, eos: int, pad: int):
    """``--decoding beam``, ``beam_sample`` or ``group_beam`` over one
    clip's image tokens, with the JAX demo's settings: ``(ids, scores)``
    as numpy arrays."""
    dec = BeamDecoder(model, bos_id=bos, eos_id=eos, pad_id=pad,
                      max_text_length=77)
    nrs = args.num_return_sequences
    beams = args.num_beams or (6 if args.decoding == "group_beam" else 5)
    if args.decoding == "beam":
        return dec.beam_search(image_tokens, num_beams=beams,
                               num_return_sequences=nrs,
                               length_penalty=args.length_penalty)
    if args.decoding == "beam_sample":
        return dec.beam_sample(image_tokens,
                               rng=np.random.default_rng(args.seed),
                               num_beams=beams,
                               temperature=args.temperature,
                               top_p=args.top_p, num_return_sequences=nrs,
                               length_penalty=args.length_penalty)
    return dec.group_beam_search(image_tokens, num_beams=beams,
                                 num_beam_groups=args.num_beam_groups,
                                 num_return_sequences=nrs,
                                 length_penalty=args.length_penalty)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
