"""Host-side video transforms in numpy (channel-last, TPU-native layout).

The reference composes torchvision ops on (C, T, H, W) tensors
(reference: lavila/data/video_transforms.py, main_pretrain.py:263-281).
Here clips are ``(T, H, W, C)`` float32 throughout — the layout the
TimeSformer consumes directly — and transforms are numpy so DataLoader
workers stay off the device. Multi-view eval (TemporalCrop/SpatialCrop
3-crop) reproduces the reference's test-time protocol
(reference video_transforms.py:33-186).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

# normalization constants (×255 scale, as in the reference mains)
OPENAI_MEAN = np.array([108.3272985, 116.7460125, 104.09373615], np.float32)
OPENAI_STD = np.array([68.5005327, 66.6321579, 70.32316305], np.float32)
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalization_for_model(model_name: str):
    """OpenAI-CLIP stats for *_OPENAI_* models, ImageNet otherwise
    (reference main_pretrain.py:263-281)."""
    if "OPENAI" in model_name:
        return OPENAI_MEAN, OPENAI_STD
    return IMAGENET_MEAN, IMAGENET_STD


_RESIZE_W_CACHE: dict = {}


def _resize_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) sparse-bilinear interpolation matrix
    (align_corners=False)."""
    key = (src, dst)
    w = _RESIZE_W_CACHE.get(key)
    if w is None:
        pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        lo = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
        hi = np.clip(lo + 1, 0, src - 1)
        frac = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
        w = np.zeros((dst, src), np.float32)
        w[np.arange(dst), lo] += 1.0 - frac
        w[np.arange(dst), hi] += frac
        _RESIZE_W_CACHE[key] = w
    return w


def resize(clip: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize as two BLAS matmuls (align_corners=False).
    clip (T, H, W, C) float32 → (T, out_h, out_w, C)."""
    t, h, w, c = clip.shape
    if (h, w) == (out_h, out_w):
        return clip
    wy = _resize_weights(h, out_h)           # (out_h, h)
    wx = _resize_weights(w, out_w)           # (out_w, w)
    x = clip.astype(np.float32, copy=False)
    # rows: (T*?): fold (w c) → one GEMM per clip
    x = np.matmul(wy, x.reshape(t, h, w * c))          # (t, out_h, w*c)
    x = x.reshape(t * out_h, w, c).transpose(0, 2, 1)  # (t*out_h, c, w)
    x = np.matmul(x.reshape(t * out_h * c, w), wx.T)   # (t*out_h*c, out_w)
    x = x.reshape(t, out_h, c, out_w).transpose(0, 1, 3, 2)
    return np.ascontiguousarray(x)


def resize_short_side(clip: np.ndarray, size: int) -> np.ndarray:
    h, w = clip.shape[1:3]
    if w <= h:
        return resize(clip, int(round(h / w * size)), size)
    return resize(clip, size, int(round(w / h * size)))


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    h, w = clip.shape[1:3]
    y = int(math.ceil((h - size) / 2))
    x = int(math.ceil((w - size) / 2))
    return clip[:, y:y + size, x:x + size]


def random_resized_crop(clip: np.ndarray, size: int,
                        scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3),
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """torchvision RandomResizedCrop semantics, same crop for all frames."""
    rng = rng or np.random.default_rng()
    h, w = clip.shape[1:3]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            return resize(clip[:, y:y + ch, x:x + cw], size, size)
    # fallback: center crop of the short side
    s = min(h, w)
    return resize(center_crop(clip, s), size, size)


def horizontal_flip(clip: np.ndarray,
                    rng: Optional[np.random.Generator] = None,
                    p: float = 0.5) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if rng.random() < p:
        return clip[:, :, ::-1]
    return clip


def normalize(clip: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    return (clip - mean) / std


def uniform_crop_3(clip: np.ndarray, size: int) -> list[np.ndarray]:
    """Left/center/right (or top/center/bottom) 3-crop
    (reference video_transforms.py:76-132)."""
    h, w = clip.shape[1:3]
    y = int(math.ceil((h - size) / 2))
    x = int(math.ceil((w - size) / 2))
    crops = []
    for idx in range(3):
        yy, xx = y, x
        if h > w:
            yy = 0 if idx == 0 else (h - size if idx == 2 else y)
        else:
            xx = 0 if idx == 0 else (w - size if idx == 2 else x)
        crops.append(clip[:, yy:yy + size, xx:xx + size])
    return crops


def temporal_crops(clip: np.ndarray, frames_per_clip: int, stride: int,
                   frame_stride: int = 1) -> list[np.ndarray]:
    """Sliding temporal windows (reference video_transforms.py:33-54)."""
    T = clip.shape[0]
    out = []
    for start in range(0, T - frames_per_clip * frame_stride + 1, stride):
        out.append(clip[start:start + frames_per_clip * frame_stride:
                        frame_stride])
    return out


class TrainTransform:
    """Pretrain-time pipeline: RandomResizedCrop(crop, scale=(0.5,1)) +
    normalize (reference main_pretrain.py:263-273; flips are NOT used at
    pretrain time in the reference)."""

    def __init__(self, crop_size: int, mean=OPENAI_MEAN, std=OPENAI_STD,
                 scale=(0.5, 1.0), flip: bool = False, seed=None):
        self.crop_size = crop_size
        self.mean, self.std = mean, std
        self.scale = scale
        self.flip = flip
        self.rng = np.random.default_rng(seed)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        clip = random_resized_crop(clip, self.crop_size, scale=self.scale,
                                   rng=self.rng)
        if self.flip:
            clip = horizontal_flip(clip, rng=self.rng)
        return normalize(clip, self.mean, self.std).astype(np.float32)


class EvalTransform:
    """Eval pipeline: short-side resize + center crop + normalize
    (reference main_pretrain.py:274-281). Multi-view test-time protocol
    (reference eval_zeroshot.py:117-125): with ``num_temporal_clips > 1``
    the incoming T = num_temporal_clips × frames_per_clip frames are split
    into sliding windows (reference TemporalCrop), and with
    ``num_spatial_crops=3`` each window is left/center/right 3-cropped
    (reference SpatialCrop), and ``num_spatial_crops=6`` extends that
    with the 3 crops of the horizontally flipped window, in the
    reference's order — [crop0, crop1, crop2, flip-crop0, flip-crop1,
    flip-crop2] per window (reference video_transforms.py:147-154,
    166-186); all views stack on a leading axis — (views, T, H, W, C)
    with views = clips × crops. Unsupported crop counts raise like the
    reference (video_transforms.py:160-165), never silently degrade."""

    def __init__(self, crop_size: int, mean=OPENAI_MEAN, std=OPENAI_STD,
                 num_spatial_crops: int = 1,
                 resize_size: Optional[int] = None,
                 num_temporal_clips: int = 1,
                 frames_per_clip: Optional[int] = None):
        if num_spatial_crops not in (1, 3, 6):
            raise NotImplementedError(
                f"num_spatial_crops={num_spatial_crops} unsupported; the "
                "test-time protocol takes 1 (center), 3 (left/center/"
                "right) or 6 (3-crop + flipped 3-crop), as in the "
                "reference SpatialCrop")
        self.crop_size = crop_size
        self.resize_size = resize_size or crop_size
        self.mean, self.std = mean, std
        self.num_spatial_crops = num_spatial_crops
        self.num_temporal_clips = num_temporal_clips
        self.frames_per_clip = frames_per_clip

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        clip = resize_short_side(clip, self.resize_size)
        if self.num_temporal_clips > 1:
            fpc = self.frames_per_clip or (
                clip.shape[0] // self.num_temporal_clips)
            windows = temporal_crops(clip, fpc, fpc)
        else:
            windows = [clip]
        views = []
        for w in windows:
            if self.num_spatial_crops in (3, 6):
                views.extend(uniform_crop_3(w, self.crop_size))
                if self.num_spatial_crops == 6:
                    views.extend(uniform_crop_3(w[:, :, ::-1],
                                                self.crop_size))
            else:
                views.append(center_crop(w, self.crop_size))
        views = [normalize(v, self.mean, self.std).astype(np.float32)
                 for v in views]
        return views[0] if len(views) == 1 else np.stack(views)
