"""Frame-id sampling — pure functions, unit-testable.

Same sampling semantics as the reference loader
(reference: lavila/data/datasets.py:25-102): uniform segments over the
requested span, optional per-segment jitter at train time, midpoint at
eval; chunked storage handled by :mod:`lavila_tpu_torch.data.video`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def uniform_frame_ids(start_frame: int, end_frame: int, num_segments: int,
                      jitter: bool = False,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Split [start_frame, end_frame) into ``num_segments`` equal segments
    and pick one frame per segment (random inside the segment when
    ``jitter``, midpoint otherwise)."""
    seg = (end_frame - start_frame - 1) / float(num_segments)
    ids = np.empty(num_segments, np.int64)
    if jitter and rng is None:
        rng = np.random.default_rng()
    for i in range(num_segments):
        lo = int(np.round(seg * i)) + start_frame
        hi = min(int(np.round(seg * (i + 1))) + start_frame, end_frame)
        if jitter:
            ids[i] = rng.integers(lo, hi + 1)
        else:
            ids[i] = (lo + hi) // 2
    return ids


def dense_window_ids(start_id: int, clip_length: int,
                     clip_stride: int) -> np.ndarray:
    """Strided dense window: start, start+s, ... (clip_length frames)."""
    return np.arange(start_id, start_id + clip_length * clip_stride,
                     clip_stride, dtype=np.int64)


def multi_clip_start_ids(total_frames: int, clip_length: int,
                         clip_stride: int, num_clips: int) -> np.ndarray:
    """Evenly spaced window starts for multi-clip evaluation."""
    span = clip_length * clip_stride
    return np.linspace(0, max(total_frames - span, 0), num_clips,
                       dtype=np.int64)


def clip_window_frame_ids(
    start_frame: int, end_frame: int, *, clip_length: int,
    clip_stride: int = 1, num_clips: int = 1, sparse: bool = False,
    jitter: bool = False, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Full sampling policy used by classification/retrieval datasets
    (reference datasets.py:273-317): sparse = uniform segments over the
    whole span; dense = strided windows (train: one random window; eval:
    ``num_clips`` evenly spaced windows). Returns flattened frame ids
    (num_clips*clip_length,). Short videos are padded by clamping ids to
    the last frame (callers may also zero-pad)."""
    if sparse:
        return uniform_frame_ids(start_frame, end_frame,
                                 num_clips * clip_length, jitter, rng)
    total = end_frame - start_frame
    span = clip_length * clip_stride
    if total < span:
        ids = np.arange(0, span, clip_stride, dtype=np.int64) + start_frame
        return np.minimum(ids, max(end_frame - 1, start_frame))
    if jitter:
        if rng is None:
            rng = np.random.default_rng()
        start = int(rng.integers(0, total - span + 1)) + start_frame
        return dense_window_ids(start, clip_length, clip_stride)
    starts = multi_clip_start_ids(total, clip_length, clip_stride,
                                  num_clips) + start_frame
    return np.concatenate(
        [dense_window_ids(s, clip_length, clip_stride) for s in starts])
