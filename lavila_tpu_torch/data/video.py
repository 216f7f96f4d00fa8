"""Video decode: ctypes binding over the native C++ core + loaders.

The native library (native/videodec.cpp, FFmpeg-backed) replaces decord
(reference: lavila/data/datasets.py:15) — random frame access, fps/frame
probing and fused scale→RGB on the host. The loaders reproduce the
reference's chunked-storage semantics: Ego4D videos are stored as
``chunk_len``-second mp4 chunks at fixed fps, and a clip near a chunk
boundary stitches frames from the next chunk
(reference datasets.py:25-75). Decode failures degrade to
frame-0/zero-frames like the reference (datasets.py:53-57, 98-101).
"""

from __future__ import annotations

import ctypes
import functools
import os
import os.path as osp
import subprocess
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from lavila_tpu_torch.data.sampling import uniform_frame_ids

_NATIVE_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "native")
_LIB_PATH = osp.join(_NATIVE_DIR, "libvideodec.so")


@functools.lru_cache()
def _load_lib(path: str = _LIB_PATH):
    if not osp.exists(path):
        src = osp.join(osp.dirname(path), "videodec.cpp")
        if osp.exists(src):  # self-bootstrap the native core
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", src,
                 "-o", path, "-lavformat", "-lavcodec", "-lswscale",
                 "-lavutil"], check=True)
        else:
            raise FileNotFoundError(
                f"native decoder not found at {path}; build native/ first")
    lib = ctypes.CDLL(path)
    lib.vdec_open.restype = ctypes.c_void_p
    lib.vdec_open.argtypes = [ctypes.c_char_p]
    lib.vdec_fps.restype = ctypes.c_double
    lib.vdec_fps.argtypes = [ctypes.c_void_p]
    lib.vdec_num_frames.restype = ctypes.c_longlong
    lib.vdec_num_frames.argtypes = [ctypes.c_void_p]
    lib.vdec_width.restype = ctypes.c_int
    lib.vdec_width.argtypes = [ctypes.c_void_p]
    lib.vdec_height.restype = ctypes.c_int
    lib.vdec_height.argtypes = [ctypes.c_void_p]
    lib.vdec_read_frames.restype = ctypes.c_int
    lib.vdec_read_frames.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
    lib.vdec_close.argtypes = [ctypes.c_void_p]
    lib.vdec_encode_test.restype = ctypes.c_int
    lib.vdec_encode_test.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


class VideoReader:
    """Random-access frame reader over the native core."""

    def __init__(self, path: str, out_size: Optional[tuple[int, int]] = None):
        self._lib = _load_lib()
        self._h = self._lib.vdec_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.path = path
        self.out_size = out_size  # (h, w) or None for native

    @property
    def fps(self) -> float:
        return self._lib.vdec_fps(self._h)

    def __len__(self) -> int:
        return int(self._lib.vdec_num_frames(self._h))

    @property
    def shape(self) -> tuple[int, int]:
        return (self._lib.vdec_height(self._h),
                self._lib.vdec_width(self._h))

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode frames -> (N, H, W, 3) uint8 RGB."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if self.out_size is not None:
            h, w = self.out_size
        else:
            h, w = self.shape
        out = np.empty((len(idx), h, w, 3), np.uint8)
        fails = self._lib.vdec_read_frames(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w, h)
        if fails == len(idx):
            raise IOError(f"all {fails} frame decodes failed: {self.path}")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vdec_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def encode_test_video(path: str, width: int = 64, height: int = 64,
                      fps: int = 30, num_frames: int = 90) -> None:
    """Synthesize a deterministic mp4 (frame k has luma (16+3k)%240)."""
    ret = _load_lib().vdec_encode_test(path.encode(), width, height, fps,
                                       num_frames)
    if ret != 0:
        raise IOError(f"test encode failed ({ret}): {path}")


@functools.lru_cache(maxsize=256)
def _probe_fps(path: str) -> float:
    r = VideoReader(path)
    try:
        return r.fps
    finally:
        r.close()


class _ReaderPool(threading.local):
    """Thread-local LRU of open readers: container open + stream probing
    costs ~5-15 ms per file, which dominates short-clip loading when every
    sample re-opens its chunk. Handles are NOT shared across threads (the
    decoder is stateful per handle)."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self.readers: "OrderedDict[str, VideoReader]" = OrderedDict()

    def get(self, path: str) -> "VideoReader":
        r = self.readers.pop(path, None)
        if r is None:
            r = VideoReader(path)
        self.readers[path] = r
        while len(self.readers) > self.capacity:
            _, old = self.readers.popitem(last=False)
            old.close()
        return r


_pool = _ReaderPool()


def open_reader(path: str) -> "VideoReader":
    """Pooled (thread-local) reader — do NOT close; the pool owns it."""
    return _pool.get(path)


def video_loader(root: str, vid: str, second: float,
                 end_second: Optional[float] = None, *, chunk_len: int = 300,
                 fps: float = 30, clip_length: int = 32,
                 jitter: bool = False,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Load a clip from (possibly chunked) storage as float32
    (T, H, W, 3).

    chunk_len == -1 → single file ``root/vid.mp4``; otherwise
    ``root/vid.mp4/{chunk_start}.mp4`` with cross-chunk stitching,
    same contract as the reference loader (reference datasets.py:25-75).
    """
    if chunk_len == -1:
        vr = open_reader(osp.join(root, f"{vid}.mp4"))
        second_offset = second
        duration = len(vr) / max(vr.fps, 1e-6)
        end_second = duration if end_second is None else min(end_second,
                                                             duration)
        if end_second <= second:
            raise ValueError("end_second must be greater than second")
    else:
        chunk_start = int(second) // chunk_len * chunk_len
        second_offset = second - chunk_start
        vr = open_reader(osp.join(root, f"{vid}.mp4", f"{chunk_start}.mp4"))
    if fps == -1:
        fps = vr.fps

    frame_offset = int(np.round(second_offset * fps))
    total = max(int((end_second - second) * fps), clip_length)
    if chunk_len == -1:
        ids = uniform_frame_ids(frame_offset,
                                min(frame_offset + total, len(vr)),
                                clip_length, jitter, rng)
    else:
        ids = uniform_frame_ids(frame_offset, frame_offset + total,
                                clip_length, jitter, rng)

    n = len(vr)
    try:
        if ids.max() < n:
            frames = vr.get_batch(ids)
        else:
            # stitch the tail from the next chunk
            part1 = ids[ids < n]
            frames1 = vr.get_batch(part1) if len(part1) else None
            try:
                vr2 = open_reader(osp.join(
                    root, f"{vid}.mp4", f"{chunk_start + chunk_len}.mp4"))
                part2 = ids[ids >= n]
                part2 = np.minimum(part2 % n, len(vr2) - 1)
                frames2 = vr2.get_batch(part2)
                frames = (np.concatenate([frames1, frames2])
                          if frames1 is not None else frames2)
            except IOError:
                # last chunk: resample inside the available range
                ids = uniform_frame_ids(min(frame_offset, n - 1), n,
                                        clip_length, jitter, rng)
                frames = vr.get_batch(ids)
    except IOError:
        frames = np.zeros((clip_length, *vr.shape, 3), np.uint8)
    return frames.astype(np.float32)


def video_loader_by_frames(root: str, vid: str,
                           frame_ids: Sequence[int]) -> np.ndarray:
    """Load explicit frame ids from ``root/vid`` as float32 (T, H, W, 3);
    decode errors fall back to zero frames
    (reference datasets.py:93-102)."""
    try:
        vr = open_reader(osp.join(root, vid))
        ids = np.clip(np.asarray(frame_ids, np.int64), 0,
                      max(len(vr) - 1, 0))
        frames = vr.get_batch(ids)
        return frames.astype(np.float32)
    except IOError as e:
        print(f"video decode error ({e}); zero-filling: {vid}")
        return np.zeros((len(frame_ids), 240, 320, 3), np.float32)


def probe_fps(path: str) -> float:
    return _probe_fps(path)


def probe_num_frames(path: str) -> int:
    r = VideoReader(path)
    try:
        return len(r)
    finally:
        r.close()
