"""Build and load the CUDA C++ kernels of ``lavila_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout (git-ignored), named after a hash of the sources, headers
and flags, so an edited source rebuilds and an unchanged one is reused. The
library is loaded with ``ctypes``: every pointer and the stream go as
``c_void_p``, and every C entry point returns the ``cudaError_t`` of its
launch, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC",
              "-Xptxas=-v")  # registers, shared memory, spills per kernel

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# argtypes of each C entry point; ctypes would cut an undeclared pointer
# to 32 bits
# the divided phases' (K1's, K2's and K6's) forward and backward take a
# tensor-core flag after dtype
_PHASE_FWD = ([_P] * 7 + [_I] * 5 + [_LL] * 5 + [_F, _I, _I, _P],
              ctypes.c_int)
_SPACE_BWD = ([_P] * 16 + [_I] * 5 + [_LL] * 5 + [_F, _I, _I, _P],
              ctypes.c_int)
# B, H, Lq, Lk, d, the q/k/v row strides, scale, causal, dtype, stream;
# all but the fused backward take a tensor-core flag after dtype
_FLASH_TAIL = [_I] * 5 + [_LL] * 3 + [_F, _I, _I, _P]
_FLASH_TC_TAIL = _FLASH_TAIL[:-1] + [_I, _P]
_SIGNATURES = {
    "lavila_divided_space_fwd": _PHASE_FWD,
    "lavila_divided_time_fwd": _PHASE_FWD,
    "lavila_divided_space_big_fwd": _PHASE_FWD,
    "lavila_divided_space_bwd": _SPACE_BWD,
    "lavila_divided_space_big_bwd": _SPACE_BWD,
    "lavila_divided_time_bwd": (
        [_P] * 15 + [_I] * 5 + [_LL] * 5 + [_F, _I, _I, _P], ctypes.c_int),
    # cls_q, cls_k, cls_v, kp, vp, out, lse, o, part; B, L, H, d, S; the
    # CLS rows' batch strides, the patches' row strides; scale, dtype,
    # stream
    "lavila_cls_row_fwd": ([_P] * 9 + [_I] * 5 + [_LL] * 5 + [_F, _I, _P],
                           ctypes.c_int),
    # cls_q, cls_k, cls_v, kp, vp, g, o, lse, dkp, dvp, dcls_q, dcls_k,
    # dcls_v, part; then as the forward
    "lavila_cls_row_bwd": ([_P] * 14 + [_I] * 5 + [_LL] * 5 + [_F, _I, _P],
                           ctypes.c_int),
    "lavila_decode_attention": (
        [_P] * 6 + [_I] * 4 + [_LL] * 3 + [_F, _I, _P], ctypes.c_int),
    "lavila_flash_attention": ([_P] * 4 + _FLASH_TC_TAIL, ctypes.c_int),
    "lavila_flash_fwd": ([_P] * 5 + _FLASH_TC_TAIL, ctypes.c_int),
    "lavila_flash_bwd_fused": ([_P] * 8 + _FLASH_TAIL, ctypes.c_int),
    "lavila_flash_bwd_dq": ([_P] * 7 + _FLASH_TC_TAIL, ctypes.c_int),
    "lavila_flash_bwd_dkv": ([_P] * 8 + _FLASH_TC_TAIL, ctypes.c_int),
    # D, dtype, has_res, has_dsum, vec, per_lane, warps; out:
    # blocks an SM, shared memory
    "lavila_ln_bwd_occupancy": (
        [_I] * 7 + [ctypes.POINTER(ctypes.c_int)] * 2, ctypes.c_int),
    # x, r, w, dy, ds, dx, dwb, part; R; D, rows_per_block, grid, warps,
    # vec, per_lane; eps; dtype, wdtype; stream
    "lavila_ln_bwd": ([_P] * 8 + [_LL] + [_I] * 6 + [_F] + [_I] * 2 + [_P],
                      ctypes.c_int),
    # x, r, w, b, y, s; R; D, warps, per_thread; eps, 1 / D; dtype,
    # wdtype; stream
    "lavila_ln_fwd": ([_P] * 6 + [_LL] + [_I] * 3 + [_F] * 2 + [_I] * 2
                      + [_P], ctypes.c_int),
    # x, x row stride, w, bias, idx, wts; T, D, E, K; scale; stream
    "lavila_moe_route": ([_P, _LL] + [_P] * 4 + [_I] * 4 + [_F, _P],
                         ctypes.c_int),
    # idx, src, pos, offsets; T, K, E, S; stream
    "lavila_moe_sort": ([_P] * 4 + [_I] * 4 + [_P], ctypes.c_int),
    # x, x row stride, src, offsets, w1, w1s, h; E, S, D, I, T; stream
    "lavila_moe_gate_up": ([_P, _LL] + [_P] * 5 + [_I] * 5 + [_P],
                           ctypes.c_int),
    # h, offsets, w2, w2s, y; E, S, D, I, T; stream
    "lavila_moe_down": ([_P] * 5 + [_I] * 5 + [_P], ctypes.c_int),
    # y, pos, wts, out; T, K, S, D; stream
    "lavila_moe_combine": ([_P] * 4 + [_I] * 4 + [_P], ctypes.c_int),
}

# set by the build in this process: its wall time and nvcc's output
build_seconds: float | None = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels need the CUDA toolkit to build")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblavila_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    global build_seconds, build_log
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o")
                for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        # compile every source at once, then link
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        logs = []
        for cmd, proc in zip(cmds, procs):
            logs.append(proc.communicate()[0])
            _raise_if_failed(cmd, proc.returncode, logs[-1])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        _raise_if_failed(cmds[-1], link.returncode,
                         link.stdout + link.stderr)
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _raise_if_failed(cmd: list[str], code: int, log: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")


def row_stride(t: torch.Tensor, name: str, row_dims: int = 1) -> int:
    """Row stride of a tensor whose last ``row_dims`` dims make a row,
    (..., D) or (..., H, d), with the rows evenly spaced and the row's
    elements contiguous (a column block of a wider tensor passes); raise
    otherwise."""
    shape, stride = t.shape, t.stride()
    lead = len(shape) - row_dims
    width = 1  # the row's elements
    for i in range(len(shape) - 1, lead - 1, -1):
        if shape[i] > 1 and stride[i] != width:
            raise ValueError(f"{name}: a row must be contiguous, its last "
                             f"dim of stride 1 (shape {tuple(shape)}, "
                             f"stride {stride})")
        width *= shape[i]
    sized = [i for i in range(lead) if shape[i] > 1]
    rs = stride[sized[-1]] if sized else width
    rows_inside = 1  # rows spanned by one step of leading dim i
    for i in range(lead - 1, -1, -1):
        if shape[i] > 1 and stride[i] != rows_inside * rs:
            raise ValueError(f"{name}: rows are not evenly strided "
                             f"(shape {tuple(shape)}, stride {stride})")
        rows_inside *= shape[i]
    if rs < width:
        raise ValueError(f"{name}: rows overlap")
    return rs


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
