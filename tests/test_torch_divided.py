"""The port's divided-attention phases (the plain versions of K1/K2) and
its full ``divided_attention_split`` against the JAX package on the same
numpy inputs: the Pallas ``divided_phase`` in interpret mode (output and
log-sum-exp) and the grouped XLA formulation with the CLS row. fp32,
atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavila_tpu.ops import attention as JA
from lavila_tpu.ops.pallas import divided as JD
from lavila_tpu_torch.kernels import build
from lavila_tpu_torch.kernels import divided as K
from lavila_tpu_torch.ops.attention import divided_attention_split

torch.set_num_threads(1)


def _phase_inputs(B, F, N, H, d, seed):
    rng = np.random.default_rng(seed)
    D = H * d
    tok = [rng.normal(size=(B, F, N, D)).astype(np.float32)
           for _ in range(3)]
    cls = [rng.normal(size=(B, D)).astype(np.float32) for _ in range(2)]
    return tok + cls


@pytest.mark.parametrize("axis,B,F,N,H,d", [
    ("space", 2, 4, 24, 3, 16),
    ("time", 2, 4, 24, 3, 16),
    ("space", 1, 16, 8, 2, 16),
    ("time", 1, 16, 8, 2, 16),
    ("time", 1, 8, 13, 2, 16),      # 8 frames: K2's slab holds 2 positions
    ("time", 1, 16, 11, 2, 16),     # 16 frames, N off the Pallas row tile
    ("space", 1, 2, 196, 12, 64),   # TSF-B frame: N=196, 12 heads of 64
    ("time", 1, 4, 196, 12, 64),
    ("space", 1, 2, 256, 2, 64),    # TSF-L@224 frame: N=256
])
def test_phase_matches_pallas_kernel(axis, B, F, N, H, d):
    arrs = _phase_inputs(B, F, N, H, d, seed=F * N + H)
    scale = d ** -0.5
    out, lse = K.divided_phase(*map(torch.from_numpy, arrs), axis, H, scale)
    jout, jlse = JD._phase_fwd(*map(jnp.asarray, arrs), axis, H, scale,
                               True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    # the Pallas lse pads heads to a lane multiple; the first H are real
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :H],
                               atol=1e-5, rtol=0)
    assert lse.dtype == torch.float32 and lse.shape == (B, F, N, H)


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("F", [4, 16])
def test_divided_attention_split_matches_grouped(axis, F):
    """Patches and the CLS row, against the JAX grouped formulation."""
    rng = np.random.default_rng(F)
    B, N, H, d = 2, 16, 4, 16
    cls = [rng.normal(size=(B, 1, H, d)).astype(np.float32)
           for _ in range(3)]
    pat = [rng.normal(size=(B, F, N, H, d)).astype(np.float32)
           for _ in range(3)]
    old = JA.get_attention_backend()
    JA.set_attention_backend("grouped")
    try:
        jc, jp = JA.divided_attention_split(*map(jnp.asarray, cls + pat),
                                            axis)
    finally:
        JA.set_attention_backend(old)
    tc, tp = divided_attention_split(*map(torch.from_numpy, cls + pat),
                                     axis)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5,
                               rtol=0)


def test_phase_takes_strided_qkv_views():
    """q/k/v as the column blocks of one qkv output (row stride 3D) give
    the same result as contiguous copies, and the stride check accepts
    them."""
    B, F, N, H, d = 2, 3, 5, 2, 8
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D, generator=torch.Generator()
                      .manual_seed(0))
    cls = torch.randn(B, 1, 3 * D, generator=torch.Generator()
                      .manual_seed(1))
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = (t.reshape(B, D) for t in cls.chunk(3, dim=-1))
    assert not q.is_contiguous()
    assert [build.row_stride(t, "t") for t in (q, k, v, ck, cv)] == \
        [3 * D] * 5
    for axis in ("space", "time"):
        a, la = K.divided_phase(q, k, v, ck, cv, axis, H, d ** -0.5)
        b, lb = K.divided_phase(q.contiguous(), k.contiguous(),
                                v.contiguous(), ck.contiguous(),
                                cv.contiguous(), axis, H, d ** -0.5)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(la, lb, rtol=0, atol=0)


def test_row_stride_rejects_uneven_rows():
    x = torch.zeros(2, 3, 4, 8)
    with pytest.raises(ValueError, match="evenly strided"):
        build.row_stride(x.transpose(1, 2), "x")
    with pytest.raises(ValueError, match="stride 1"):
        build.row_stride(torch.zeros(8, 4).t(), "x")


def test_phase_rejects_bad_input():
    B, F, N, H, d = 1, 2, 3, 2, 4
    D = H * d
    q = torch.zeros(B, F, N, D)
    ck = torch.zeros(B, D)
    with pytest.raises(ValueError, match="axis"):
        K.divided_phase(q, q, q, ck, ck, "depth", H, 1.0)
    with pytest.raises(ValueError, match="ck/cv"):
        K.divided_phase(q, q, q, ck[:, :-1], ck, "space", H, 1.0)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        K.divided_phase(q.half(), q.half(), q.half(), ck.half(), ck.half(),
                        "space", H, 1.0)
    with pytest.raises(ValueError, match="multiple of heads"):
        K.divided_phase(q, q, q, ck, ck, "space", 3, 1.0)


def _space_views(N, dtype, d=64, H=2, B=2, F=3, pad=0):
    """q/k/v and ck/cv as the column blocks of one qkv output, with
    ``pad`` extra elements per row."""
    D = H * d
    qkv = torch.zeros(B, F, N, 3 * D + pad, dtype=dtype)
    cls = torch.zeros(B, 3 * D + pad, dtype=dtype)
    q, k, v = qkv[..., :3 * D].chunk(3, dim=-1)
    _, ck, cv = cls[:, :3 * D].chunk(3, dim=-1)
    return q, k, v, ck, cv


@pytest.mark.parametrize("N,dtype,d,pad,name,branch", [
    (196, torch.bfloat16, 64, 0, "space", "tc"),     # TSF-B
    (256, torch.bfloat16, 64, 0, "space", "tc"),     # TSF-L@224
    (1, torch.bfloat16, 64, 0, "space", "tc"),
    (65, torch.bfloat16, 64, 0, "space", "tc"),      # a 1-row last tile
    (257, torch.bfloat16, 64, 0, "space_big", "tc"),  # K6
    (576, torch.bfloat16, 64, 0, "space_big", "tc"),  # TSF-L@336
    (1024, torch.bfloat16, 64, 0, "space_big", "tc"),
    (196, torch.float32, 64, 0, "space", "simt"),    # fp32: 1e-4 limit
    (196, torch.bfloat16, 32, 0, "space", "simt"),   # head_dim 32
    (196, torch.bfloat16, 64, 1, "space", "simt"),   # odd row stride
    (196, torch.bfloat16, 64, 2, "space", "simt"),   # rows off 16 bytes
    (576, torch.float32, 64, 0, "space_big", "simt"),
    (576, torch.bfloat16, 32, 0, "space_big", "simt"),
    (576, torch.bfloat16, 64, 1, "space_big", "simt"),
    (576, torch.bfloat16, 64, 2, "space_big", "simt"),
])
def test_space_routing_and_partials(N, dtype, d, pad, name, branch):
    """The wrapper's arithmetic before a launch: the kernel a spatial
    phase takes (K1 up to N = 256, K6 past it), its branch (one rule for
    both), and the scratch the backward allocates: dck/dcv partials one
    per (frame, 64-query tile) on the tensor cores, one per frame
    otherwise; per-tile lse and delta on the tensor cores, delta per
    (row, head) for the SIMT kernels, K1's and K6's."""
    B, F, H = 2, 3, 2
    q, k, v, ck, cv = _space_views(N, dtype, d, H, B, F, pad)
    D = H * d
    assert K._kernel_name(q, "space", H) == name
    assert K.space_branch(q, k, v, ck, cv, H) == branch
    tiles = -(-N // 64)
    want = (B, F * tiles, D) if branch == "tc" else (B, F, D)
    assert K._partials_shape(name, branch, B, F, N, D) == want
    assert K._partials_shape("time", "simt", B, F, N, D) == (B, N, D)
    stats = {"tc": (B, F, H, tiles, 2, 64)}.get(branch, (B, F, N, H))
    assert K._stats_shape(name, branch, B, F, N, H) == stats
    assert K._stats_shape("time", None, B, F, N, H) is None


@pytest.mark.parametrize("N", [196, 576])
def test_space_branch_backward_needs_aligned_do(N):
    """The backward's tensor cores also read dO by TMA: a dO off a
    16-byte boundary takes the SIMT kernels, K1's and K6's."""
    q, k, v, ck, cv = _space_views(N, torch.bfloat16)
    do = torch.zeros(2, 3, N, 129, dtype=torch.bfloat16)[..., 1:]
    assert K.space_branch(q, k, v, ck, cv, 2, do.contiguous()) == "tc"
    assert K.space_branch(q, k, v, ck, cv, 2, do) == "simt"


@pytest.mark.parametrize("F,N,dtype,d,pad,H,branch", [
    (4, 196, torch.bfloat16, 64, 0, 12, "tc"),    # TSF-B: 4 positions a tile
    (16, 196, torch.bfloat16, 64, 0, 12, "tc"),   # the fine-tune: 1
    (4, 576, torch.bfloat16, 64, 0, 16, "tc"),    # TSF-L@336
    (1, 7, torch.bfloat16, 64, 0, 3, "tc"),       # 16 positions, ragged
    (5, 7, torch.bfloat16, 64, 0, 2, "tc"),       # 3 positions (15 rows)
    (17, 7, torch.bfloat16, 64, 0, 2, "simt"),    # past the slab's 16 rows
    (4, 196, torch.float32, 64, 0, 12, "simt"),   # fp32: the 1e-4 limit
    (4, 196, torch.bfloat16, 32, 0, 12, "simt"),  # head_dim 32
    (4, 196, torch.bfloat16, 64, 1, 12, "simt"),  # odd row stride
    (4, 196, torch.bfloat16, 64, 2, 12, "simt"),  # rows off 16 bytes
])
def test_time_routing_and_partials(F, N, dtype, d, pad, H, branch):
    """K2's branch (the slab kernels on the tensor cores up to 16 frames
    of aligned bf16 rows at head_dim 64, else SIMT; dO must be aligned
    too for the backward's) and the dck/dcv partials its backward
    allocates: one per tile of 16 // F positions on the tensor cores, one
    per position on SIMT; no scratch."""
    B = 2
    D = H * d
    qkv = torch.zeros(B, F, N, 3 * D + pad, dtype=dtype)
    cls = torch.zeros(B, 3 * D + pad, dtype=dtype)
    q, k, v = qkv[..., :3 * D].chunk(3, dim=-1)
    _, ck, cv = cls[:, :3 * D].chunk(3, dim=-1)
    assert K._kernel_name(q, "time", H) == "time"
    assert K.time_branch(q, k, v, ck, cv, H) == branch
    assert K.phase_branch(q, k, v, ck, cv, "time", H) == branch
    span = 16 // F if branch == "tc" else 1
    assert K._partials_shape("time", branch, B, F, N, D) == \
        (B, -(-N // span), D)
    assert K._stats_shape("time", branch, B, F, N, H) is None
    if branch == "tc":
        do = torch.zeros(B, F, N, D + 1, dtype=dtype)[..., 1:]
        out = torch.zeros(B, F, N, D, dtype=dtype)
        assert K.time_branch(q, k, v, ck, cv, H, out) == "tc"
        assert K.time_branch(q, k, v, ck, cv, H, do) == "simt"
