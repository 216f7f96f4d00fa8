"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device, and
runs on a machine with an H100 (nvcc and triton installed) with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from lavila_tpu_torch.kernels import decode as KDec
from lavila_tpu_torch.kernels import divided as KD
from lavila_tpu_torch.kernels import flash as KF
from lavila_tpu_torch.kernels import layernorm as KL

pytestmark = pytest.mark.cuda

# against the plain version in fp32 on the same values: summation order
# (fp32), or one rounding of the output to bf16 (half an ulp)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# K1 (space) and K2 (time) cases; in bf16 every K1 case at head_dim 64
# takes the tensor-core kernels: 64-query blocks over 64-key tiles, the
# last one masked (N = 1, 63, 64, 65, 200 are the ragged edges; 150 is
# 3 query tiles, which the dq kernel runs on blocks of 2 warpgroups).
# In bf16 every K2 case at head_dim 64 with F <= 16 takes the slab
# kernels: tiles of 16 // F positions x F frames (F = 1, 2, 4, 5, 16:
# 16, 8, 4, 3 and 1 positions, the last tile ragged at N = 1, 7, 196,
# 577), 4 heads a block where they divide H, else 2 (H = 6), else 1
# (H = 3); F = 17 and head_dim 32 or 96 take the SIMT kernels.
PHASE_CASES = [
    ("space", 2, 4, 196, 12, 64),   # TSF-B's frame: 3 full tiles + 4 keys
    ("space", 2, 4, 256, 16, 64),   # TSF-L@224's frame: 4 full tiles
    ("space", 2, 2, 50, 3, 64),     # one partial tile
    *[("space", 1, 2, n, 2, 64) for n in (1, 63, 64, 65, 150, 200)],
    ("space", 1, 3, 37, 4, 32),     # SIMT kernels (head_dim 32)
    ("space", 1, 2, 256, 2, 64),    # N = 256, two heads
    ("time", 2, 4, 196, 12, 64),    # TSF-B: 49 tiles of 4 positions
    ("time", 1, 16, 50, 12, 64),    # the fine-tune's 16 frames
    ("time", 3, 5, 7, 2, 96),       # SIMT kernels (head_dim 96)
    ("time", 2, 1, 7, 4, 64),       # one frame: 16 positions a tile
    ("time", 2, 2, 1, 4, 64),       # one position
    ("time", 1, 2, 577, 2, 64),     # 8 positions a tile, 1 in the last
    ("time", 2, 5, 196, 6, 64),     # 3 positions (15 rows), 2 heads a block
    ("time", 1, 16, 7, 3, 64),      # one head a block
    ("time", 1, 4, 577, 16, 64),    # TSF-L@336's width, a ragged tile
    ("time", 1, 16, 1, 4, 64),
    ("time", 1, 17, 7, 4, 64),      # past the slab: SIMT
    ("time", 1, 4, 7, 2, 32),       # SIMT kernels (head_dim 32)
]


def _counter(axis, dtype, d, bwd=False, F=4):
    """The launch counter a call bumps, by branch: bf16 at head_dim 64 on
    aligned rows is the tensor cores' (for K2 up to 16 frames)."""
    name = f"{axis}_bwd" if bwd else axis
    tc = dtype == torch.bfloat16 and d == 64 and (axis == "space" or F <= 16)
    return f"{name}_{'tc' if tc else 'simt'}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,B,F,N,H,d", PHASE_CASES)
def test_divided_phase_kernel(gen, axis, B, F, N, H, d, dtype):
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device="cuda").to(
        dtype)
    cls = torch.randn(B, 3 * D, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = cls.chunk(3, dim=-1)
    args = (q, k, v, ck, cv, axis, H, d ** -0.5)
    key = _counter(axis, dtype, d, F=F)
    before = KD.launches[key]
    out, lse = KD.divided_phase(*args)
    assert KD.launches[key] == before + 1
    ref, ref_lse = KD.divided_phase_reference(
        *(t.float() for t in args[:5]), *args[5:])
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL[dtype])


def test_space_kernel_odd_row_stride(gen):
    """bf16 rows an odd number of elements apart cannot be read as bf16
    pairs; the SIMT kernels take them (forward and backward), with the
    same result."""
    B, F, N, H, d = 2, 2, 196, 4, 64
    D = H * d
    base = torch.randn(B, F, N, 3 * D + 1, generator=gen,
                       device="cuda").bfloat16()
    q, k, v = base[..., :3 * D].chunk(3, dim=-1)
    cls = torch.randn(B, 3 * D + 1, generator=gen, device="cuda").bfloat16()
    _, ck, cv = cls[:, :3 * D].chunk(3, dim=-1)
    args = (q, k, v, ck, cv, "space", H, d ** -0.5)
    before = dict(KD.launches)
    out, lse = KD.divided_phase(*args)
    assert KD.launches["space_simt"] == before["space_simt"] + 1
    ref, ref_lse = KD.divided_phase_reference(
        *(t.float() for t in args[:5]), *args[5:])
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=0,
                               atol=TOL[torch.bfloat16])
    do = torch.randn(B, F, N, D, generator=gen, device="cuda").bfloat16()
    bwd = (q, k, v, ck, cv, do, out, lse, "space", H, d ** -0.5)
    got = KD.divided_phase_bwd(*bwd)
    assert KD.launches["space_bwd_simt"] == before["space_bwd_simt"] + 1
    want = KD.divided_phase_bwd_reference(*(t.float() for t in bwd[:8]),
                                          *bwd[8:])
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("pad", [1, 2])
def test_time_kernel_unaligned_rows(gen, pad):
    """K2 on rows the slab's 16-byte copies cannot take (an odd row
    stride, or rows off 16-byte boundaries) runs the SIMT kernels, forward
    and backward, within the bf16 limit."""
    B, F, N, H, d = 2, 4, 37, 4, 64
    D = H * d
    base = torch.randn(B, F, N, 3 * D + pad, generator=gen,
                       device="cuda").bfloat16()
    q, k, v = base[..., :3 * D].chunk(3, dim=-1)
    cls = torch.randn(B, 3 * D + pad, generator=gen, device="cuda").bfloat16()
    _, ck, cv = cls[:, :3 * D].chunk(3, dim=-1)
    assert KD.time_branch(q, k, v, ck, cv, H) == "simt"
    before = dict(KD.launches)
    out, lse = KD.divided_phase(q, k, v, ck, cv, "time", H, d ** -0.5)
    assert KD.launches["time_simt"] == before["time_simt"] + 1
    ref, ref_lse = KD.divided_phase_reference(
        q.float(), k.float(), v.float(), ck.float(), cv.float(), "time", H,
        d ** -0.5)
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=0,
                               atol=TOL[torch.bfloat16])
    do = torch.randn(B, F, N, D, generator=gen, device="cuda").bfloat16()
    bwd = (q, k, v, ck, cv, do, out, lse, "time", H, d ** -0.5)
    got = KD.divided_phase_bwd(*bwd)
    assert KD.launches["time_bwd_simt"] == before["time_bwd_simt"] + 1
    want = KD.divided_phase_bwd_reference(*(t.float() for t in bwd[:8]),
                                          *bwd[8:])
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 77, 512), (6272, 768), (5, 3, 200),
                                   (160, 1, 1600)])
def test_layernorm_kernel(gen, shape, dtype):
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
    before = KL.launches["layernorm"]
    y = KL.layer_norm(x, w, b, 1e-5)
    assert KL.launches["layernorm"] == before + 1
    ref = KL.layer_norm_reference(x.float(), w.float(), b.float(), 1e-5)
    torch.testing.assert_close(y.float(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_free_layernorm_kernel(gen, dtype):
    """The pooler's norm (no bias: K3 with a zero bias) on 16 clips' 256
    GPT-2 XL-wide queries, D = 1600 masked to a 2048 block."""
    from lavila_tpu_torch.ops.basic import BiasFreeLayerNorm
    ln = BiasFreeLayerNorm(1600).to("cuda", dtype)
    with torch.no_grad():
        ln.gamma.copy_(1 + 0.1 * torch.randn(1600, generator=gen,
                                             device="cuda"))
    x = torch.randn(16, 256, 1600, generator=gen, device="cuda").to(dtype)
    before = KL.launches["layernorm"]
    with torch.no_grad():
        y = ln(x)
    assert KL.launches["layernorm"] == before + 1
    ref = KL.layer_norm_reference(x.float(), ln.gamma.float(),
                                  torch.zeros(1600, device="cuda"), 1e-5)
    torch.testing.assert_close(y.float(), ref, rtol=0, atol=TOL[dtype])


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,B,F,N,H,d", PHASE_CASES)
def test_divided_phase_bwd_kernel(gen, axis, B, F, N, H, d, dtype):
    """K1/K2 bwd on strided qkv views against the plain backward in fp32
    on the same values (errors relative to the largest gradient: dck/dcv
    sum over every group), bit-identical on a second call."""
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device="cuda").to(
        dtype)
    cls = torch.randn(B, 3 * D, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    _, ck, cv = cls.chunk(3, dim=-1)
    out, lse = KD.divided_phase(q, k, v, ck, cv, axis, H, d ** -0.5)
    do = torch.randn(B, F, N, D, generator=gen, device="cuda").to(dtype)
    args = (q, k, v, ck, cv, do, out, lse, axis, H, d ** -0.5)
    key = _counter(axis, dtype, d, bwd=True, F=F)
    before = KD.launches[key]
    got = KD.divided_phase_bwd(*args)
    assert KD.launches[key] == before + 1
    again = KD.divided_phase_bwd(*args)
    ref = KD.divided_phase_bwd_reference(
        *(t.float() for t in args[:8]), *args[8:])
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert g.dtype == dtype
        assert torch.equal(g, a)
        assert _rel_err(g, r) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_divided_phase_autograd_uses_bwd_kernel(gen, dtype):
    """On CUDA tensors that require grad, the phase runs through its
    Function: the forward and backward kernels, no fallback."""
    B, F, N, H, d = 2, 4, 196, 12, 64
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D, generator=gen, device="cuda").to(
        dtype).requires_grad_()
    cls = torch.randn(B, 3 * D, generator=gen, device="cuda").to(
        dtype).requires_grad_()
    for axis in ("space", "time"):
        before = dict(KD.launches)
        q, k, v = qkv.chunk(3, dim=-1)
        _, ck, cv = cls.chunk(3, dim=-1)
        out, _ = KD.divided_phase(q, k, v, ck, cv, axis, H, d ** -0.5)
        out.float().square().sum().backward()
        fwd, bwd = _counter(axis, dtype, d), _counter(axis, dtype, d, True)
        assert KD.launches[fwd] == before[fwd] + 1
        assert KD.launches[bwd] == before[bwd] + 1
        assert qkv.grad.dtype == dtype and torch.isfinite(qkv.grad).all()


# (rows' dtype, γ's dtype): the bf16 train step hands bf16 rows with fp32 γ
LN_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32)]
# the backward kernel's shapes: the text tower's, TSF-B's patches and one
# row more (ragged), one row, TSF-L's CLS rows, the fine-tune's 16
# frames, D = 200 (one 16-byte chunk a lane, some lanes idle), GPT-2 XL's
# 1600; D = 100 (bf16: 200-byte rows) and 37 take the scalar variant
LN_BWD_SHAPES = [(4, 77, 512), (6272, 768), (6273, 768), (1, 768),
                 (8, 1024), (25088, 768), (5, 3, 200), (160, 1, 1600),
                 (3, 100), (9, 37)]


def _ln_bwd_branch(shape, dtype, tensors):
    """The launch counter a backward call bumps: one block where its
    rings hold every row, else the cooperative grid."""
    D = shape[-1]
    rows = 1
    for n in shape[:-1]:
        rows *= n
    plan = KL.bwd_shape(D, torch.empty((), dtype=dtype).element_size(),
                        tensors)
    return ("ln_bwd_block" if rows <= plan.warps * max(plan.slots, 1)
            else "ln_bwd_grid")


@pytest.mark.parametrize("dtype,wdtype", LN_DTYPES)
@pytest.mark.parametrize("shape", LN_BWD_SHAPES)
def test_layernorm_bwd_kernel(gen, shape, dtype, wdtype):
    """K3 backward against the plain version in fp32 on the same values,
    bit-identical over two calls, one launch on the branch its plan
    names."""
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
    dy = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    branch = _ln_bwd_branch(shape, dtype, 2)
    before = dict(KL.launches)
    got = KL.layer_norm_bwd(x, w, dy, 1e-5)
    assert KL.launches["layernorm_bwd"] == before["layernorm_bwd"] + 1
    assert KL.launches[branch] == before[branch] + 1
    assert sum(KL.launches[k] for k in ("ln_bwd_grid", "ln_bwd_block")) \
        == before["ln_bwd_grid"] + before["ln_bwd_block"] + 1
    again = KL.layer_norm_bwd(x, w, dy, 1e-5)
    ref = KL.layer_norm_bwd_reference(x.float(), w.float(), dy.float(), 1e-5)
    torch.cuda.synchronize()
    for g, a, r, want in zip(got, again, ref, (dtype, wdtype, wdtype)):
        assert g.dtype == want and torch.equal(g, a)
        assert _rel_err(g, r) <= TOL[dtype]


@pytest.mark.parametrize("rows", [6272, 8])
def test_layernorm_bwd_one_launch_a_call(gen, rows):
    """The profiler sees one kernel launch a call on either branch (the
    grid's dγ/dβ behind its barrier, not in a second launch)."""
    x, dy = (torch.randn(rows, 768, generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    w = torch.ones(768, device="cuda")
    KL.layer_norm_bwd(x, w, dy, 1e-6)  # built and planned
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            KL.layer_norm_bwd(x, w, dy, 1e-6)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "ln_bwd" in ev.name]
    assert len(kernels) == 3, [ev.name for ev in kernels]


def test_layernorm_autograd_mixed_dtypes(gen):
    """bf16 rows with fp32 γ/β (the bf16 train step's working copy)."""
    x = torch.randn(8, 77, 512, generator=gen, device="cuda").bfloat16()
    x.requires_grad_()
    w = torch.ones(512, device="cuda", requires_grad=True)
    b = torch.zeros(512, device="cuda", requires_grad=True)
    before = KL.launches["layernorm_bwd"]
    KL.layer_norm(x, w, b, 1e-5).float().square().sum().backward()
    assert KL.launches["layernorm_bwd"] == before + 1
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_wrappers_raise_instead_of_falling_back(gen):
    q = torch.randn(1, 2, 300, 64, generator=gen, device="cuda")
    ck = torch.randn(1, 64, generator=gen, device="cuda")
    q160 = torch.randn(1, 2, 300, 160, generator=gen, device="cuda")
    ck160 = torch.randn(1, 160, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim 160"):
        KD.divided_phase(q160, q160, q160, ck160, ck160, "space", 1, 0.125)
    lse = torch.zeros(1, 2, 300, 1, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        KD.divided_phase_bwd(q, q, q, ck, ck, q.transpose(1, 2)
                             .contiguous().transpose(1, 2), q, lse, "space",
                             1, 0.125)
    with pytest.raises(ValueError, match="share shape and dtype"):
        KL.add_layer_norm(q, q.bfloat16(), torch.ones(64, device="cuda"),
                          torch.zeros(64, device="cuda"), 1e-6)
    qh = q[:, :, :8].half()
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        KD.divided_phase_bwd(qh, qh, qh, ck.half(), ck.half(), qh, qh,
                             lse[:, :, :8], "time", 1, 0.125)
    qs = q[:, :, :8].contiguous()
    do = torch.randn(1, 2, 64, 8, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        KD.divided_phase_bwd(qs, qs, qs, ck, ck, do, qs,
                             lse[:, :, :8].contiguous(), "time", 1, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        KL.layer_norm(q.transpose(2, 3), torch.ones(300, device="cuda"),
                      torch.zeros(300, device="cuda"), 1e-5)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        KL.layer_norm_bwd(ck.half(), torch.ones(64, device="cuda"),
                          ck.half(), 1e-5)
    # a row the backward kernel does not take: 1025 fp32 values (not whole
    # 16-byte chunks, and more than 32 a lane on the scalar variant)
    x = torch.randn(4, 1025, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="no LayerNorm backward kernel"):
        KL.layer_norm_bwd(x, torch.ones(1025, device="cuda"), x, 1e-5)
    with pytest.raises(TypeError, match="share one dtype"):
        KL.layer_norm_bwd(ck, torch.ones(64, device="cuda"), ck.bfloat16(),
                          1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,N,H,d,pad", [
    (2, 4, 576, 16, 64, 0),   # TSF-L@336; bf16: the tensor-core kernels
    (1, 2, 300, 2, 64, 0),    # partial query and key tiles
    (1, 3, 257, 4, 32, 0),    # SIMT kernels (head_dim 32), 2-key last tile
    (1, 2, 576, 2, 64, 1),    # odd row stride: SIMT kernels in bf16 too
    (1, 2, 576, 2, 64, 2),    # rows off 16-byte boundaries: SIMT too
    # the tensor cores' ragged edges and ring refills (4 slots of 64 keys)
    (1, 2, 257, 2, 64, 0),    # one key in the 5th tile: the first refill
    (2, 2, 441, 12, 64, 0),   # 21 x 21 patches, 57 keys in the last tile
    (1, 3, 577, 2, 64, 0),    # one query in the last block's only tile
    (1, 2, 360, 2, 64, 0),    # 6 tiles: dq on 2 warpgroups, 3 blocks
    (1, 2, 640, 2, 64, 0),    # 10 full tiles
    (1, 2, 720, 2, 64, 0),    # 12 tiles: dq on 3 warpgroups, 4 blocks a
                              # frame, 16 queries in the last tile
    (1, 1, 1024, 2, 64, 0),   # 16 tiles: every slot refilled 3 times
])
def test_space_big_kernel(gen, B, F, N, H, d, pad, dtype):
    """K6 forward and backward on strided qkv views against the plain
    versions in fp32 on the same values; the backward bit-identical on a
    second call; both through the phase's single dispatch site, on the
    branch that its counter names."""
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D + pad, generator=gen,
                      device="cuda").to(dtype)
    cls = torch.randn(B, 3 * D + pad, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv[..., :3 * D].chunk(3, dim=-1)
    _, ck, cv = cls[:, :3 * D].chunk(3, dim=-1)
    fwd = (q, k, v, ck, cv, "space", H, d ** -0.5)
    branch = "tc" if dtype == torch.bfloat16 and d == 64 and not pad \
        else "simt"
    assert KD.space_branch(q, k, v, ck, cv, H) == branch
    before = dict(KD.launches)
    out, lse = KD.divided_phase(*fwd)
    assert KD.launches[f"space_big_{branch}"] == \
        before[f"space_big_{branch}"] + 1
    assert all(KD.launches[k] == before[k] for k in KD.launches
               if k != f"space_big_{branch}")
    ref, ref_lse = KD.divided_phase_reference(
        *(t.float() for t in fwd[:5]), *fwd[5:])
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL[dtype])
    do = torch.randn(B, F, N, D, generator=gen, device="cuda").to(dtype)
    bwd = (q, k, v, ck, cv, do, out, lse, "space", H, d ** -0.5)
    got = KD.divided_phase_bwd(*bwd)
    assert KD.launches[f"space_big_bwd_{branch}"] == \
        before[f"space_big_bwd_{branch}"] + 1
    again = KD.divided_phase_bwd(*bwd)
    want = KD.divided_phase_bwd_reference(*(t.float() for t in bwd[:8]),
                                          *bwd[8:])
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        assert _rel_err(g, w) <= TOL[dtype]


@pytest.mark.parametrize("dtype,wdtype", LN_DTYPES)
@pytest.mark.parametrize("shape", [(8 * 4 * 576, 1024), (32 * 4 * 196, 768),
                                   (5, 3, 200), (6273, 768), (1, 1024),
                                   (8, 1024), (3, 100), (64, 1600)])
@pytest.mark.parametrize("return_sum", [True, False])
def test_add_layernorm_kernels(gen, shape, return_sum, dtype, wdtype):
    """K4 (``return_sum``) and K5 forward and backward against their plain
    versions in fp32 on the same values; the backward bit-identical, one
    launch on the branch its plan names."""
    D = shape[-1]
    a, b, dy, ds = (torch.randn(*shape, generator=gen, device="cuda")
                    .to(dtype) for _ in range(4))
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
    bias = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
    name = "add_layernorm" if return_sum else "add_layernorm_nosum"
    before = dict(KL.launches)
    got = KL.add_layer_norm(a, b, w, bias, 1e-6, return_sum)
    assert KL.launches[name] == before[name] + 1
    want = KL.add_layer_norm_reference(a.float(), b.float(), w.float(),
                                       bias.float(), 1e-6, return_sum)
    for g, r in zip(*((got, want) if return_sum else ((got,), (want,)))):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r, rtol=0, atol=TOL[dtype])
    if return_sum:  # the saved sum, and its gradient folded into dx
        s = got[1]
        args = (s, None, w, dy, ds, 1e-6)
        ref = KL.add_layer_norm_bwd_reference(s.float(), None, w.float(),
                                              dy.float(), ds.float(), 1e-6)
    else:  # the pair, re-added
        args = (a, b, w, dy, None, 1e-6)
        ref = KL.add_layer_norm_bwd_reference(a.float(), b.float(),
                                              w.float(), dy.float(), None,
                                              1e-6)
    branch = _ln_bwd_branch(shape, dtype, 3)
    before = dict(KL.launches)
    grads = KL.add_layer_norm_bwd(*args)
    assert KL.launches[f"{name}_bwd"] == before[f"{name}_bwd"] + 1
    assert KL.launches[branch] == before[branch] + 1
    again = KL.add_layer_norm_bwd(*args)
    torch.cuda.synchronize()
    for g, r, x, want in zip(grads, ref, again, (dtype, wdtype, wdtype)):
        assert g.dtype == want and torch.equal(g, x)
        assert _rel_err(g, r) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,H", [(160, 77, 25), (16, 77, 12), (3, 9, 2)])
@pytest.mark.parametrize("nv", [0, 1, 15, -1])
def test_decode_attention_kernel(gen, B, K, H, nv, dtype):
    """K9 on q/k_new/v_new as the column blocks of one (B, 3D) c_attn
    output (row stride 3D), against the plain version in fp32."""
    nv = K if nv == -1 else min(nv, K)
    D = 64 * H
    qkv = torch.randn(B, 3 * D, generator=gen, device="cuda").to(dtype)
    q, kn, vn = qkv.chunk(3, dim=-1)
    kc, vc = (torch.randn(B, K, D, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    before = KDec.launches["decode"]
    out = KDec.decode_attention(q, kc, vc, kn, vn, nv, H)
    assert KDec.launches["decode"] == before + 1
    ref = KDec.decode_attention_reference(
        *(t.float() for t in (q, kc, vc, kn, vn)), nv, H)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, D)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    if nv == 0:
        assert torch.equal(out, vn)


def test_decode_attention_kernel_raises(gen):
    q = torch.randn(2, 96, generator=gen, device="cuda")
    kc = torch.randn(2, 5, 96, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim 64"):
        KDec.decode_attention(q, kc, kc, q, q, 3, 3)  # head_dim 32
    q = torch.randn(2, 128, generator=gen, device="cuda")
    kc = torch.randn(2, 5, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        KDec.decode_attention(q, kc.transpose(0, 1).contiguous()
                              .transpose(0, 1), kc, q, q, 3, 2)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        KDec.decode_attention(q.half(), kc.half(), kc.half(), q.half(),
                              q.half(), 3, 2)


def _qkv_views(gen, B, Lq, Lk, H, d, dtype, pad=0):
    """q (B, Lq, H, d) and k/v (B, Lk, H, d) as head views of packed
    projections with row stride 3·H·d (+ pad) when Lq == Lk, as the text
    tower hands them over; else of (B, L, 2·H·d) and (B, L, H·d)."""
    D = H * d
    if Lq == Lk:
        qkv = torch.randn(B, Lq, 3 * D + pad, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv[..., :3 * D].chunk(3, dim=-1)
    else:
        q = torch.randn(B, Lq, D + pad, generator=gen, device="cuda").to(
            dtype)[..., :D]
        kv = torch.randn(B, Lk, 2 * D + pad, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[..., :2 * D].chunk(2, dim=-1)
    return tuple(t.reshape(B, t.shape[1], H, d) for t in (q, k, v))


# K7/K8 cases; in bf16 at head_dim 64 on aligned rows the forward takes
# the TMA tensor-core kernel (one key tile of round_up(Lk, 16) keys up to
# 128, a refilled ring of 64-key tiles past it) and the backward the
# fused kernel up to 128 queries and keys, the split dq and dk/dv past it
FLASH_CASES = [
    (16, 77, 77, 8, 64, True, 0),     # TSF-B's text tower
    (16, 77, 77, 12, 64, True, 0),    # TSF-L's text tower
    (2, 130, 260, 3, 64, False, 0),   # uneven: the ring and the split
    (2, 197, 197, 2, 64, True, 0),    # causal over several tiles
    (1, 40, 40, 2, 32, True, 0),      # SIMT kernels (head_dim 32)
    (1, 77, 77, 2, 64, True, 2),      # rows off 16-byte boundaries: SIMT
    # the tile edges, on in_proj views
    *[(2, L, L, H, 64, causal, 0) for L in (1, 16, 77, 80, 112, 128, 129)
      for H in (8, 12) for causal in (True, False)],
]


def _flash_branches(dtype, d, pad, Lq, Lk):
    """The forward's and the backward's branch a case takes."""
    if dtype != torch.bfloat16 or d != 64 or pad % 8:
        return "simt", "simt"
    return "tc", "fused" if max(Lq, Lk) <= 128 else "split"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,d,causal,pad", FLASH_CASES)
def test_flash_kernels(gen, B, Lq, Lk, H, d, causal, pad, dtype):
    """K7 and K8 forward against the plain versions in fp32 on the same
    values; K8's backward within the backward limits (relative to the
    largest gradient) and bit-identical on a second call; each with the
    branch it takes and one launch of its kernels."""
    q, k, v = _qkv_views(gen, B, Lq, Lk, H, d, dtype, pad)
    fwd, bwd = _flash_branches(dtype, d, pad, Lq, Lk)
    assert KF.flash_branch(q, k, v) == fwd
    before = dict(KF.launches)
    with torch.no_grad():
        out7 = KF.flash_attention(q, k, v, causal=causal)
    out, lse = KF._forward(q, k, v, causal, d ** -0.5, with_lse=True)
    ref, ref_lse = KF.flash_fwd_reference(q.float(), k.float(), v.float(),
                                          causal)
    torch.cuda.synchronize()
    assert out7.dtype == out.dtype == dtype and lse.dtype == torch.float32
    for got in (out7, out):
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=TOL[dtype])
    do = torch.randn(B, Lq, H, d, generator=gen, device="cuda").to(dtype)
    assert KF.flash_branch(q, k, v, do, out) == bwd
    args = (q, k, v, do, out, lse, causal)
    got = KF.flash_bwd(*args)
    want = {f"flash_{fwd}": 1, f"flash_fwd_{fwd}": 1}
    want.update({"flash_bwd_fused": 1} if bwd == "fused" else
                {f"flash_dq_{bwd}": 1, f"flash_dkv_{bwd}": 1})
    assert {n: c - before[n] for n, c in KF.launches.items()
            if c != before[n]} == want
    again = KF.flash_bwd(*args)
    want = KF.flash_bwd_reference(*(t.float() for t in args[:6]), causal)
    torch.cuda.synchronize()
    # each gradient relative to its largest value; one that vanishes in
    # exact arithmetic (dq and dk over a single key: the softmax of one
    # score is constant) relative to the largest of the three instead,
    # since its reference is rounding noise
    largest = max(w.abs().max().item() for w in want)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        scale = w.abs().max().item()
        if Lk == 1 and scale < 1e-3 * largest:
            scale = largest
        assert (g.float() - w).abs().max().item() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dispatch_k7_and_k8(gen, dtype):
    """Under no_grad the text attention runs K7; with an input that
    requires grad, K8's forward, then its backward: in bf16 the
    tensor-core forward and the fused backward, in fp32 the SIMT forward,
    dq and dk/dv."""
    from lavila_tpu_torch.ops.attention import causal_attention
    qkv = torch.randn(4, 77, 3 * 512, generator=gen, device="cuda").to(
        dtype).requires_grad_()
    q, k, v = (t.reshape(4, 77, 8, 64) for t in qkv.chunk(3, dim=-1))
    branch = "tc" if dtype == torch.bfloat16 else "simt"
    before = dict(KF.launches)
    with torch.inference_mode():
        causal_attention(q.detach(), k.detach(), v.detach())
    causal_attention(q, k, v).float().square().sum().backward()
    bwd = ({"flash_bwd_fused": 1} if branch == "tc" else
           {"flash_dq_simt": 1, "flash_dkv_simt": 1})
    assert {n: c - before[n] for n, c in KF.launches.items()
            if c != before[n]} == {f"flash_{branch}": 1,
                                   f"flash_fwd_{branch}": 1, **bwd}
    assert qkv.grad.dtype == dtype and torch.isfinite(qkv.grad).all()


def test_flash_kernels_raise(gen):
    q = torch.randn(1, 9, 1, 160, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim <= 128"):
        KF.flash_attention(q, q, q, causal=True)
    q = torch.randn(1, 9, 2, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="heads of a token"):
        KF.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        KF.flash_attention(q.half(), q.half(), q.half())
    lse = torch.zeros(1, 9, 2, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        KF.flash_bwd(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2),
                     q, lse)


@pytest.mark.parametrize("dtype,wdtype", LN_DTYPES)
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_distilbert_layernorms_eps_1e12(gen, kernel, dtype, wdtype):
    """DistilBERT's norms at 16 captions of 77 tokens, 768 wide, eps 1e-12
    (a runtime float in the Triton forward and the CUDA backward): K3
    (``emb_layer_norm``) and K5 (``sa_layer_norm``, ``output_layer_norm``),
    forward and backward, against their plain versions in fp32 on the
    same values. The first 16 rows are constant at multiples of 1/16,
    whose fp32 sums are exact: their variance is 0, so rstd = 1e6 in
    every version and the output is the bias."""
    shape, eps = (16 * 77, 768), 1e-12
    D = shape[-1]
    a, b, dy = (torch.randn(*shape, generator=gen, device="cuda")
                for _ in range(3))
    k = torch.arange(16, device="cuda")[:, None]
    a[:16], b[:16] = k / 8, k / 16
    a, b, dy = (t.to(dtype) for t in (a, b, dy))
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
    bias = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
    if kernel == "K3":
        name, fwd_args = "layernorm", (a, w, bias, eps)
        fwd, fwd_ref = KL.layer_norm, KL.layer_norm_reference
        bwd_args = (a, w, dy, eps)
        bwd, bwd_ref = KL.layer_norm_bwd, KL.layer_norm_bwd_reference
    else:
        name, fwd_args = "add_layernorm_nosum", (a, b, w, bias, eps, False)
        fwd, fwd_ref = KL.add_layer_norm, KL.add_layer_norm_reference
        bwd_args = (a, b, w, dy, None, eps)
        bwd, bwd_ref = KL.add_layer_norm_bwd, KL.add_layer_norm_bwd_reference
    before = dict(KL.launches)
    y = fwd(*fwd_args)
    ref = fwd_ref(*(t.float() if isinstance(t, torch.Tensor) else t
                    for t in fwd_args))
    assert KL.launches[name] == before[name] + 1
    torch.testing.assert_close(y.float(), ref, rtol=0, atol=TOL[dtype])
    assert torch.equal(y[:16].float(), bias.to(dtype).float().expand(16, D))
    grads = bwd(*bwd_args)
    assert KL.launches[f"{name}_bwd"] == before[f"{name}_bwd"] + 1
    again = bwd(*bwd_args)
    want = bwd_ref(*(t.float() if isinstance(t, torch.Tensor) else t
                     for t in bwd_args))
    torch.cuda.synchronize()
    for g, x, r in zip(grads, again, want):
        assert torch.equal(g, x) and torch.isfinite(g).all()
        assert _rel_err(g, r) <= TOL[dtype]
