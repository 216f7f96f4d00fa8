"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device, and
runs on a machine with an H100 (nvcc installed) with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from lavila_tpu_torch.kernels import cls_row as KC
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
    operator: the forward and backward kernels, no fallback."""
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


# the CLS row's cases (B, F, N, H, d, pad): TSF-L@336's encode and train
# batches, TSF-B's, the fine-tunes' 16 frames, MINI's head_dim 16, a
# tensor-parallel rank's 4 local heads, head_dim 24 (3 chunks of 4 lanes
# in bf16, one idle); pad > 0 widens the packed rows off 16-byte
# boundaries (element loads)
CLS_ROW_CASES = [(16, 4, 576, 16, 64, 0), (32, 4, 576, 16, 64, 0),
                 (8, 4, 196, 12, 64, 0), (2, 16, 196, 12, 64, 0),
                 (4, 4, 16, 4, 16, 0), (2, 4, 576, 4, 64, 0),
                 (3, 2, 50, 3, 24, 0), (2, 4, 196, 12, 64, 1)]


def _cls_row_args(gen, B, F, N, H, d, dtype, pad=0):
    """cls_q/k/v and kp/vp as the attention block passes them: row views
    of one (B, 1, 3D) and one (B, F, N, 3D) projection output."""
    D = H * d
    qkv = torch.randn(B, F, N, 3 * D + pad, generator=gen,
                      device="cuda").to(dtype)
    cls = torch.randn(B, 1, 3 * D + pad, generator=gen,
                      device="cuda").to(dtype)
    cq, ck, cv = (t.reshape(B, 1, H, d) for t in cls[..., :3 * D].chunk(3, -1))
    _, kp, vp = (t.reshape(B, F, N, H, d)
                 for t in qkv[..., :3 * D].chunk(3, -1))
    return [cq, ck, cv, kp, vp]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,N,H,d,pad", CLS_ROW_CASES)
def test_cls_row_kernel(gen, B, F, N, H, d, pad, dtype):
    """The CLS row's forward and backward kernels on strided row views
    against the plain versions in fp32 on the same values (the forward
    against ``cls_row_attention_reference``, the backward, on the
    kernel's lse and o, against ``cls_row_bwd_reference``, which the CPU
    tests hold against the JAX package's VJP; errors relative to each
    tensor's largest value), one launch a direction, bit-identical on a
    second call."""
    args = _cls_row_args(gen, B, F, N, H, d, dtype, pad)
    assert args[3].stride(2) == 3 * H * d + pad  # views, no copies
    before = dict(KC.launches)
    out, lse, o = KC.cls_row_op(*args)
    assert KC.launches["cls_row_fwd"] == before["cls_row_fwd"] + 1
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = KC.cls_row_bwd(*args, g, lse, o)
    assert KC.launches["cls_row_bwd"] == before["cls_row_bwd"] + 1
    again = KC.cls_row_bwd(*args, g, lse, o)
    ref_in = [a.float() for a in args]
    ref = KC.cls_row_attention_reference(*ref_in)
    ref_grads = KC.cls_row_bwd_reference(*ref_in, g.float(), lse, o)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _rel_err(out, ref) <= TOL[dtype]
    assert torch.equal(KC.cls_row_op(*args)[0], out)
    _, ref_lse, ref_o = KC.cls_row_fwd_reference(*ref_in)
    # lse and the fp32 output from the same values: summation order alone
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert _rel_err(o, ref_o) <= 1e-4
    for name, a, b, r in zip(("dcls_q", "dcls_k", "dcls_v", "dkp", "dvp"),
                             got, again, ref_grads):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert torch.equal(a, b), name
        assert _rel_err(a, r) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cls_row_kernel_refuses(gen, dtype):
    """head_dim not a multiple of 8, or past 128, raises; no fallback."""
    for d in (12, 136):
        args = _cls_row_args(gen, 2, 2, 8, 2, d, dtype)
        with pytest.raises(ValueError):
            KC.cls_row(*args)


def test_cls_row_tower_launches(gen):
    """A TSF-L@336 tower pass (bf16) runs the CLS row's kernels in both
    phases of its 24 blocks: 48 forward launches, and 48 backward ones
    when the embedding's gradient is taken; no plain path."""
    from lavila_tpu_torch.models import build_model
    model = build_model("CLIP_OPENAI_TIMESFORMER_LARGE_336PX",
                        device="cuda", dtype=torch.bfloat16, generator=gen)
    frames = torch.randn(1, 4, 336, 336, 3, generator=gen,
                         device="cuda").bfloat16()
    before = dict(KC.launches)
    with torch.inference_mode():
        model.encode_image(frames)
    assert KC.launches["cls_row_fwd"] == before["cls_row_fwd"] + 48
    assert KC.launches["cls_row_bwd"] == before["cls_row_bwd"]
    model.encode_image(frames).float().square().sum().backward()
    assert KC.launches["cls_row_fwd"] == before["cls_row_fwd"] + 96
    assert KC.launches["cls_row_bwd"] == before["cls_row_bwd"] + 48


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


# the forward kernel's calls: K3, K4 (with the sum) and K5
LN_FWD_KERNELS = {"K3": "layernorm", "K4": "add_layernorm",
                  "K5": "add_layernorm_nosum"}
# the path's rows: one, 8, a decode step's, GPT-2 XL's caption rows,
# DistilBERT's, TSF-B's patches, TSF-L@336's and the fine-tune's
LN_FWD_ROWS = (1, 8, 160, 608, 1232, 6272, 18432, 25088)
LN_FWD_DS = (512, 768, 1024, 1600)


def _ln_fwd(kernel, x, r, w, b, eps):
    """K3/K4/K5 forward through the wrapper and its plain version in fp32
    on the same values, each as a tuple."""
    if kernel == "K3":
        return ((KL.layer_norm(x, w, b, eps),),
                (KL.layer_norm_reference(x.float(), w.float(), b.float(),
                                         eps),))
    got = KL.add_layer_norm(x, r, w, b, eps, kernel == "K4")
    ref = KL.add_layer_norm_reference(x.float(), r.float(), w.float(),
                                      b.float(), eps, kernel == "K4")
    return (got, ref) if kernel == "K4" else ((got,), (ref,))


def _assert_ln_fwd_close(got, ref, dtype):
    """fp32: summation order (1e-4). bf16: one rounding of each output,
    at most 2^-8 of its magnitude, and not less than 2e-2."""
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        lim = torch.full_like(r, TOL[dtype])
        if dtype == torch.bfloat16:
            lim = torch.maximum(lim, r.abs() * 2.0 ** -8)
        excess = ((g.float() - r).abs() - lim).max().item()
        assert excess <= 0, excess


def _ln_fwd_inputs(gen, shape, kernel, dtype, wdtype=None):
    D = shape[-1]
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    r = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
         if kernel != "K3" else None)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(
        wdtype or dtype)
    b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(
        wdtype or dtype)
    return x, r, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", LN_FWD_DS)
@pytest.mark.parametrize("rows", LN_FWD_ROWS)
@pytest.mark.parametrize("kernel", list(LN_FWD_KERNELS))
def test_layernorm_fwd_kernel_path_rows(gen, kernel, rows, D, dtype):
    """The forward kernel at the path's rows and widths against its plain
    version in fp32 on the same values, one launch a call."""
    x, r, w, b = _ln_fwd_inputs(gen, (rows, D), kernel, dtype)
    name = LN_FWD_KERNELS[kernel]
    before = dict(KL.launches)
    got, ref = _ln_fwd(kernel, x, r, w, b, 1e-6)
    assert KL.launches[name] == before[name] + 1
    assert sum(KL.launches.values()) == sum(before.values()) + 1
    torch.cuda.synchronize()
    _assert_ln_fwd_close(got, ref, dtype)


@pytest.mark.parametrize("dtype,wdtype", LN_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1600), (8, 768), (2 * 77 + 3, 512),
                                   (2 * 77 + 3, 1600), (160, 1, 1600),
                                   (5, 3, 200), (3, 100), (9, 37),
                                   (2, 4000), (2, 4104)])
@pytest.mark.parametrize("kernel", list(LN_FWD_KERNELS))
def test_layernorm_fwd_kernel_ragged(gen, kernel, shape, dtype, wdtype):
    """Ragged row counts (1, 8, 2·77 + 3), rows that are not whole 16-byte
    chunks (D = 37, and 100 in bf16: the scalar variant), two chunks a
    thread (D = 4000 in bf16), rows past the register path (D = 4104, and
    4000 in fp32: the scalar variant), fp32 γ/β with bf16 rows;
    bit-identical over two calls."""
    x, r, w, b = _ln_fwd_inputs(gen, shape, kernel, dtype, wdtype)
    got, ref = _ln_fwd(kernel, x, r, w, b, 1e-5)
    again, _ = _ln_fwd(kernel, x, r, w, b, 1e-5)
    torch.cuda.synchronize()
    _assert_ln_fwd_close(got, ref, dtype)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    row_bytes = shape[-1] * x.element_size()
    assert KL.fwd_shape(shape[-1], x.element_size()).vec == (
        row_bytes % 16 == 0 and row_bytes <= 2 * 256 * 16)


@pytest.mark.parametrize("rows", [KL.FWD_MANY_ROWS - 1, KL.FWD_MANY_ROWS])
def test_layernorm_fwd_kernel_both_sides_of_many_rows(gen, rows):
    """D = 1600 bf16 on 7 warps of a chunk a thread below
    ``FWD_MANY_ROWS`` rows and on 4 warps of two from it: the same
    result as the plain version either way."""
    plan = KL.fwd_plan(rows, KL.fwd_shape(1600, 2))
    assert (plan.warps, plan.per_thread) == ((7, 1) if rows <
                                             KL.FWD_MANY_ROWS else (4, 2))
    for kernel in LN_FWD_KERNELS:
        x, r, w, b = _ln_fwd_inputs(gen, (rows, 1600), kernel,
                                    torch.bfloat16)
        got, ref = _ln_fwd(kernel, x, r, w, b, 1e-6)
        torch.cuda.synchronize()
        _assert_ln_fwd_close(got, ref, torch.bfloat16)


def test_layernorm_fwd_kernel_beta_takes_gamma_dtype(gen):
    """γ fp32 with a bf16 β (and the reverse): the wrapper hands the
    kernel β in γ's dtype, one forward launch a call."""
    x, _, w, b = _ln_fwd_inputs(gen, (160, 1600), "K3", torch.bfloat16,
                                torch.float32)
    for w_, b_ in ((w, b.bfloat16()), (w.bfloat16(), b)):
        before = KL.launches["layernorm"]
        y = KL.layer_norm(x, w_, b_, 1e-6)
        assert KL.launches["layernorm"] == before + 1
        ref = KL.layer_norm_reference(x.float(), w_.float(), b_.float(),
                                      1e-6)
        _assert_ln_fwd_close((y,), (ref,), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", list(LN_FWD_KERNELS))
def test_layernorm_fwd_kernel_offset_view(gen, kernel, dtype):
    """A contiguous view 2 bytes (one bf16 value; fp32: 4) into its
    storage, not 16-byte aligned: the scalar variant, against the plain
    version."""
    D = 1600
    base = torch.randn(161 * D + 1, generator=gen, device="cuda").to(dtype)
    x = base[1:1 + 160 * D].view(160, D)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert not KL.fwd_shape(D, x.element_size(), aligned=False).vec
    _, r, w, b = _ln_fwd_inputs(gen, (160, D), kernel, dtype)
    got, ref = _ln_fwd(kernel, x, r, w, b, 1e-6)
    torch.cuda.synchronize()
    _assert_ln_fwd_close(got, ref, dtype)


@pytest.mark.parametrize("rows,D", [(160, 1600), (6272, 768), (3, 100)])
def test_layernorm_fwd_one_launch_a_call(gen, rows, D):
    """The profiler sees one forward kernel launch a call."""
    x, _, w, b = _ln_fwd_inputs(gen, (rows, D), "K3", torch.bfloat16)
    KL.layer_norm(x, w, b, 1e-6)  # built and planned
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a trace that caught no kernel at all is taken again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                KL.layer_norm(x, w, b, 1e-6)
            torch.cuda.synchronize()
        device = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    kernels = [ev.name for ev in device if "ln_fwd" in ev.name]
    assert len(kernels) == 3, [ev.name for ev in device]


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
# GPT-2 XL's 160 decode rows (25 heads), GPT-2 large's (20 heads of 64 =
# 1280, the ViT-B/16 narrator's), TSF-B's width, a ragged small case
@pytest.mark.parametrize("B,K,H", [(160, 77, 25), (160, 77, 20), (16, 77, 12),
                                   (3, 9, 2)])
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
    # GPT-2 XL's (25 heads of 64) at 8 captions of 76 tokens: the causal
    # self-attention on c_attn's row views (fused backward) and the
    # cross-attention over the 256 pooled image tokens (split backward)
    (8, 76, 76, 25, 64, True, 0),
    (8, 76, 256, 25, 64, False, 0),
    # the tile edges, on in_proj views
    *[(2, L, L, H, 64, causal, 0) for L in (1, 16, 77, 80, 112, 128, 129)
      for H in (8, 12) for causal in (True, False)],
    # the CLIP ViTs' self-attention over every token: B/32's 50 (one key
    # tile; the fused backward), B/16's 197, L/14's 257 and L/14@336's
    # 577 = 9·64 + 1 (several 128-query blocks, the producer's ring of
    # 64-key tiles, its last tile one valid key; the split backward)
    (4, 50, 50, 12, 64, False, 0),
    (2, 197, 197, 12, 64, False, 0),
    (2, 257, 257, 16, 64, False, 0),
    (2, 577, 577, 16, 64, False, 0),
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
    assert KF.flash_branch(q, k, v, do) == bwd
    args = (q, k, v, do, lse, causal)
    got = KF.flash_bwd(*args)
    want = {f"flash_{fwd}": 1, f"flash_fwd_{fwd}": 1}
    want.update({"flash_bwd_fused": 1} if bwd == "fused" else
                {f"flash_dq_{bwd}": 1, f"flash_dkv_{bwd}": 1})
    assert {n: c - before[n] for n, c in KF.launches.items()
            if c != before[n]} == want
    again = KF.flash_bwd(*args)
    want = KF.flash_bwd_reference(*(t.float() for t in args[:5]), causal)
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
@pytest.mark.parametrize("Lk", [76, 256])
def test_flash_bwd_near_copy_keys(gen, Lk, dtype):
    """Keys and values sharing a large common part (GPT-2's
    cross-attention over the narrator's pooled image tokens at
    initialisation) make dq = dS·K cancel: K8's dq (bf16: fused at 76
    keys, split at 256; fp32: SIMT) stays within 10% (bf16) or 1% (fp32)
    of the fp64 gradient, as delta = rowsum(P·dP) keeps it."""
    B, Lq, H, d = 2, 76, 4, 64

    def near_copies(L):
        return (torch.randn(B, 1, H, d, generator=gen, device="cuda")
                + 0.05 * torch.randn(B, L, H, d, generator=gen,
                                     device="cuda"))
    q = torch.randn(B, Lq, H, d, generator=gen, device="cuda").to(dtype)
    k, v = (near_copies(Lk).to(dtype) for _ in range(2))
    do = torch.randn(B, Lq, H, d, generator=gen, device="cuda").to(dtype)
    ins = [t.double().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", *ins[:2]) * d ** -0.5
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), ins[2])
    want = torch.autograd.grad(o, ins[0], do.double())[0]
    qg = q.clone().requires_grad_()
    got = torch.autograd.grad(KF.flash_attention(qg, k, v), qg, do)[0]
    err = ((got.double() - want).norm() / want.norm()).item()
    assert err <= (0.1 if dtype == torch.bfloat16 else 0.01), err


def near_copy_phase(gen, axis, B, F, N, H, dtype, device="cuda"):
    """Inputs of one divided phase whose keys and values (the CLS rows
    among them) share a common part 20x their spread, and their q/k/v/ck/
    cv gradients by fp64 autograd through the plain version: dq = dS·K
    cancels there, and keeps whatever sum(dS) != 0 the backward's delta
    leaves times the common part."""
    d = 64
    D = H * d

    def near_copies(*shape):
        common = torch.randn(B, *[1] * (len(shape) - 1), D, generator=gen,
                             device=device)
        return common + 0.05 * torch.randn(B, *shape[1:], D, generator=gen,
                                           device=device)
    q = torch.randn(B, F, N, D, generator=gen, device=device).to(dtype)
    kv = [near_copies(B, F, N) for _ in range(2)]
    k, v = (t.to(dtype) for t in kv)
    ck, cv = ((t[:, 0, 0] + 0.05 * torch.randn(B, D, generator=gen,
                                                device=device)).to(dtype)
              for t in kv)
    do = torch.randn(B, F, N, D, generator=gen, device=device).to(dtype)
    ins = [t.double().requires_grad_() for t in (q, k, v, ck, cv)]
    out, _ = KD.divided_phase_reference(*ins, axis, H, d ** -0.5)
    want = torch.autograd.grad(out, ins, do.double())
    return (q, k, v, ck, cv), do, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,N", [("space", 196), ("time", 196),
                                    ("space", 576)])
def test_divided_bwd_near_copy_keys(gen, axis, N, dtype):
    """K1 (TSF-B's N = 196), K2 (F = 4) and K6 (N = 576) at keys and
    values that share a large common part: dq, dck and dcv stay within
    10% (bf16: the tensor cores, delta = rowsum(P·dP)) or 1% (fp32: SIMT,
    delta = rowsum(dO·O) from the fp32 O) of the fp64 gradient's norm.
    With rowsum(dO·O) from the O rounded to bf16 the plain version's bf16
    dq read 9.0x (space) and 1.3x (time) that norm."""
    ins, do, want = near_copy_phase(gen, axis, 2, 4, N, 4, dtype)
    d = ins[0].shape[-1] // 4
    out, lse = KD.divided_phase(*ins, axis, 4, d ** -0.5)
    key = _counter("space_big" if N > 256 else axis, dtype, d, bwd=True)
    before = KD.launches[key]
    got = KD.divided_phase_bwd(*ins, do, out, lse, axis, 4, d ** -0.5)
    assert KD.launches[key] == before + 1
    limit = 0.1 if dtype == torch.bfloat16 else 0.01
    for name, i in (("dq", 0), ("dck", 3), ("dcv", 4)):
        err = ((got[i].double() - want[i]).norm() / want[i].norm()).item()
        assert err <= limit, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt2_attentions_take_k7_and_k8(gen, dtype):
    """GPT-2's cache-less attentions go through the flash kernels: per
    layer K8 at the causal self-attention and at the cross-attention in
    training (fused and split backward in bf16), K7 at both under
    inference; the decode step none of them."""
    from lavila_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                              augment_config, init_cache)
    cfg = augment_config(GPT2Config(vocab_size=300, n_positions=80,
                                    n_embd=128, n_layer=2, n_head=2),
                         cross_attn_freq=1)
    with torch.device("cuda"):
        m = GPT2LMHead(cfg)
    m.init_weights(gen)
    m = m.to(dtype)
    ids = torch.randint(0, 300, (2, 76), generator=gen, device="cuda")
    img = torch.randn(2, 256, 128, generator=gen, device="cuda").to(dtype)

    def counted(fn):
        before = dict(KF.launches)
        fn()
        torch.cuda.synchronize()
        return {n: c - before[n] for n, c in KF.launches.items()
                if c != before[n]}
    tc = dtype == torch.bfloat16
    fwd = "tc" if tc else "simt"
    got = counted(lambda: m(ids, encoder_states=img).float().sum()
                  .backward())
    assert got == {f"flash_fwd_{fwd}": 4,
                   **({"flash_bwd_fused": 2, "flash_dq_split": 2,
                       "flash_dkv_split": 2} if tc else
                      {"flash_dq_simt": 4, "flash_dkv_simt": 4})}
    with torch.no_grad():
        assert counted(lambda: m(ids, encoder_states=img)) == {
            f"flash_{fwd}": 4}
        kv = m.precompute_cross_kv(img)
        cache = init_cache(cfg, 2, 8, dtype=dtype, device="cuda")
        assert counted(lambda: m(ids[:, :1], cross_kv=kv, cache=cache,
                                 cache_index=0)) == {}


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
                     lse)


@pytest.mark.parametrize("dtype,wdtype", LN_DTYPES)
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_distilbert_layernorms_eps_1e12(gen, kernel, dtype, wdtype):
    """DistilBERT's norms at 16 captions of 77 tokens, 768 wide, eps 1e-12
    (a runtime float in both CUDA kernels, forward and backward): K3
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



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_takes_k7_and_k8(gen, dtype):
    """A ViT's blocks go through the flash kernels without the causal
    mask: K7 a block under inference, K8's forward and backward a block in
    training (197 tokens: the split backward in bf16), and every
    LayerNorm (ln_pre, ln_1, ln_2, ln_post) through K3."""
    from lavila_tpu_torch.kernels import layernorm as KL
    from lavila_tpu_torch.models.openai_clip import VisionTransformer
    with torch.device("cuda"):
        vit = VisionTransformer(224, 16, width=128, layers=2, heads=2,
                                output_dim=32)
    vit.init_weights(gen)
    vit = vit.to(dtype)
    x = torch.randn(2, 224, 224, 3, generator=gen, device="cuda")

    def counted(fn):
        before = {**{f"KF.{n}": c for n, c in KF.launches.items()},
                  "K3": KL.launches["layernorm"],
                  "K3 bwd": KL.launches["layernorm_bwd"]}
        fn()
        torch.cuda.synchronize()
        after = {**{f"KF.{n}": c for n, c in KF.launches.items()},
                 "K3": KL.launches["layernorm"],
                 "K3 bwd": KL.launches["layernorm_bwd"]}
        return {n: c - before[n] for n, c in after.items() if c != before[n]}
    fwd = "tc" if dtype == torch.bfloat16 else "simt"
    bwd = "split" if dtype == torch.bfloat16 else "simt"
    with torch.inference_mode():
        assert counted(lambda: vit(x)) == {f"KF.flash_{fwd}": 2, "K3": 6}
    assert counted(lambda: vit(x).float().sum().backward()) == {
        f"KF.flash_fwd_{fwd}": 2, f"KF.flash_dq_{bwd}": 2,
        f"KF.flash_dkv_{bwd}": 2, "K3": 6, "K3 bwd": 6}
    assert torch.isfinite(vit.conv1.weight.grad).all()
