"""The LayerNorm backward kernel's launch plan (``kernels/layernorm.py``:
``bwd_shape``, ``bwd_plan``, ``bwd_smem``; the kernel itself is
``csrc/layernorm_bwd.cu``) at every (rows, D, dtype) that the port's
train paths hand it: each row taken by exactly one block and one warp,
shared memory within a block's 227 KB, the grid no larger than the
resident blocks, and the small calls (CLS rows, one row) on one block.
Plain Python: runs without a card."""

import pytest
import torch

from lavila_tpu_torch.kernels import layernorm as KL

SMS = 132  # an H100's SMs

# (what, rows, D, row tensors read): K3 reads 2 (x, dy), K4/K5 3
PATH_CALLS = []
for B in (2, 4, 8, 16, 32, 48):
    PATH_CALLS += [
        ("TSF-B patches", B * 4 * 196, 768, 2),
        ("TSF-B K4/K5", B * 4 * 196, 768, 3),
        ("TSF-B CLS", B, 768, 2),
        ("TSF-B text", B * 77, 512, 2),
    ]
for B in (2, 4, 8, 16, 32):
    PATH_CALLS += [
        ("fine-tune patches", B * 16 * 196, 768, 2),
        ("TSF-L@224 patches", B * 4 * 256, 1024, 2),
        ("TSF-L@336 patches", B * 4 * 576, 1024, 2),
        ("TSF-L@336 K4/K5", B * 4 * 576, 1024, 3),
        ("TSF-L CLS", B, 1024, 2),
        ("TSF-L text", B * 77, 768, 2),
    ]
PATH_CALLS += [("one row", 1, 768, 2), ("one row K4/K5", 1, 1024, 3),
               ("ragged", 6273, 768, 2), ("GPT-2 XL width", 64, 1600, 2)]
DTYPES = (torch.float32, torch.bfloat16)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _rows_of(plan: KL.BwdPlan, rows: int) -> list:
    """Every row as the kernel takes it: block b over [b * per, (b + 1) *
    per), warp w of a block over first + w, first + w + warps, ..."""
    got = []
    for b in range(plan.grid):
        first = b * plan.rows_per_block
        last = min(first + plan.rows_per_block, rows)
        assert last > first, f"block {b} has no rows"
        for w in range(plan.shape.warps):
            got += range(first + w, last, plan.shape.warps)
    return got


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("what,rows,D,tensors", PATH_CALLS,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}" for c in PATH_CALLS])
def test_plan_covers_each_row_once(what, rows, D, tensors, dtype):
    shape = KL.bwd_shape(D, _itemsize(dtype), tensors)
    # a row is whole 16-byte chunks: the ring path, two slots a warp
    assert shape.vec and shape.slots == KL.SLOTS == 2
    assert shape.per_lane * 32 * 16 >= D * _itemsize(dtype)
    assert shape.smem == KL.bwd_smem(D, _itemsize(dtype), tensors,
                                     shape.warps, True)
    assert shape.smem <= KL.SMEM_MAX
    for blocks_per_sm in (1, 2, 3, 4):
        plan = KL.bwd_plan(rows, shape, blocks_per_sm, SMS)
        assert plan.grid <= blocks_per_sm * SMS
        covered = _rows_of(plan, rows)
        assert sorted(covered) == list(range(rows))
        if rows > shape.warps * shape.slots:
            # past one block's rings: at least a row a warp a block
            assert not plan.single
            assert plan.rows_per_block >= shape.warps


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,D", [(1, 768), (8, 768), (8, 1024),
                                    (16, 768), (16, 1024), (1, 1600)])
def test_small_calls_take_one_block(rows, D, dtype):
    """CLS rows up to batch 16 and single rows: one block, which holds
    every row in its warps' rings at once."""
    shape = KL.bwd_shape(D, _itemsize(dtype), 2)
    plan = KL.bwd_plan(rows, shape, 2, SMS)
    assert plan.single and plan.grid == 1 and plan.rows_per_block == rows
    assert rows <= shape.warps * shape.slots


def test_patch_rows_fill_the_resident_blocks():
    """TSF-B's (6272, 768) bf16 rows at two blocks an SM: 262 blocks of
    24 rows, 3 a warp, every SM busy; the ring of 8 warps x 2 slots x 3 KB
    a block."""
    shape = KL.bwd_shape(768, 2, 2)
    plan = KL.bwd_plan(6272, shape, 2, SMS)
    assert (shape.warps, shape.slots) == (8, 2)
    assert (plan.grid, plan.rows_per_block) == (262, 24)
    assert shape.warps * shape.slots * 2 * 768 * 2 == 49152


@pytest.mark.parametrize("D,itemsize,tensors", [(1024, 4, 3), (1600, 4, 3),
                                                (2048, 4, 3), (4096, 2, 3)])
def test_large_rows_take_fewer_warps(D, itemsize, tensors):
    """Rows whose two slots of 8 warps exceed a block's shared memory run
    4 warps a block, still two slots; D = 1024 fp32 K4/K5 keeps 8 warps
    on one block an SM."""
    shape = KL.bwd_shape(D, itemsize, tensors)
    assert shape.smem <= KL.SMEM_MAX and shape.slots == 2
    assert shape.warps == (8 if D == 1024 else 4)
    assert shape.warps * shape.slots * tensors * D * itemsize \
        <= KL.SMEM_MAX


@pytest.mark.parametrize("D,itemsize,per_lane", [(100, 2, 8), (37, 4, 8),
                                                 (1001, 2, 32), (255, 4, 8)])
def test_unchunked_rows_take_the_scalar_variant(D, itemsize, per_lane):
    """Rows that are not whole 16-byte chunks, or not 16-byte aligned:
    the scalar variant, a value a lane per 32 columns, no ring."""
    for aligned in (True, False):
        shape = KL.bwd_shape(D, itemsize, 2, aligned)
        assert not shape.vec and shape.slots == 0
        assert shape.per_lane == per_lane
        assert KL.bwd_plan(shape.warps, shape, 2, SMS).single
    assert not KL.bwd_shape(768, 2, 2, aligned=False).vec


@pytest.mark.parametrize("D,itemsize", [(1025, 4), (2049, 2), (4097, 4),
                                        (8192, 2)])
def test_rows_the_kernel_does_not_take_raise(D, itemsize):
    with pytest.raises(ValueError, match="no LayerNorm backward kernel"):
        KL.bwd_shape(D, itemsize, 2)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain backward and counts no
    launch of either branch."""
    before = dict(KL.launches)
    x, dy = torch.randn(3, 64), torch.randn(3, 64)
    got = KL.layer_norm_bwd(x, torch.ones(64), dy, 1e-5)
    want = KL.layer_norm_bwd_reference(x, torch.ones(64), dy, 1e-5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert KL.launches == before
