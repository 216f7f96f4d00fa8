"""The operations and bytes of the kernels' calls, and the model FLOPs,
against counts made by hand at the cells' shapes (bf16 rows, fp32 lse
and statistics; the kernel bounds of PERF.md's kernel table)."""

import pytest

from benchmark.portbench import files, peaks
from benchmark.roofline import decode_attention, divided, layernorm
from benchmark.roofline import model_flops

BENCH = files.benchmark_json()
DUAL = files.config("tsfl336-distilbert", BENCH)
NARR = files.config("narrator-tsfl336-gpt2xl", BENCH)


def test_divided_fwd_k6_batch32():
    # q, k, v read and out written: 4 x 32·4·576 rows x 1024 x 2 B; the
    # CLS key and value 2 x 32 x 1024 x 2 B; lse 32·4·576 x 16 heads x 4 B
    rec = (32, 4, 576, 1024, 16, "space", 2, "bfloat16")
    nbytes, ops, dtype = divided.cost(divided.FWD, rec)
    assert nbytes == 4 * 73728 * 1024 * 2 + 2 * 32 * 1024 * 2 + 73728 * 64
    assert ops == 2 * 2 * 73728 * 577 * 1024
    assert peaks.bound_s(nbytes, ops, dtype) * 1e3 == pytest.approx(
        0.1817, abs=1e-4)  # the K6 row's bound at batch 32


def test_divided_bwd_time_phase():
    rec = (32, 4, 576, 1024, 16, "time", 2, "bfloat16")
    nbytes, ops, _ = divided.cost(divided.BWD, rec)
    # q, k, v, dO read, dq, dk, dv written; ck, cv read, dck, dcv written
    assert nbytes == 7 * 73728 * 1024 * 2 + 4 * 32 * 1024 * 2 + 73728 * 64
    assert ops == 5 * 2 * 73728 * 5 * 1024  # 5 products over F + 1 keys


def test_layernorm_counts():
    n, D = 6272 * 768, 768
    nbytes, ops, dtype = layernorm.cost(layernorm.FWD,
                                        (n, D, 2, 2, False, False))
    assert (nbytes, ops, dtype) == (2 * n * 2 + 2 * D * 2, 8 * n, "float32")
    assert peaks.bound_s(nbytes, ops, dtype) * 1e3 == pytest.approx(
        0.0058, abs=1e-4)  # K3 fwd's bound at TSF-B's patch rows
    # K4 forward: a, b read, y and the sum written, fp32 γ/β
    assert layernorm.cost(layernorm.FWD, (n, D, 2, 4, True, True))[0] == (
        4 * n * 2 + 2 * D * 4)
    # K5 backward: a, b, dy read, dx written; γ read, dγ, dβ written
    assert layernorm.cost(layernorm.BWD, (n, D, 2, 4, True, False))[:2] == (
        4 * n * 2 + 3 * D * 4, 13 * n)
    # K3 backward
    assert layernorm.cost(layernorm.BWD, (n, D, 2, 2, False, False))[:2] == (
        3 * n * 2 + 3 * D * 2, 12 * n)


def test_decode_counts():
    nbytes, ops, dtype = decode_attention.cost(
        decode_attention.CALL, (160, 1600, 15, 2, "bfloat16"))
    assert nbytes == (2 * 160 * 15 * 1600 + 4 * 160 * 1600) * 2
    assert ops == 4 * 160 * 16 * 1600
    assert peaks.bound_s(nbytes, ops, dtype) * 1e3 == pytest.approx(
        0.0052, abs=1e-4)  # K9's bound at 160 rows


def test_tower_flops_by_hand():
    # TSF-L@336: 24 blocks of 1024 wide, 2305 tokens (CLS + 4 x 576)
    linear = 2305 * (3 + 1 + 3 + 1 + 4 + 4) * 1024 * 1024 * 2   # a block
    space = 4 * 576 * 577 * 1024 * 2 * 2
    time = 4 * 576 * 5 * 1024 * 2 * 2
    cls = 2 * 2305 * 1024 * 2 * 2
    embed = 4 * 576 * (3 * 14 * 14) * 1024 * 2
    assert model_flops.tower_forward(DUAL["tower"], 1) == (
        24 * (linear + space + time + cls) + embed)


def test_train_step_flops_by_hand():
    per_caption = 6 * (77 * (4 * 768 * 768 + 2 * 768 * 3072) * 2
                       + 77 * 77 * 768 * 4)
    fwd = (model_flops.tower_forward(DUAL["tower"], 32) + 32 * per_caption
           + 32 * (1024 + 768) * 256 * 2 + 32 * 32 * 256 * 2)
    assert model_flops.train_step(DUAL, 32, 77) == 3 * fwd
    # about 6 TFLOP a clip
    assert 5.9e12 < model_flops.train_step(DUAL, 32, 77) / 32 < 6.1e12


def test_narrate_flops_by_hand():
    D, V = 1600, 50257
    per_step = (48 * (3 + 1 + 4 + 4) * D * D * 2            # self layers
                + 16 * ((1 + 1 + 4 + 4) * D * D * 2 + 256 * D * 4)  # cross
                + D * V * 2)                                # the LM head
    self_attn = 48 * sum((i + 1) * D * 4 for i in range(76))
    S = 2305
    pool = (S * 1024 * 128 * 2 + 256 * D * D * 2 + 25 * 256 * S * 64 * 4
            + 256 * D * D * 2)
    cross_kv = 16 * 256 * D * 2 * D * 2
    total = (model_flops.tower_forward(NARR["tower"], 96)
             + 96 * (pool + cross_kv) + 960 * (76 * per_step + self_attn))
    assert model_flops.narrate(NARR, 96, 960, 76) == total


class _Run:
    def __init__(self, device_s, calls):
        self.summary = {"busy_s": 1.0, "window_s": 2.0,
                        "device_s": device_s}
        self.calls = calls


@pytest.mark.parametrize("device_s,calls,expect", [
    ({"decode_attention_kernel": 0.5}, {}, "fault"),
    ({"other_kernel": 0.5}, {"m.f": [(160, 1600, 15, 2, "bfloat16")]},
     "fault"),
    ({"other_kernel": 0.5}, {}, None)])
def test_share_fails_where_names_moved(device_s, calls, expect):
    """Kernels of the pattern that no probe saw called, or probed calls
    with no kernel of the pattern, fail the run; neither is a kernel off
    the path, which reads nothing."""
    from benchmark.portbench.trace import ReaderFault
    from benchmark.roofline import share
    run = _Run(device_s, calls)
    if expect == "fault":
        with pytest.raises(ReaderFault):
            share(run, "decode_attention", {"m.f": None},
                  lambda t, r: (1, 1, "bfloat16"))
    else:
        assert share(run, "decode_attention", {"m.f": None},
                     lambda t, r: (1, 1, "bfloat16")) is None


def test_probe_of_a_missing_entry_fails():
    from benchmark.portbench.trace import Probes, ReaderFault
    with pytest.raises(ReaderFault):
        with Probes({"benchmark.roofline.no_such_function": None}):
            pass
    with pytest.raises(ReaderFault):
        with Probes({"benchmark.no_such_module.f": None}):
            pass


@pytest.mark.parametrize("reader", [
    "divided_train_roofline", "layernorm_train_roofline",
    "divided_encode_roofline", "decode_attention_roofline"])
def test_readers_probe_entries_the_port_has(reader):
    """Every entry point a reader probes exists in the port."""
    import importlib
    mod = files.reader(reader)
    for target in mod.PROBES:
        module, attr = target.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(module), attr))
