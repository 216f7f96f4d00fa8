"""The data-parallel train cell (``drivers/train_dp.py``) at MINI sizes on
the CPU: four gloo ranks, rank 0 in the test's process and the others
started by the driver. A sound run is correct, reads its readers and
leaves no rank behind; its reference is the one-process reference's on
the global batch; a gradient summed but not averaged over the ranks
fails the check."""

import json

import pytest
import torch

from benchmark.drivers import reference_weights, train_dp
from benchmark.portbench import files, harness
from benchmark.portbench import traffic as T
from benchmark.reference import models as R
from benchmark.reference.numerics import Numerics, strict_fp32
from benchmark.tests import mini

CELL = "mini-train-dp4"
# 4 ranks of 2 rows: a global batch of the MINI train cell's 4 twice over
TRAFFIC = {**mini.TRAFFIC["mini-train"], "batch": 8, "ranks": 4}
SECONDS = 1.0
SEED = 2 ** 31 + 57


@pytest.fixture
def dp_root(tmp_path, monkeypatch):
    root = mini.make_root(tmp_path)
    b = root / "benchmark"
    (b / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "config": "mini-dual", "traffic": CELL, "chips": 4,
        "driver": "train_dp", "why": "test",
        "check": mini.CELLS["mini-train"][2]}))
    bench = files.benchmark_json(root)
    bench["workloads"].append({"name": CELL, "config": "mini-dual",
                               "traffic": CELL, "chips": 4, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "train_clips_per_s" or m["name"].endswith(
                ".train_dp4"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # the other ranks register the MINI model in their own zoo
    monkeypatch.setattr(train_dp, "WORKER", "benchmark.tests.dp_rank")
    # four ranks share the host's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield root
    torch.set_num_threads(threads)


def _run(root, trace=False):
    return harness.run_cell(CELL, SEED, SECONDS, trace, "cpu", root)


def test_sound_run_correct_and_traced(dp_root):
    result, extra = _run(dp_root, trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2
    # the step's average has no device time on the CPU: no reading
    assert set(result["metrics"]) == {"mfu.train_dp4"}
    assert result["metrics"]["mfu.train_dp4"]["value"] > 0
    # the program's losses are the global batch's, as the reference's
    assert extra["program_loss"] == pytest.approx(extra["reference_loss"],
                                                  rel=mini.CELLS[
                                                      "mini-train"][2][
                                                      "limits"]["loss_gap"])


def test_reference_is_the_global_batch(dp_root):
    """The split reference's first loss is the one-process reference's
    over the global batch (float32 on both: 1e-5, the sums' order)."""
    _, extra = _run(dp_root)
    bench = files.benchmark_json(dp_root)
    cell = files.workload(CELL, dp_root)
    ctx = harness.Context(dp_root, bench, cell,
                          files.config(cell["config"], bench, dp_root),
                          files.traffic(cell["traffic"], dp_root), SEED,
                          "cpu")
    strict_fp32()
    p = reference_weights(ctx, R.dual_encoder_spec(ctx.cfg), torch.float32)
    ids, mask = T.captions(ctx.traffic, SEED, "cpu")
    frames = T.clips(ctx.traffic, ctx.cfg["tower"], SEED, "cpu",
                     torch.bfloat16)
    with torch.no_grad():
        loss = R.clip_loss(p, {"frames": frames[0], "text": ids[0],
                               "mask": mask[0]}, ctx.cfg, Numerics("fp32"))
    assert extra["reference_loss"][0] == pytest.approx(float(loss),
                                                       rel=1e-5)


def test_gradient_not_averaged_fails(dp_root, monkeypatch):
    """Rank 0 sums the ranks' gradients without dividing by the ranks:
    its first gradient is 4 times the global one, past ``grad_gap``."""
    from lavila_tpu_torch.parallel import mesh

    def summed(grads, group=None):
        mesh._coalesced(list(grads), torch.distributed.all_reduce)

    monkeypatch.setattr(mesh, "average_grads", summed)
    result, extra = _run(dp_root)
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] > 1
