"""The port's launcher (``lavila_tpu_torch/cli/launch.py``) on the CPU:
real gloo process groups of two ranks, each a process, as
``tests/test_multiprocess.py`` drives the JAX pod launcher.

  * ``pretrain`` on MINI over two ranks started with ``--coordinator
    --num-processes --process-id``: the ranks' parameters equal after
    the global steps, one checkpoint with its config and one ``log.txt``
    written (by rank 0), then the same command again resumes from it on
    both ranks (the requeue contract);
  * ``infer_narrator`` over two ranks spawned by ``--num-processes 2``
    alone: ``cache.{0,1}.pkl`` hold the sampler's round-robin shards and
    ``total.pkl`` their merge, the clips in dataset order with the
    records of a one-process run;
  * torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_*``) makes
    a group of one; a rank that fails stops the launcher with its code;
  * ``--mesh-data 4`` at a world of one raises ``ValueError``; the entry
    points are the JAX launcher's.

Every command runs under a timeout, its processes killed on failure.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lavila_tpu_torch.cli import launch
from lavila_tpu_torch.cli import main_infer_narrator as infer
from lavila_tpu_torch.cli import main_pretrain as cli
from lavila_tpu_torch.config import parse_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
ENV = {**{k: v for k, v in os.environ.items() if k not in (
    "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")},
       "OMP_NUM_THREADS": "1"}

PRETRAIN = ["pretrain", "--dataset", "synthetic",
            "--model", "CLIP_OPENAI_TIMESFORMER_MINI", "--steps", "2",
            "--batch-size", "8", "--epochs", "1", "--clip-length", "4",
            "--print-freq", "1", "--workers", "1", "--disable-amp",
            "--device", "cpu"]

# one rank: the launcher's main in this process, then the digest of the
# masters it returns
RANK = textwrap.dedent("""
    import hashlib, sys
    sys.path.insert(0, {repo!r})
    from lavila_tpu_torch.cli.launch import main
    state = main(["--coordinator", "localhost:{port}", "--num-processes",
                  "2", "--process-id", sys.argv[1], *{argv!r}])
    h = hashlib.sha256()
    for k, p in sorted(state.params.items()):
        h.update(p.detach().numpy().tobytes())
    print("PARAM_DIGEST", h.hexdigest(), flush=True)
""")


def run(cmds, env=ENV):
    """Run ``cmds`` (argument lists) together, each in a session of its
    own; their outputs and exit codes once every one ended, or kill them
    all, with the ranks a launcher started, at the timeout."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO, start_new_session=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs, [p.returncode for p in procs]


def two_ranks(out_dir):
    script = RANK.format(repo=REPO, port=launch.free_port(),
                         argv=[*PRETRAIN, "--output-dir", str(out_dir)])
    outs, codes = run([[sys.executable, "-c", script, str(i)]
                       for i in range(2)])
    for i, (out, code) in enumerate(zip(outs, codes)):
        assert code == 0, f"rank {i} exited {code}:\n{out[-4000:]}"
    digests = [line.split()[1] for out in outs for line in out.splitlines()
               if line.startswith("PARAM_DIGEST")]
    assert len(digests) == 2
    return outs, digests


def test_two_process_pretrain_and_requeue(tmp_path):
    out_dir = tmp_path / "run"
    outs, digests = two_ranks(out_dir)
    for r, out in enumerate(outs):
        assert f"=> process group: rank {r} / 2 (gloo)" in out, out[-2000:]
    # rank 1's print is silenced: only rank 0 shows the progress
    assert "=> done" in outs[0] and "=> done" not in outs[1]
    assert digests[0] == digests[1], digests
    files = {p.name for p in out_dir.iterdir()}
    assert files == {"checkpoint_0000.pt", "checkpoint_0000.pt.json",
                     "checkpoint_latest.pt", "checkpoint_latest.pt.json",
                     "log.txt"}, files
    meta = json.loads((out_dir / "checkpoint_latest.pt.json").read_text())
    assert meta["config"]["model"] == "CLIP_OPENAI_TIMESFORMER_MINI"
    assert meta["epoch"] == 0
    assert len((out_dir / "log.txt").read_text().splitlines()) == 1
    ckpt = torch.load(out_dir / "checkpoint_latest.pt", weights_only=True)
    assert ckpt["step"] == 2

    # requeue: the same command again; both ranks restore the checkpoint
    # and skip the finished epoch
    outs2, digests2 = two_ranks(out_dir)
    assert "resuming from" in outs2[0], outs2[0][-2000:]
    assert digests2[0] == digests2[1] == digests[0]


NARRATE = ["infer_narrator", "--dataset", "synthetic", "--max-samples", "5",
           "--batch-size", "2", "--num-return-sequences", "2",
           "--max-text-length", "10", "--top-k", "1", "--workers", "1",
           "--device", "cpu"]


def test_two_process_infer_narrator_merges_in_dataset_order(tmp_path):
    """5 clips over 2 ranks: rank 0 narrates clips 0, 2, 4, rank 1 clips
    1, 3 and clip 0 again (the sampler pads to a multiple of the ranks);
    ``total.pkl`` is their round-robin merge: clips 0-4 in dataset order,
    each with the captions and scores of a one-process run, then the
    repeat."""
    out = tmp_path / "two"
    outs, codes = run([[sys.executable, "-m", "lavila_tpu_torch.cli.launch",
                        "--num-processes", "2", *NARRATE,
                        "--output-dir", str(out)]])
    assert codes == [0], outs[0][-4000:]
    one = tmp_path / "one"
    want = infer.main(infer.get_args_parser().parse_args(
        [*NARRATE[1:], "--output-dir", str(one)]))
    assert len(want) == 5
    shards = [pickle.loads((out / f"cache.{r}.pkl").read_bytes())
              for r in range(2)]
    total = pickle.loads((out / "total.pkl").read_bytes())
    assert [len(s) for s in shards] == [3, 3] and len(total) == 6

    def same(got, w):
        assert got[:4] == w[:4]
        np.testing.assert_allclose(got[4], w[4], rtol=1e-4)

    for i, rec in enumerate(shards[0]):
        same(rec, want[2 * i])
    for i, rec in enumerate(shards[1]):
        same(rec, want[(2 * i + 1) % 5])
    for got, w in zip(total, [*want, want[0]]):
        same(got, w)
    assert total == infer.merge_shards(shards)


def test_merge_shards_is_round_robin():
    assert infer.merge_shards([[0, 2, 4], [1, 3]]) == [0, 1, 2, 3, 4]
    assert infer.merge_shards([["a"]]) == ["a"]
    assert infer.merge_shards([[], []]) == []


def test_torchrun_environment_makes_a_group(tmp_path):
    env = {**ENV, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(launch.free_port())}
    outs, codes = run([[sys.executable, "-m", "lavila_tpu_torch.cli.launch",
                        *PRETRAIN, "--steps", "1", "--batch-size", "2",
                        "--output-dir", str(tmp_path)]], env=env)
    assert codes == [0], outs[0][-4000:]
    assert "=> process group: rank 0 / 1 (gloo)" in outs[0]
    assert (tmp_path / "checkpoint_latest.pt").exists()


def test_a_failing_rank_stops_the_launcher(tmp_path):
    """A global batch of 3 does not split over 2 ranks: each rank raises,
    and the launcher returns the failure's exit code."""
    outs, codes = run([[sys.executable, "-m", "lavila_tpu_torch.cli.launch",
                        "--num-processes", "2", *PRETRAIN,
                        "--batch-size", "3", "--output-dir", str(tmp_path)]])
    assert codes[0] != 0
    assert "must be divisible by the 2 processes" in outs[0], outs[0][-3000:]


def test_mesh_data_must_be_the_world_size(tmp_path):
    cfg = parse_config(cli.TorchPretrainConfig, [
        *PRETRAIN[1:], "--mesh-data", "4", "--output-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--mesh-data 4 does not match the "
                                         "1 process"):
        cli.main(cfg)


def test_entry_points_are_the_jax_launchers():
    import ast
    src = open(os.path.join(REPO, "cli", "launch_tpu_pod.py")).read()
    tree = ast.parse(src)
    jax_points = next(ast.literal_eval(node.value) for node in tree.body
                      if isinstance(node, ast.Assign)
                      and node.targets[0].id == "ENTRY_POINTS")
    assert set(launch.ENTRY_POINTS) == set(jax_points)
    for name, module in launch.ENTRY_POINTS.items():
        assert module == "lavila_tpu_torch." + jax_points[name]
