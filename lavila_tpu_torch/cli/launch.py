"""Launch a port CLI data-parallel over several processes, one a GPU.

Counterpart of ``cli/launch_tpu_pod.py`` (the reference's submitit/SLURM
launchers) with its entry points and flags. Every process joins one
``torch.distributed`` group (``parallel/mesh.py``: NCCL for ``--device
cuda``, the rank's card ``cuda:{local_rank}``; gloo for ``--device cpu``),
prints only on rank 0 (``utils/logging.py``; ``print(..., force=True)``
on every rank) and runs the entry point, whose auto-resume contract (a
checkpoint in ``--output-dir`` wins) gives requeue on preemption: run the
same command again.

  * one host, N processes: ``--num-processes N`` alone spawns the N ranks
    here, at ``--coordinator`` (default a free port on localhost); a rank
    that fails stops the others;
  * several hosts: each process passes ``--coordinator host:port
    --num-processes N --process-id i`` (its card ``i`` modulo the host's
    cards);
  * torchrun: no flag; the group is read from ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:
    ``torchrun --nproc-per-node 8 -m lavila_tpu_torch.cli.launch pretrain
    ...``;
  * neither: the entry point runs as a world of one, as it does without
    the launcher.

    python -m lavila_tpu_torch.cli.launch --num-processes 2 pretrain \\
        --dataset synthetic --model CLIP_OPENAI_TIMESFORMER_MINI \\
        --batch-size 8 --steps 2 --device cpu --output-dir /tmp/run
"""

from __future__ import annotations

import argparse
import builtins
import importlib
import os
import socket
import subprocess
import sys
import time

from lavila_tpu_torch.parallel import mesh
from lavila_tpu_torch.utils.logging import setup_for_distributed

ENTRY_POINTS = {
    "pretrain": "lavila_tpu_torch.cli.main_pretrain",
    "finetune_retrieval": "lavila_tpu_torch.cli.main_finetune_retrieval",
    "finetune_classification":
        "lavila_tpu_torch.cli.main_finetune_classification",
    "infer_narrator": "lavila_tpu_torch.cli.main_infer_narrator",
    "eval_zeroshot": "lavila_tpu_torch.cli.eval_zeroshot",
    "eval_narrator": "lavila_tpu_torch.cli.eval_narrator",
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse_entry_args(entry: str, argv: list[str]):
    """The entry point's module and its arguments parsed from ``argv``."""
    mod = importlib.import_module(ENTRY_POINTS[entry])
    if hasattr(mod, "get_args_parser"):
        return mod, mod.get_args_parser().parse_args(argv)
    from lavila_tpu_torch.config import parse_config
    return mod, parse_config(mod.TorchPretrainConfig, argv)


def spawn(num_processes: int, coordinator: str, argv: list[str]) -> int:
    """Run ranks 0..N-1 of this command here, each a process of its own;
    wait for all of them, or stop the rest once one fails. Returns the
    first non-zero exit code, else 0."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lavila_tpu_torch.cli.launch",
         "--coordinator", coordinator, "--num-processes", str(num_processes),
         "--process-id", str(i), *argv]) for i in range(num_processes)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser("data-parallel launcher (PyTorch port)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (default: a free port on "
                             "localhost, for ranks spawned here)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("entry", choices=sorted(ENTRY_POINTS))
    args, rest = parser.parse_known_args(argv)

    n = args.num_processes
    if n is not None and n > 1 and args.process_id is None:
        coordinator = args.coordinator or f"localhost:{free_port()}"
        return spawn(n, coordinator, [args.entry, *rest])

    mod, sub_args = parse_entry_args(args.entry, rest)
    if n is not None:
        if n > 1 and not args.coordinator:
            raise SystemExit("--process-id needs --coordinator host:port")
        group = dict(init_method="tcp://" + (
            args.coordinator or f"localhost:{free_port()}"),
            world_size=n, rank=args.process_id or 0)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        group = dict(init_method="env://", rank=int(os.environ["RANK"]),
                     world_size=int(os.environ["WORLD_SIZE"]),
                     local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    else:
        return mod.main(sub_args)
    backend = mesh.backend_for(sub_args.device)
    mesh.init_process_group(backend, **group)
    base_print = setup_for_distributed(mesh.rank() == 0)
    print(f"=> process group: rank {mesh.rank()} / {mesh.world()} "
          f"({backend}), local rank {mesh.local_rank()}", force=True)
    try:
        return mod.main(sub_args)
    finally:
        mesh.destroy_process_group()
        builtins.print = base_print


if __name__ == "__main__":
    code = main()
    sys.exit(code if isinstance(code, int) else 0)
