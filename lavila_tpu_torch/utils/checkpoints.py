"""Checkpoint manager: torch files, an embedded run config, auto-resume.

Counterpart of ``lavila_tpu/utils/checkpoints.py`` with the same contract
(reference distributed.py:61-73, main_pretrain.py:224-256, 394-403), with
torch files in place of orbax directories:

  * :meth:`CheckpointManager.save` writes ``checkpoint_{epoch:04d}.pt``
    and its JSON sidecar ``checkpoint_{epoch:04d}.pt.json`` (epoch,
    config, metrics), then ``checkpoint_latest.pt`` and, when asked,
    ``checkpoint_best.pt`` (hard links where the filesystem has them);
    ``keep_epoch=False`` drops the epoch copy, ``max_to_keep`` prunes old
    ones;
  * the run config rides in the sidecar, so a checkpoint alone rebuilds
    its model (``lavila_tpu_torch.cli.eval_zeroshot`` reads it);
  * :func:`resolve_resume`: a checkpoint in ``output_dir`` wins over
    ``--resume``;
  * in a process group (``parallel/mesh.py``) every rank calls
    :meth:`CheckpointManager.save`: rank 0 alone writes (the replicas are
    equal), then every rank waits at a barrier, so that no rank reads or
    requeues past a half-written file; every rank restores the same file.
    Under tensor parallelism the caller hands it the whole layout
    (``parallel.sharding.gather_train_state``: the model group's shards
    gathered), so that rank 0 of the world writes one file that serves
    and resumes at any ``--mesh-model``.

What a file holds is the caller's; the pretraining CLI saves
``TrainState.state_dict()``: ``{"state_dict", "optimizer", "scheduler",
"step"}``.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import re
import shutil
from typing import Any, Optional

import torch

from lavila_tpu_torch.parallel import mesh

_EPOCH_FILE = re.compile(r"^checkpoint_(\d{4})\.pt$")


def _link(src: str, dst: str) -> None:
    """``dst`` as a hard link to ``src`` (a copy where links fail)."""
    if osp.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


class CheckpointManager:
    def __init__(self, output_dir: str, max_to_keep: Optional[int] = None):
        self.output_dir = osp.abspath(output_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.output_dir, exist_ok=True)

    def path(self, tag) -> str:
        return osp.join(self.output_dir, f"checkpoint_{tag}.pt")

    def save(self, tree: Any, *, epoch: int, config: Optional[dict] = None,
             is_best: bool = False, metrics: Optional[dict] = None,
             keep_epoch: bool = True) -> str:
        """Write ``tree`` once, with ``torch.save``, as the epoch file
        plus its sidecar, and link 'latest' (and 'best') to it: rank 0
        writes, every rank waits for it. Returns the path of 'latest'."""
        if mesh.rank() == 0:
            self._write(tree, epoch, config, is_best, metrics, keep_epoch)
        mesh.barrier()
        return self.path("latest")

    def _write(self, tree, epoch, config, is_best, metrics,
               keep_epoch) -> None:
        meta = {"epoch": epoch, "config": config or {},
                "metrics": metrics or {}}
        primary = self.path(f"{epoch:04d}")
        tmp = primary + f".{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, primary)  # never a half-written checkpoint
        with open(primary + ".json", "w") as f:
            json.dump(meta, f)
        for tag in ["latest"] + (["best"] if is_best else []):
            _link(primary, self.path(tag))
            shutil.copyfile(primary + ".json", self.path(tag) + ".json")
        if not keep_epoch:
            os.remove(primary)
            os.remove(primary + ".json")
        self._prune()

    def _prune(self) -> None:
        """Keep only the newest ``max_to_keep`` epoch files ('latest' and
        'best' survive: their links keep the data)."""
        if not self.max_to_keep:
            return
        epochs = sorted(f for f in os.listdir(self.output_dir)
                        if _EPOCH_FILE.match(f))
        for f in epochs[:-self.max_to_keep]:
            for p in (f, f + ".json"):
                try:
                    os.remove(osp.join(self.output_dir, p))
                except FileNotFoundError:
                    pass

    def latest_path(self) -> Optional[str]:
        p = self.path("latest")
        return p if osp.exists(p) else None

    def restore(self, tag: str = "latest",
                map_location="cpu") -> tuple[Any, dict]:
        """Load a checkpoint; returns ``(tree, metadata)``. ``tag`` is a
        bare tag ('latest', 'best', an epoch such as '0003') resolved in
        ``output_dir``, or a path to a ``.pt`` file."""
        if osp.isabs(tag) or os.sep in tag or tag.endswith(".pt"):
            path = osp.abspath(tag)
        else:
            path = self.path(tag)
        tree = torch.load(path, map_location=map_location, weights_only=True)
        meta = {}
        if osp.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return tree, meta


def resolve_resume(output_dir: str, resume: Optional[str]) -> Optional[str]:
    """Auto-resume rule: a checkpoint in ``output_dir`` wins over
    ``--resume`` (reference main_pretrain.py:225-227)."""
    latest = osp.join(osp.abspath(output_dir), "checkpoint_latest.pt")
    if osp.exists(latest):
        return latest
    return resume
