#!/usr/bin/env python3
"""Write a checkpoint that the JAX package's training wrote (an Orbax
directory, ``checkpoint_<tag>`` with its JSON sidecar) as a checkpoint of
the PyTorch port, which the port's CLIs then load as they load their
own:

    python scripts/export_jax_checkpoint.py RUN/checkpoint_latest \\
        --out exported
    # writes exported.pt and exported.pt.json
    python -m lavila_tpu_torch.cli.eval_zeroshot --checkpoint exported.pt
    python -m lavila_tpu_torch.cli.main_infer_narrator \\
        --model VCLM_... --checkpoint exported.pt

The checkpoint is read with ``lavila_tpu.utils.checkpoints.
CheckpointManager`` (a tag such as ``latest``, ``best`` or ``0003``
inside ``--run-dir``, or a path), whole: the restore's target is the
checkpoint's own tree of shapes and dtypes (Orbax's metadata), since
Orbax refuses a target that holds only ``params`` beside the saved
``opt_state`` (so the host needs memory for the optimizer's moments
too). The model's name comes from the sidecar's embedded run config.
``lavila_tpu_torch.models.convert.state_dict_from_jax`` maps the
``params`` to the port's names, for the dual encoders (CLIP or
DistilBERT text) and the VCLM narrators alike.

``<out>.pt`` holds ``{"state_dict": the fp32 weights, "step": None}``,
the layout of the port's own checkpoints (``utils/checkpoints.py``;
``convert.is_port_checkpoint`` tells it by its ``step`` key), and
``<out>.pt.json`` the JAX run's sidecar: its ``config``, ``epoch`` and
``metrics``, plus ``exported_from``. The optimizer state is not
exported: the port resumes only its own runs (``--resume`` and the
output directory's ``checkpoint_latest.pt``), so an exported file is for
evaluation, narration and ``--pretrain-model``, not for resuming.

This script imports both packages (the JAX one to read the checkpoint,
the port's weight bridge to name the weights); neither package imports
it. Run it where jax and orbax are installed, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

HERE = osp.dirname(osp.abspath(__file__))


def export(checkpoint: str, out: str, run_dir: str = "") -> tuple[str, str]:
    """Export ``checkpoint`` (a tag inside ``run_dir``, or a path) to
    ``out + ".pt"`` and its sidecar. Returns the two paths."""
    import jax
    import orbax.checkpoint as ocp
    import torch

    from lavila_tpu.utils.checkpoints import CheckpointManager
    from lavila_tpu_torch.models.convert import state_dict_from_jax

    mgr = CheckpointManager(run_dir or osp.dirname(checkpoint) or ".")
    path = (checkpoint if osp.isabs(checkpoint) or os.sep in checkpoint
            else osp.join(mgr.output_dir, f"checkpoint_{checkpoint}"))
    if not osp.exists(path + ".json"):
        raise FileNotFoundError(f"{path}.json: the checkpoint's sidecar, "
                                "whose config names the model, is missing")
    with open(path + ".json") as f:
        meta = json.load(f)
    if "model" not in meta.get("config", {}):
        raise ValueError(f"{path}.json: its config names no model")
    saved = ocp.StandardCheckpointer().metadata(path).item_metadata.tree
    target = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype),
                          saved)
    tree, _ = mgr.restore(target, tag=path)
    state_dict = state_dict_from_jax(jax.device_get(tree["params"]))
    pt = out + ".pt"
    os.makedirs(osp.dirname(osp.abspath(pt)), exist_ok=True)
    torch.save({"state_dict": state_dict, "step": None}, pt)
    with open(pt + ".json", "w") as f:
        json.dump({**meta, "exported_from": osp.abspath(path)}, f)
    return pt, pt + ".json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint",
                    help="an Orbax checkpoint directory, or a tag (latest, "
                         "best, 0003) inside --run-dir")
    ap.add_argument("--run-dir", default="",
                    help="the JAX run's --output-dir, for a bare tag")
    ap.add_argument("--out", required=True,
                    help="the exported file's path without .pt")
    args = ap.parse_args(argv)
    sys.path.insert(0, osp.dirname(HERE))
    pt, meta = export(args.checkpoint, args.out, args.run_dir)
    print(f"=> wrote {pt} and {meta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
