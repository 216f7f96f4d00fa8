"""Experiment tracking for the training CLIs' ``--wandb``."""

from __future__ import annotations


def init_wandb(config: dict):
    """A Weights & Biases run of project ``lavila_tpu`` with ``config``,
    or None, the reason printed, where wandb cannot be imported or
    started (an offline machine): training goes on without it."""
    try:
        import wandb
        return wandb.init(project="lavila_tpu", config=config)
    except Exception as e:  # noqa: BLE001  (any failure: train on)
        print(f"(wandb unavailable: {e})")
        return None
