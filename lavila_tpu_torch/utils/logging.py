"""Master-only printing for several processes.

Counterpart of ``lavila_tpu/utils/logging.py`` (reference
lavila/utils/distributed.py:21-33): each rank would otherwise print the
same progress lines."""

from __future__ import annotations

import builtins

from lavila_tpu_torch.parallel import mesh


def setup_for_distributed(is_master: bool, force_token: str = "force"):
    """Silence ``print()`` on the ranks other than the master;
    ``print(..., force=True)`` still prints everywhere. Returns the
    original ``print``."""
    base_print = builtins.print

    def gated(*args, **kwargs):
        force = kwargs.pop(force_token, False)
        if is_master or force:
            base_print(*args, **kwargs)

    builtins.print = gated
    return base_print


def is_main_process() -> bool:
    return mesh.rank() == 0
