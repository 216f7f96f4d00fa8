"""Run utilities: checkpoints."""
