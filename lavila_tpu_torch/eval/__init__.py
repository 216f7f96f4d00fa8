"""Evaluation metrics: a copy of ``lavila_tpu/eval/metrics.py``."""
