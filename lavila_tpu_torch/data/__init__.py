"""Data pipeline: framework-free copies of ``lavila_tpu/data``."""
