"""The benchmark of ``lavila_tpu_torch`` on NVIDIA H100 cards (see
``benchmark/README.md``)."""
