"""The benchmark's plain reference: LaViLa's models written out in plain
PyTorch from their published equations, over a dict of parameters named
as the port names them, with no kernel, cache or batching trick.

It imports nothing of ``lavila_tpu_torch`` (nor ``jax`` or
``lavila_tpu``): it takes its sizes from the configuration files and its
weights and inputs from the benchmark, never from the program, so a
fault in the program cannot also be a fault here. Every product runs in
float32 with TF32 off, or, as the lower-precision control, with each
matrix product's operands rounded to fp8 (``numerics.Numerics``).
"""
