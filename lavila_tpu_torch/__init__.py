"""lavila_tpu_torch: the PyTorch + CUDA port of lavila_tpu for NVIDIA Hopper.

Beside the JAX package ``lavila_tpu``, which stays the reference, with the
same layout:

  * kernels/ — Python wrappers of the hand-written Hopper kernels, each
               beside its plain PyTorch version and a launch counter;
               ``kernels/build.py`` compiles ``csrc/*.cu`` with nvcc.
  * csrc/    — CUDA C++ sources (sm_90a).
  * ops/     — LayerNorm, QuickGELU, MLP and the attention primitives.
  * models/  — TimeSformer video tower, CLIP text tower, the VideoCLIP
               dual encoder, the model zoo and the weight bridge.
  * losses.py — the contrastive loss.
  * train/   — AdamW, the LR schedule and the dual-encoder train step.
  * parallel/ — data parallelism over processes: the process group, the
               differentiable all-gather, the gradients' average.
  * utils/   — checkpoints, meters, seeding, master-only printing.
  * data/, eval/, config.py — copies of the framework-free data, metric
               and config modules of ``lavila_tpu`` (imports rewritten;
               ``utils/meters.py`` syncs through ``torch.distributed``).
  * cli/     — entry points (zero-shot evaluation, pretraining, narrator
               inference and demo) and their data-parallel launcher.

It imports ``torch`` and never jax, flax, optax or orbax, and no module
of ``lavila_tpu``.
"""

__version__ = "0.1.0"
