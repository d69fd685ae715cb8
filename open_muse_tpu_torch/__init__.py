"""PyTorch + CUDA port of open_muse_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (core, ops, models, pipelines) and imports
neither jax nor flax.  The hand-written kernels live in ``kernels/`` with
their CUDA sources in ``csrc/``; each has a plain PyTorch version that the
CPU path uses.
"""
