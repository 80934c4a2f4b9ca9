"""PyTorch / CUDA port of deer_vla_tpu for NVIDIA Hopper.

The layout mirrors the JAX package (``core/``, ``ops/``, ``ops/kernels/``,
``models/``, ``data/``, ``eval/``, ``train/``, ``utils/``, ``cli/``).  This package imports torch and numpy only, never
JAX and never the JAX package.
"""
