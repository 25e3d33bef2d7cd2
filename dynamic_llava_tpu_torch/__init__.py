"""PyTorch + CUDA port of ``dynamic_llava_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops``, ``models``,
``multimodal``, ``generation``, ``train``); the hand-written CUDA kernels
live in ``csrc/`` and are built at first use by ``kernels``. This package
imports torch, never jax, and nothing of ``dynamic_llava_tpu``: it keeps
its own copies of the framework-free host code it needs (``config``,
``constants`` and the numpy planner in ``multimodal.fusion``).
"""
