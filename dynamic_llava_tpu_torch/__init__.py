"""PyTorch + CUDA port of ``dynamic_llava_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops``, ``models``,
``multimodal``, ``generation``); the hand-written CUDA kernels live in
``csrc/`` and are built at first use by ``kernels``. This package imports
torch and never jax: from ``dynamic_llava_tpu`` it uses only the modules
whose import does not load jax (``config``, ``constants`` and the numpy
planner ``multimodal.fusion``).
"""
