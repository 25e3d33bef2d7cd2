"""Configuration, shared with the JAX package (its ``config`` and
``constants`` modules are plain Python and do not load jax)."""

from dynamic_llava_tpu.config import (  # noqa: F401
    DENSE_SPARSE_CONFIG,
    ClipVisionConfig,
    LlamaConfig,
    LlavaConfig,
    RopeScalingConfig,
    SparseConfig,
)
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: F401
