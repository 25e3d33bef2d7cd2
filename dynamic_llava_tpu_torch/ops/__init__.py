"""Tensor ops of the port (norm, rope, attention, KV cache, sparsify)."""
