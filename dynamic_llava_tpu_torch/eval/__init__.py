"""Evaluation entry points and scorers of the port (own copies of the JAX package's)."""
