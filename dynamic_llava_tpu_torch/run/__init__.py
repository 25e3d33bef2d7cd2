"""Harnesses of the port: the quality gates (own copies of the repo's
``run/`` harnesses, on the port)."""
