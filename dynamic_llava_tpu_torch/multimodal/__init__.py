"""Multimodal fusion of the port."""
