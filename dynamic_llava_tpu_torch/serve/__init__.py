"""Serving entry points of the port (the chat CLI)."""
