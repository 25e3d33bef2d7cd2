"""Generation of the port."""
