"""Model configurations carried by the port (phi4-mini-3.8b and
falcon-mamba-7b so far)."""
