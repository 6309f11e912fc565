"""Model configurations carried by the port (phi4-mini-3.8b so far)."""
