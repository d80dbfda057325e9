"""Model zoo of the port (the flagship only, so far)."""
