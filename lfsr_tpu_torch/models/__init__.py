"""Model zoo of the port: the flagship ``LFMambaX``, ``EPIT`` and ``LFT``."""
