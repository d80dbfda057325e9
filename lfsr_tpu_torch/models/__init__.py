"""Model zoo of the port: the flagship ``LFMambaX``, ``EPIT``, ``LFT`` and ``LF_DET``."""
