"""The framework's frozen configuration, shared with the JAX package.

``lfsr_tpu.config`` is plain Python (no jax), so the port uses the same
``Config`` value type; import it from here.
"""

from lfsr_tpu.config import Config

__all__ = ["Config"]
