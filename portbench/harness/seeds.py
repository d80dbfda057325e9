"""Independent streams of randomness from one ``--seed``."""

from __future__ import annotations

import zlib

import numpy as np

STREAMS = ("weights", "scenes", "order", "train_pairs", "lf_pool", "check_sample", "draws")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream``, from ``seed`` (any whole number)."""
    if stream not in STREAMS:
        raise KeyError(stream)
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), zlib.crc32(stream.encode())])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))
