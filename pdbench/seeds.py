"""Seeds of the parts of a run, derived from `--seed`: one number for each
tag tuple, the same on every machine (SHA-256, not Python's salted hash)."""

from __future__ import annotations

import hashlib

import numpy as np


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for `tags` under the run's `seed` (any whole number)."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    """A host generator for choices drawn from the seed (which request and
    which steps the check compares)."""
    return np.random.default_rng(sub_seed(seed, *tags))
