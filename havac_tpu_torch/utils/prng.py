"""Counter-based, position-keyed PRNG for deterministic ambiguity-code resolution.

The reference resolves IUPAC ambiguity codes with C `rand()`
(`host/sequence/SequencePreprocessor.cpp:62-85`), which makes hit lists
non-deterministic run-to-run and inconsistent across shards. We instead key a
stateless hash on (seed, absolute sequence position) so every shard — and every
rerun — agrees on the resolved symbol (SURVEY.md §7 hard part (f))."""

from __future__ import annotations

import numpy as np

_PHI64 = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def hash_u64(values: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64 finalizer over `values` (uint64 array), mixed with `seed`.

    Returns uint64 array of well-mixed bits; cheap, vectorized, stateless.
    """
    with np.errstate(over="ignore"):
        z = values.astype(np.uint64) + np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _PHI64
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        z = z ^ (z >> np.uint64(31))
    return z


def random_bits_at_positions(positions: np.ndarray, seed: int, nbits: int) -> np.ndarray:
    """`nbits` (1 or 2) low random bits for each absolute position. uint8 output."""
    h = hash_u64(np.asarray(positions, dtype=np.uint64), seed)
    mask = np.uint64((1 << nbits) - 1)
    return (h & mask).astype(np.uint8)
