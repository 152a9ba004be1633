"""Deterministic synthetic tokens.

The counter-based hash of ``repro/train/data.py`` (``_splitmix64``,
``synth_tokens``), copied so that the port's prompts are the reference's
token for token.  The reference's dataset iterator and prefetcher serve
training and wait for that slice.
"""

from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def synth_tokens(seed: int, step: int, batch: int, seq_len: int,
                 vocab: int) -> np.ndarray:
    """(batch, seq_len) int32 tokens, deterministic in (seed, step)."""
    with np.errstate(over="ignore"):
        base = np.uint64(seed) * np.uint64(0x100000001B3) + np.uint64(step)
        idx = np.arange(batch * seq_len, dtype=np.uint64).reshape(batch, seq_len)
        h = _splitmix64(base + idx * np.uint64(0x9E3779B97F4A7C15))
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # Zipf-ish: token = floor(vocab^u) - 1 biases mass to small ids
    tok = np.floor(np.power(float(vocab), u)).astype(np.int64) - 1
    # second-order structure: every other token repeats its left neighbour
    # (hashed choice), giving the model learnable bigram statistics
    with np.errstate(over="ignore"):
        rep = (_splitmix64(h) & np.uint64(3)) == 0
    tok[:, 1:] = np.where(rep[:, 1:], tok[:, :-1], tok[:, 1:])
    return np.clip(tok, 0, vocab - 1).astype(np.int32)
