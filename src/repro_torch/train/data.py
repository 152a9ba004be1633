"""Deterministic synthetic data pipeline.

Port of ``repro/train/data.py``.  Tokens come from a counter-based hash
of (seed, step, position) (``_splitmix64``, ``synth_tokens``, copied so
that the port's batches are the reference's token for token): no stored
state, so any host can regenerate any step, and restarts replay
identically.  The distribution is Zipf-ish over the vocab with a
second-order blend, so models have something to learn.

``SyntheticDataset`` yields, with ``sharding``, this rank's block of the
same global batch (the reference's ``NamedSharding`` per key becomes a
per-rank tuple of slices per key, ``batch_sharding``), and puts each
batch on ``device``: from pinned host memory by a non-blocking copy when
the device is a CUDA card.  ``Prefetcher`` keeps ``depth`` batches in flight
on a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


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


def batch_sharding(shard, global_batch: int, keys) -> dict:
    """{key: this rank's slices} of a ``global_batch``-row batch under a
    ``models.model.ShardCtx`` (its batch block over ``dp``; every row
    when ``dp`` is None)."""
    from repro_torch.models.model import batch_rows
    rows = batch_rows(shard, global_batch)
    return {k: (rows,) for k in keys}


class SyntheticDataset:
    """Iterator of train batches: {"tokens" (B, S+1) int32, and each
    ``extra`` name's (B, *shape) array drawn from
    ``np.random.default_rng(seed * 1_000_003 + step)``}.  Numpy arrays, or
    tensors on ``device`` when one is given.  ``sharding``: {key: tuple of
    slices} (:func:`batch_sharding`); each array of a key it names is cut
    to the slices after the whole global batch is drawn, so every rank
    gets its block of the same batch."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, device=None, start_step: int = 0,
                 extra: Optional[dict] = None, sharding=None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        self.step = start_step
        self.extra = extra or {}
        self.sharding = sharding or {}

    def batch_at(self, step: int) -> dict:
        tokens = synth_tokens(self.seed, step, self.global_batch,
                              self.seq_len + 1, self.vocab)
        batch = {"tokens": tokens}
        for name, (shape, dtype) in self.extra.items():
            rng = np.random.default_rng(self.seed * 1_000_003 + step)
            batch[name] = rng.standard_normal(
                (self.global_batch, *shape)).astype(dtype)
        batch = {k: np.ascontiguousarray(v[self.sharding[k]])
                 if self.sharding.get(k) is not None else v
                 for k, v in batch.items()}
        if self.device is not None:
            batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    """Background-thread prefetch (the pipeline's memory-I/O overlap, in
    the spirit of the paper's comm/compute overlap, at the input layer)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
