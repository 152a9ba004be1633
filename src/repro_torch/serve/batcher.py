"""Continuous batcher: bucket requests by transform, pad to size buckets.

Port of ``repro/serve/batcher.py``, a copy of that host-only module (the
port imports nothing of ``repro``): given the same adds and the same
clock, it makes the same decisions.

Batching policy (the vLLM-style continuous-batching loop, specialized to
transforms where every request in a bucket is the *same* computation):

  * requests are grouped by :func:`repro_torch.serve.request.bucket_key`
    — same plan and transform, so stacking is free at the collective
    level (a (B, ...) stack runs the SAME per-stage collective count as
    B=1, ``Croft3D.forward_batched``);
  * a bucket dispatches when it reaches ``max_batch`` or when its oldest
    request has waited ``max_wait_s`` (latency bound under low load);
  * the stacked batch is zero-padded up to the next power of two
    (:func:`padded_size`), so each bucket runs at most
    ``log2(max_batch) + 1`` distinct batch shapes (the reference compiles
    one executable per shape; the port keeps the same sizes, so both
    packages carry the same padding).  Padding rows are dead weight
    the collectives carry; occupancy (real / padded) is the efficiency
    metric ``stats()`` reports.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.request import PRIORITY_NORMAL, TransformRequest


def _priority(item) -> int:
    """Priority of a pending item (the service queues ``_Pending``
    wrappers; bare ``TransformRequest``s work too for direct users)."""
    return getattr(getattr(item, "req", item), "priority", PRIORITY_NORMAL)


def _req_id(item) -> int:
    return getattr(getattr(item, "req", item), "req_id", 0)


def padded_size(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at ``max_batch`` (n <= max_batch)."""
    if n < 1:
        raise ValueError("empty batch")
    if n > max_batch:
        raise ValueError(f"batch of {n} exceeds max_batch={max_batch}")
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


def stack_and_pad(arrays: Sequence[np.ndarray], pad_to: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stack host payloads into a (pad_to, ...) batch, zero rows beyond
    ``len(arrays)`` (zeros transform to zeros — dead but harmless).
    ``out``, a preallocated (pad_to, ...) array, takes the stack in its
    own dtype (the service passes a pinned host buffer)."""
    if out is None:
        out = np.zeros((pad_to,) + tuple(arrays[0].shape), arrays[0].dtype)
    else:
        out[len(arrays):] = 0
    for i, a in enumerate(arrays):
        out[i] = a
    return out


@dataclasses.dataclass
class Bucket:
    """Pending same-transform requests awaiting dispatch."""

    key: str
    requests: list = dataclasses.field(default_factory=list)
    t_oldest: float = 0.0
    #: why this bucket dispatched: "full" | "deadline" | "drain"
    #: (set by the pop that releases it; span/metric attribution)
    reason: str = ""

    def add(self, req: TransformRequest, now: float) -> None:
        if not self.requests:
            self.t_oldest = now
        self.requests.append(req)

    def __len__(self) -> int:
        return len(self.requests)


class Batcher:
    """Accumulates requests into per-transform buckets and decides when
    each dispatches.  Not thread-safe by itself — the service's single
    worker thread owns it."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.002):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._buckets: dict[str, Bucket] = {}

    def add(self, key: str, req: TransformRequest,
            now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = Bucket(key)
        bucket.add(req, now)

    def pop_ready(self, now: Optional[float] = None) -> list[Bucket]:
        """Buckets due for dispatch: full, or oldest request past the
        wait budget.  Popped buckets leave the pending set."""
        now = time.monotonic() if now is None else now
        ready = []
        for b in self._buckets.values():
            if len(b) >= self.max_batch:
                b.reason = "full"
                ready.append(b)
            elif (now - b.t_oldest) >= self.max_wait_s:
                b.reason = "deadline"
                ready.append(b)
        for b in ready:
            del self._buckets[b.key]
        # high-priority buckets dispatch first when several are ready at
        # once (a bucket's priority is its most important request's)
        ready.sort(key=lambda b: min(_priority(r) for r in b.requests))
        return ready

    def shed_lowest(self):
        """Remove and return the least-important pending item: highest
        priority value first, newest arrival (largest req_id) within a
        class — so bounded-queue load shedding evicts the requests whose
        SLO matters least and keeps the oldest of equals (closest to
        dispatch).  None when nothing is pending."""
        worst_b, worst_i, worst_key = None, None, None
        for b in self._buckets.values():
            for i, item in enumerate(b.requests):
                key = (_priority(item), _req_id(item))
                if worst_key is None or key > worst_key:
                    worst_b, worst_i, worst_key = b, i, key
        if worst_b is None:
            return None
        item = worst_b.requests.pop(worst_i)
        if not worst_b.requests:
            del self._buckets[worst_b.key]
        return item

    def pop_all(self) -> list[Bucket]:
        """Drain every pending bucket (shutdown path)."""
        out = list(self._buckets.values())
        for b in out:
            b.reason = "drain"
        self._buckets.clear()
        return out

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest wait-budget expiry (None = empty);
        the worker uses it as its queue-poll timeout so dispatch never
        oversleeps a latency bound."""
        if not self._buckets:
            return None
        now = time.monotonic() if now is None else now
        expiry = min(b.t_oldest + self.max_wait_s
                     for b in self._buckets.values())
        return max(0.0, expiry - now)

    @property
    def pending(self) -> int:
        # list() snapshots the dict atomically (single C call under the
        # GIL) so stats() can read this while the worker adds buckets
        return sum(len(b) for b in list(self._buckets.values()))
