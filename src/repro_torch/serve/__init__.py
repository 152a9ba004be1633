"""repro_torch.serve — plan-cached, continuously batched spectral
transforms (port of ``repro.serve``).

Heterogeneous transform requests (shape x dtype x {c2c, r2c, filtered} x
direction) arrive on a queue, are bucketed by plan and transform,
stacked into the batched pipelines — a (B, ...) stack runs the SAME
per-stage collective count as B=1 (``Croft3D.forward_batched``) — and
dispatched on the card, or with a mesh as an SPMD service over the
``torch.distributed`` ranks (rank 0 takes the requests and sends every
dispatch to the others; see :mod:`repro_torch.serve.service`).

Plan selection is FFTW's planner-in-production: the first request of a
problem key pays only ``mode="wisdom"``/``"model"`` (zero execution),
hot keys are upgraded with ``mode="measure"`` and the winner merged into
the wisdom store atomically, and an LRU cap with ``Croft3D.release()``
keeps the plan set bounded under shape diversity.

    from repro_torch.serve import TransformService
    with TransformService(max_batch=8) as svc:          # on the card
        spectrum = svc.transform(field, problem="r2c")
"""

from repro_torch.serve.batcher import (Batcher, Bucket, padded_size,
                                       stack_and_pad)
from repro_torch.serve.plan_cache import CachedPlan, CacheStats, PlanCache
from repro_torch.serve.request import (DIRECTIONS, PRIORITIES, PRIORITY_HIGH,
                                       PRIORITY_LOW, PRIORITY_NORMAL,
                                       PROBLEMS, ShedResult,
                                       TransformRequest, TransformResult,
                                       bucket_key)
from repro_torch.serve.service import TransformService

__all__ = [
    "Batcher", "Bucket", "CacheStats", "CachedPlan", "DIRECTIONS",
    "PRIORITIES", "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL",
    "PROBLEMS", "PlanCache", "ShedResult", "TransformRequest",
    "TransformResult", "TransformService", "bucket_key", "padded_size",
    "stack_and_pad",
]
