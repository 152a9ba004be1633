"""Degradation ladders — the next-known-good plan when the best one fails.

Port of ``repro/resil/degrade.py`` over the ported
``repro_torch.tuning.candidates``: the same rungs, and the same
``plan_key`` at each rung.

FFTW-style planner-in-production systems treat a degraded-but-correct
fallback as a first-class citizen: a searched schedule that stops
building, a measured plan that keeps producing non-finite output, or a
tuner that cannot build its winner must *degrade*, not take the service
down.  The ladder (most to least sophisticated):

    searched schedule   ->  fixed tuned (same decomp/opts, no schedule)
    packed r2c          ->  embed r2c (same decomp/opts)
    any fixed plan      ->  default decomposition, alltoall, K=1

Every rung computes the same transform (the transpose impls, K and the
r2c strategies agree on finite inputs), so walking down trades only
performance, never correctness; a degraded bucket's results equal the
direct fallback-plan transform bit for bit (``chip_smoke.py`` phase 7b).

All package imports are function-local so this module is importable
from anywhere (``repro_torch.core`` included) without import cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: rung names, best to worst ("primary" is whatever the tuner picked)
RUNGS = ("primary", "fixed", "embed", "default")


def bottom_candidate(shape, axis_sizes, problem: str = "c2c"):
    """The ladder's last rung: the mesh-rank default decomposition with
    the most conservative options — fused alltoall transposes, no
    overlap chunking (K=1), and the embed strategy for r2c (the packed
    pipeline is the thing being degraded away from).  None when even
    that is invalid for the shape."""
    from repro_torch.tuning.candidates import default_candidate
    cand = default_candidate(shape, axis_sizes, problem)
    if cand is None:
        return None
    opts = dataclasses.replace(cand.opts, transpose_impl="alltoall",
                               overlap_k=1, overlap_mode="pipelined",
                               local_impl="matmul")
    strategy = "embed" if cand.problem == "r2c" else None
    return dataclasses.replace(cand, opts=opts, strategy=strategy)


def next_rung(cand, shape, axis_sizes) -> Optional[tuple]:
    """One step down from candidate ``cand``: ``(rung_name, candidate)``,
    or None when ``cand`` already is the bottom rung."""
    from repro_torch.tuning.candidates import Candidate
    if cand is None:
        return None
    if getattr(cand, "is_schedule", False):
        # searched -> fixed: keep the data placement, drop the schedule
        fixed = Candidate(cand.decomp, cand.opts, problem=cand.problem,
                          strategy=getattr(cand, "strategy", None))
        return "fixed", fixed
    if cand.problem == "r2c" and getattr(cand, "strategy", None) == "packed":
        return "embed", dataclasses.replace(cand, strategy="embed")
    bottom = bottom_candidate(shape, axis_sizes, cand.problem)
    if bottom is None or bottom.plan_key == cand.plan_key:
        return None
    return "default", bottom


def ladder(plan) -> list:
    """Every rung strictly below ``plan``, best first, as
    ``(rung_name, candidate)`` pairs.  Meshless plans have no ladder
    (the single-device plan already is the only plan)."""
    if getattr(plan, "mesh", None) is None:
        return []
    axis_sizes = dict(plan.mesh.shape)
    out = []
    cand = plan.candidate()
    while True:
        step = next_rung(cand, plan.shape, axis_sizes)
        if step is None:
            return out
        out.append(step)
        cand = step[1]


def build_plan(plan, cand):
    """A fresh ``Croft3D`` serving ``plan``'s problem with candidate
    ``cand`` — the object a quarantine swaps in for the failed one."""
    from repro_torch.core.api import Croft3D
    return Croft3D(plan.shape, plan.mesh, cand.decomp, cand.opts,
                   dtype=plan.dtype, problem=plan.problem,
                   strategy=getattr(cand, "strategy", None),
                   schedule=cand if getattr(cand, "is_schedule", False)
                   else None)
