"""The planner: candidate search + wisdom, orchestrated FFTW-style.

Port of ``repro/tuning/planner.py``.  With a mesh, every rank runs
``tune()`` on the same arguments: the ranking is pure arithmetic, the
race decides on times every rank shares (``measure.measure_candidate``
returns the slowest rank's), so every rank returns the same winner; only
the mesh's rank 0 writes wisdom, between two barriers, so that a later
``mode="wisdom"`` on any rank reads what it wrote.

``tune()`` is the single entry point.  Modes map onto FFTW's planner
rigor levels:

  mode="wisdom"   use a stored plan if one matches; otherwise fall back
                  to "model" and remember the result.
  mode="model"    FFTW ESTIMATE — rank every valid candidate with the
                  analytic cost model, return the cheapest.  Zero
                  execution; works with no devices (pass axis_sizes).
  mode="measure"  FFTW PATIENT — model-rank, then build and wall-clock
                  the top-k (plus the untuned default, so the tuned plan
                  is never slower than what the caller would have picked
                  by hand) and return the fastest measured.

The result carries the full ranked report for inspection and is written
into the wisdom store when a path is given.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import tracer as tracer_lib
from repro_torch.tuning import candidates as cand_lib
from repro_torch.tuning import cost_model, measure, wisdom as wisdom_lib

MODES = ("wisdom", "model", "measure")


@dataclasses.dataclass
class TuneResult:
    """Chosen plan + provenance."""

    decomp: Decomposition
    opts: FFTOptions
    source: str                 # "wisdom" | "model" | "measure"
    key: str
    ranked: list                # [{label, model_s, measured_s?}, ...]
    model_s: Optional[float] = None
    measured_s: Optional[float] = None
    wisdom_path: Optional[str] = None
    problem: str = "c2c"
    strategy: Optional[str] = None  # r2c: "packed" | "embed"
    # set when the winner came out of the schedule search (search=
    # "schedule") and is not expressible as a fixed (decomp, opts) pair;
    # pass it to Croft3D(schedule=...) — decomp/opts above then only
    # describe the data placement, not the pipeline
    schedule: Optional[object] = None

    def candidate(self):
        """The winning plan (the searched schedule when there is one)."""
        return self.schedule or cand_lib.Candidate(
            self.decomp, self.opts, problem=self.problem,
            strategy=self.strategy)

    def summary(self) -> str:
        best = self.candidate()
        t = (f"{self.measured_s * 1e6:.0f}us measured"
             if self.measured_s is not None else
             f"{self.model_s * 1e6:.0f}us modeled"
             if self.model_s is not None else "from wisdom")
        return f"[{self.source}] {best.label} ({t})"


def _resolve_axis_sizes(mesh, axis_sizes) -> Mapping[str, int]:
    if axis_sizes is not None:
        return dict(axis_sizes)
    if mesh is not None:
        return dict(mesh.shape)
    raise ValueError("tune() needs a mesh or an axis_sizes mapping")


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _distributed(mesh) -> bool:
    return (mesh is not None and dist.is_initialized()
            and dist.get_world_size() > 1)


def _persist(mesh, path: str, entries: dict) -> None:
    """Merge ``entries`` into the wisdom file: rank 0 writes, between two
    barriers (every rank has loaded the file before it changes, and has
    it back before any rank reads it again)."""
    if not _distributed(mesh):
        wisdom_lib.merge_entries(path, entries)
        return
    dist.barrier()
    if dist.get_rank() == 0:
        wisdom_lib.merge_entries(path, entries)
    dist.barrier()


def tune(shape: Sequence[int], mesh=None, *,
         axis_sizes: Optional[Mapping[str, int]] = None,
         mode: str = "model", dtype=torch.complex64, top_k: int = 4,
         wisdom_path: Optional[str] = None, include_baselines: bool = False,
         heterogeneous_impls: bool = False, problem: str = "c2c",
         batch: int = 1, measure_iters: int = 5, measure_warmup: int = 2,
         save: bool = True, search: str = "options") -> TuneResult:
    """Pick (Decomposition, FFTOptions) for a 3-D FFT problem.

    ``mode="measure"`` requires a live ``mesh``; the other modes accept a
    bare ``axis_sizes`` mapping ({axis_name: size}) and never touch
    devices or a process group.  With a mesh every rank calls it.

    ``problem="r2c"`` plans the real transform: the search space gains
    the packed/embed strategy axis (see ``repro_torch.real``), the wisdom key
    a problem dimension, and measurement runs real-input plans.
    ``heterogeneous_impls`` widens the search with per-stage
    ``local_impl`` 3-tuples.

    ``batch`` plans for B stacked fields: the cost model scales volume
    terms (not collective launch counts) by B, the wisdom key gains a
    ``|b{B}`` dimension (``batch=1`` keeps the legacy key format, so old
    wisdom files still hit), and ``mode="measure"`` times
    ``forward_batched`` over B stacked fields — the same thing the caller
    will run.

    ``search="schedule"`` widens the pool past (decomp, opts) knob tuples:
    the enumerator in :mod:`repro_torch.tuning.candidates` generates candidate
    *pipelines* directly — alternative transpose orders, per-stage
    transpose impls and per-stage K — pruned by symbolic layout
    propagation.  c2c / c2c_grad only; the winner (when it is not a plan
    a fixed builder could have produced) rides back on
    ``TuneResult.schedule``.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if search not in ("options", "schedule"):
        raise ValueError(f'search must be "options" or "schedule", '
                         f'got {search!r}')
    if search == "schedule" and cand_lib.split_grad(problem)[0] != "c2c":
        raise ValueError('search="schedule" covers c2c/c2c_grad only — '
                         'r2c packing stages are not in the enumerator')
    if mode == "measure" and mesh is None:
        raise ValueError('mode="measure" needs a live mesh to time on')
    sizes = _resolve_axis_sizes(mesh, axis_sizes)
    dtype = _torch_dtype(dtype)
    backend = wisdom_lib.backend_of(mesh)
    key = wisdom_lib.wisdom_key(shape, sizes, dtype, backend, problem, batch)
    wis = wisdom_lib.Wisdom.load(wisdom_path)

    if mode == "wisdom":
        # fall back to device-less wisdom (backend "any", written by
        # meshless mode="model" tunes) when no backend-exact entry exists
        hit = wis.lookup(key) or wis.lookup(
            wisdom_lib.wisdom_key(shape, sizes, dtype, "any", problem,
                                  batch))
        if hit is not None:
            try:
                cand = hit.candidate()
            except (TypeError, ValueError):
                cand = None  # corrupt entry values -> miss, re-estimate
        if hit is not None and cand is not None:
            return TuneResult(
                decomp=cand.decomp, opts=cand.opts, source="wisdom", key=key,
                ranked=[{"label": cand.label, "model_s": hit.model_s,
                         "measured_s": hit.measured_s}],
                model_s=hit.model_s, measured_s=hit.measured_s,
                wisdom_path=wis.path, problem=cand.problem,
                strategy=cand.strategy,
                schedule=cand if getattr(cand, "is_schedule", False)
                else None)
        mode = "model"  # miss: estimate now, remember below

    cands = cand_lib.enumerate_candidates(
        shape, sizes, include_baselines=include_baselines,
        heterogeneous_impls=heterogeneous_impls, problem=problem)
    if search == "schedule":
        cands = list(cands) + list(cand_lib.enumerate_schedule_candidates(
            shape, sizes, problem=problem))
    # distinct spec tuples can serialize to the same plan token (a
    # homogeneous per-stage override is the same pipeline as the scalar
    # knob) — collapse them so nothing gets costed or measured twice
    cands = cand_lib.dedupe_candidates(cands)
    if not cands:
        raise ValueError(
            f"no valid decomposition for shape={tuple(shape)} over mesh "
            f"axes {dict(sizes)} — check divisibility")
    with tracer_lib.get_tracer().span("tune:rank", "plan", key=key,
                                      n_candidates=len(cands)):
        scored = cost_model.rank_candidates(shape, cands, sizes, dtype,
                                            batch)
    ranked = [{"label": c.label, "model_s": b.total_s,
               "cost": b.to_dict()} for c, b in scored]

    if mode == "model":
        best, bcost = scored[0]
        entry = wisdom_lib.WisdomEntry.from_candidate(
            best, "model", model_s=bcost.total_s)
        result = TuneResult(decomp=best.decomp, opts=best.opts,
                            source="model", key=key, ranked=ranked,
                            model_s=bcost.total_s, wisdom_path=wis.path,
                            problem=best.problem,
                            strategy=getattr(best, "strategy", None),
                            schedule=best if getattr(best, "is_schedule",
                                                     False) else None)
    else:  # measure
        pool = [c for c, _ in scored[:max(1, top_k)]]
        default = cand_lib.default_candidate(shape, sizes, problem=problem)
        if default is not None and default not in pool:
            pool.append(default)
        model_by_cand = {c: b.total_s for c, b in scored}
        raced = []
        with tracer_lib.get_tracer().span("tune:measure", "plan", key=key,
                                          n_pool=len(pool)):
            for c in pool:
                t = measure.measure_candidate(
                    shape, mesh, c, dtype, warmup=measure_warmup,
                    iters=measure_iters, batch=batch)
                if t is not None:
                    raced.append((c, t))
        metrics_lib.get_registry().counter(
            "tune_measured_candidates").inc(len(raced))
        if not raced:
            raise RuntimeError("every measured candidate failed to build "
                               "or run")
        # the times are the slowest rank's, the same on every rank, and
        # the pool's order is too: every rank picks the same winner
        raced.sort(key=lambda ct: ct[1])
        best, best_t = raced[0]
        measured = {c.label: t for c, t in raced}
        for row in ranked:
            if row["label"] in measured:
                row["measured_s"] = measured[row["label"]]
        for c, t in raced:  # default candidate may not be in ranked top list
            if not any(r["label"] == c.label for r in ranked):
                ranked.append({"label": c.label, "measured_s": t})
        entry = wisdom_lib.WisdomEntry.from_candidate(
            best, "measure", model_s=model_by_cand.get(best),
            measured_s=best_t)
        if save and wis.path:
            # collective stats ride along in persisted wisdom only —
            # counting them costs one more forward of the winner on every
            # rank (Croft3D plans the base problem; grad-ness only changed
            # the ranking)
            from repro_torch.core.api import Croft3D
            entry.hlo = cost_model.counted_collectives(
                Croft3D(tuple(shape), mesh, best.decomp, best.opts,
                        dtype=dtype,
                        problem=cand_lib.split_grad(best.problem)[0],
                        strategy=getattr(best, "strategy", None),
                        schedule=best if getattr(best, "is_schedule",
                                                 False) else None))
        result = TuneResult(decomp=best.decomp, opts=best.opts,
                            source="measure", key=key, ranked=ranked,
                            model_s=model_by_cand.get(best),
                            measured_s=best_t, wisdom_path=wis.path,
                            problem=best.problem,
                            strategy=getattr(best, "strategy", None),
                            schedule=best if getattr(best, "is_schedule",
                                                     False) else None)

    wis.record(key, entry)
    if save and wis.path:
        # reload-merge-rename under a lock: concurrent tuners fold entries
        # together instead of clobbering each other's writes
        _persist(mesh, wis.path, {key: entry})
    return result


def upgrade_wisdom(shape, mesh, *, dtype=torch.complex64, problem: str = "c2c",
                   batch: int = 1, wisdom_path: Optional[str] = None,
                   **tune_kw) -> TuneResult:
    """FFTW's planner-in-production upgrade hook: re-plan one problem in
    ``mode="measure"`` and merge the winner into the wisdom store.

    This is what a serving plan cache's background thread calls once a
    key turns hot: the cold request paid only ``mode="model"``; this pays
    the build-and-time cost off the request path and persists the
    measured plan (atomically, via
    :func:`repro_torch.tuning.wisdom.merge_entries`) so every later
    process starts warm.
    """
    return tune(shape, mesh, mode="measure", dtype=dtype, problem=problem,
                batch=batch, wisdom_path=wisdom_path, **tune_kw)
