"""Analytic candidate scoring — the planner's FFTW-``ESTIMATE`` leg.

Port of ``repro/tuning/cost_model.py``: the same walk over the same
schedule, priced against the card's constants (``launch/roofline.py``
and the priors below).  Every priced number is a function of those
module constants only, so the reference's constants patched in give the
reference's numbers.

Scores a :class:`~repro_torch.tuning.candidates.Candidate` in modeled
seconds with zero execution.  The model does not re-derive pipeline
structure from ``Decomposition.kind``: it builds the candidate's
*actual* :class:`repro_torch.core.schedule.Schedule` (the same object
the executor runs) and walks it —

  compute     5 n log2 n FLOPs per local FFT event, at the block size the
              schedule's symbolic layout reports for that stage, over the
              card's float32 peak (complex64 work runs in FP32) scaled by
              a per-``local_impl`` efficiency prior
  memory      ~10 local HBM passes over the per-device input block
  collective  per-stage transpose bytes (the layout at each stage's
              all_to_all, so the packed pipeline's half-volume stages and
              its out-of-body z-localizing reshard are charged at their
              true sizes) / link bandwidth
  latency     a per-collective launch cost using each stage's *effective*
              K (the executor's chunk-indivisible fallback is modeled,
              and out-of-body reshards count as one fused all-to-all);
              the alpha/beta split per transpose impl: "alltoall" pays
              one alpha per (chunk, stage) and its beta overlaps only
              when K >= 2 chunks exist to pipeline; "ring" pays P-1
              alphas per chunk plus one fused pack/unpack HBM pass each
              side, but its beta is overlapped with FFT compute even at
              K=1 (the rounds are independent of each other and of the
              neighbouring chunks' FFTs — the executor's explicit
              pipeline); "pairwise" pays P-1 alphas AND a serial
              placement chain (P-1 full-size output rewrites, never
              overlapped) — the FFTW3 baseline of figs 12-15

K-chunked overlap (the paper's core mechanism) combines compute and
collective with ``max(...)`` instead of ``+`` (§5.1 options 3/4), and
``plan_cache=False`` pays the twiddle re-materialization the paper's
options 1/3 measure.  The embedding r2c strategy additionally pays the
guarded half-slice reshard in the natural layout
(``core.rfft._guarded_half_slice``).

``batch`` models batched transforms (B stacked fields): volume terms
scale by B while collective launch counts do not — the executor carries
the batch axis through the same collectives — which is exactly what makes deeper
plans win at batch and why the wisdom key carries a ``|b{B}`` dimension.

:func:`counted_collectives` takes the place of the reference's
``hlo_collectives``: the port has no HLO, so it runs one forward of a
zero input under the mesh's collective counter (``Mesh.counting``) and
returns the *actual* collective op count/bytes.  Unlike the reference it
executes, collectively on every rank of the plan's mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.distributed import build_schedule
from repro_torch.core.schedule import Schedule
from repro_torch.launch import roofline
from repro_torch.launch.roofline import HBM_BW, LINK_BW
from repro_torch.tuning.candidates import Candidate

#: the compute term's peak: complex64 FFT work runs in float32
PEAK_FLOPS = roofline.PEAK_FLOPS_FP32

# fraction of PEAK_FLOPS each local 1-D implementation sustains — priors
# for one NVIDIA H100 80GB HBM3 at 700 W from one timed call of each at
# (2^20 rows, 1024 points) = 5.37e10 flop (chip_smoke.py phase 6a: 5.798,
# 5.773, 41.21 and 218.9 ms), which mode="measure" refines empirically
IMPL_EFFICIENCY = {
    "matmul": 0.0194,   # four-step DFT-by-matmul in plain tensor ops
    "pallas": 0.138,    # the hand-written four-step kernel (fft4step.cu)
    "stockham": 0.0037,  # radix-2 passes in plain tensor ops
    "xla": 0.139,       # the library FFT (torch.fft, cuFFT)
}
_DEFAULT_EFFICIENCY = IMPL_EFFICIENCY["xla"]
LOCAL_PASSES = 10          # HBM round trips over the local block
#: per-collective launch latency: a prior (NCCL's small-message launch
#: and sync cost within one NVLink node is of order 10 us) until a
#: calibration run publishes a fit (collective_constants)
COLLECTIVE_LATENCY_S = 10e-6
REPLAN_PASSES = 6          # twiddle re-materialization, options 1/3


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize

#: environment variable naming a calibration JSON (the reference's
#: ``benchmarks/collective_profile.py`` writes one) with fitted
#: ``collective_alpha_s`` / ``collective_beta_s_per_byte``
CALIBRATION_ENV = "CROFT_CALIBRATION"
_calibration_file_cache: dict = {}


def _calibration_from_file() -> Optional[tuple]:
    import json
    import os
    path = os.environ.get(CALIBRATION_ENV)
    if not path or not os.path.exists(path):
        return None
    try:
        mtime = os.path.getmtime(path)
        cached = _calibration_file_cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        with open(path) as f:
            d = json.load(f)
        vals = (float(d["collective_alpha_s"]),
                float(d["collective_beta_s_per_byte"]))
        _calibration_file_cache[path] = (mtime, vals)
        return vals
    except (OSError, ValueError, KeyError, TypeError):
        return None


def collective_constants() -> tuple:
    """(alpha seconds-per-launch, beta seconds-per-byte) for collectives.

    Precedence: live calibration published through the
    ``repro_torch.obs`` metrics registry (gauges ``collective_alpha_s`` /
    ``collective_beta_s_per_byte``, a calibration run's lstsq fit) > a
    saved calibration JSON named by ``$CROFT_CALIBRATION`` > the priors
    (``COLLECTIVE_LATENCY_S``, ``1 / LINK_BW``).  Non-positive fits are ignored (a
    degenerate lstsq on noisy walls can go negative — the hardcoded
    floor is better than a nonsense model).
    """
    alpha, beta = COLLECTIVE_LATENCY_S, 1.0 / LINK_BW
    file_vals = _calibration_from_file()
    if file_vals is not None:
        fa, fb = file_vals
        alpha = fa if fa > 0 else alpha
        beta = fb if fb > 0 else beta
    try:
        from repro_torch.obs import metrics as metrics_lib
        reg = metrics_lib.get_registry()
        ga = reg.gauge("collective_alpha_s").value
        gb = reg.gauge("collective_beta_s_per_byte").value
        alpha = ga if ga and ga > 0 else alpha
        beta = gb if gb and gb > 0 else beta
    except Exception:
        pass
    return alpha, beta


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Modeled wall-clock terms for one candidate (seconds)."""

    compute_s: float
    memory_s: float
    collective_s: float
    latency_s: float
    replan_s: float
    total_s: float
    flops: float
    local_bytes: float
    collective_bytes: float
    n_collectives: int
    n_procs: int
    #: ring pack/unpack passes or the pairwise serial placement chain
    transpose_overhead_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def flops_model(shape: Sequence[int]) -> float:
    """Analytic 5 N log2 N FLOPs of the full c2c 3-D transform."""
    n_total = math.prod(shape)
    return 5.0 * n_total * sum(math.log2(s) for s in shape)


def schedule_for(shape: Sequence[int], cand: Candidate) -> Schedule:
    """The forward schedule this candidate would execute — the single
    source of stage structure for both the executor and this model
    (``Croft3D._forward_schedule`` reads it too).

    The r2c embedding's guarded half-slice (``core.rfft``, natural
    layout only: the odd-sized Nh axis is resharded z-local before
    slicing) is recorded as an out-of-body ``ExtraComm`` of ~half the
    spectrum volume, so its bytes and launch are charged like any other
    collective.
    """
    from repro_torch.tuning.candidates import split_grad
    build = getattr(cand, "build_schedule", None)
    if build is not None:
        # searched pipeline: the candidate IS the schedule (stage list +
        # per-stage overrides); nothing to re-derive from the builders
        return build()
    base_problem, _ = split_grad(cand.problem)
    if base_problem == "r2c" and cand.strategy == "packed":
        from repro_torch.real import pipeline as real_pipeline
        return real_pipeline.build_packed_forward(cand.decomp)
    sched = build_schedule(cand.decomp, cand.opts, sign=-1)
    if (base_problem == "r2c" and cand.strategy == "embed"
            and cand.opts.output_layout == "natural"):
        from repro_torch.core.schedule import ExtraComm
        half = sched.layout_out.with_den(2, mul=2)
        sched = dataclasses.replace(
            sched, extra_comms=sched.extra_comms
            + (ExtraComm("guarded-half-slice", half),))
    return sched


def schedules_for(shape: Sequence[int], cand: Candidate) -> list:
    """Every schedule one step of this candidate executes: the forward,
    plus its adjoint (``repro_torch.grad``) for the ``_grad`` problems — the
    training-step cost is their sum, and the adjoint's stage structure
    (same transposes, mirrored order) is priced with the same model."""
    from repro_torch.tuning.candidates import split_grad
    sched = schedule_for(shape, cand)
    _, is_grad = split_grad(cand.problem)
    if not is_grad:
        return [sched]
    from repro_torch.grad import adjoint_schedule
    return [sched, adjoint_schedule(sched)]


def analytic_cost(shape: Sequence[int], cand: Candidate,
                  axis_sizes: Mapping[str, int],
                  dtype=torch.complex64, batch: int = 1) -> CostBreakdown:
    """Modeled seconds for one execution of this candidate — one forward
    transform, or one fwd+bwd pair for the ``_grad`` problems (the
    schedules run sequentially, so their modeled times sum)."""
    parts = [_schedule_cost(shape, cand, sched, axis_sizes, dtype, batch)
             for sched in schedules_for(shape, cand)]
    if len(parts) == 1:
        return parts[0]
    return CostBreakdown(**{
        f.name: (sum(getattr(b, f.name) for b in parts)
                 if f.name != "n_procs" else parts[0].n_procs)
        for f in dataclasses.fields(CostBreakdown)})


def _schedule_cost(shape: Sequence[int], cand: Candidate, sched: Schedule,
                   axis_sizes: Mapping[str, int],
                   dtype=torch.complex64, batch: int = 1) -> CostBreakdown:
    if getattr(cand, "is_schedule", False):
        return _searched_schedule_cost(shape, cand, sched, axis_sizes,
                                       dtype, batch)
    decomp, opts = cand.decomp, cand.opts
    itemsize = _itemsize(dtype)
    p = decomp.n_procs(axis_sizes)
    alpha, beta = collective_constants()

    # compute: one event per local FFT, at the schedule's reported size
    flops = 0.0
    compute_s = 0.0
    for impl_stage, elems, n_fft in sched.fft_events(shape, axis_sizes):
        f = 5.0 * elems * math.log2(n_fft)
        flops += f
        eff = IMPL_EFFICIENCY.get(opts.stage_impl(impl_stage),
                                  _DEFAULT_EFFICIENCY)
        compute_s += f / (PEAK_FLOPS * eff)
    flops *= batch
    compute_s *= batch

    local_bytes = sched.layout_in.bytes(shape, axis_sizes, itemsize) * batch
    memory_s = LOCAL_PASSES * local_bytes / HBM_BW

    events = sched.comm_events(shape, axis_sizes, itemsize)
    coll_bytes = float(sum(ev["bytes"] for ev in events)) * batch
    collective_s = coll_bytes * beta

    # collective-op count: effective K chunks per in-body transpose (the
    # executor's chunk-indivisible fallback, read from the schedule); the
    # ppermute-based transposes (ring, pairwise) issue (P_axis - 1)
    # rounds where the fused path issues one a2a; out-of-body reshards
    # are one fused a2a each.  Alongside the alpha count, each impl's
    # structural overhead: the ring pays one fused pack + one fused
    # unpack pass over the moved bytes, the pairwise emulation pays a
    # *serial* placement chain of P-1 full-size output rewrites.
    impl = opts.transpose_impl
    eff_ks = iter(sched.effective_k(shape, axis_sizes, opts.overlap_k))
    n_coll = 0
    k_eff_max = 1
    any_chunkable = False
    transpose_overhead_s = 0.0
    for ev in events:
        if not ev["chunkable"]:
            n_coll += 1
            continue
        any_chunkable = True
        k_eff = next(eff_ks)
        k_eff_max = max(k_eff_max, k_eff)
        ops = (ev["comm_size"] - 1) if impl in ("ring", "pairwise") else 1
        n_coll += k_eff * ops
        ev_bytes = ev["bytes"] * batch
        if impl == "ring":
            transpose_overhead_s += 2 * ev_bytes / HBM_BW
        elif impl == "pairwise":
            transpose_overhead_s += (ev["comm_size"] - 1) * ev_bytes / HBM_BW
    latency_s = n_coll * alpha

    replan_s = 0.0
    if not opts.plan_cache:
        replan_s = REPLAN_PASSES * local_bytes / HBM_BW

    busy = compute_s + memory_s
    if impl == "ring":
        busy += transpose_overhead_s  # pack/unpack pipeline with the rounds
    # beta overlap: K >= 2 chunks pipeline any impl's collective against
    # the neighbouring chunks' FFTs; the ring's independent rounds
    # additionally overlap at K=1.  The pairwise serial chain never
    # overlaps — each round's placement depends on the previous one.
    overlaps = (any_chunkable and impl != "pairwise"
                and (k_eff_max >= 2 or impl == "ring"))
    if overlaps:
        # paper §5.1: chunked pipeline hides the smaller of the two legs
        overlapped = max(busy, collective_s) + 0.1 * min(busy, collective_s)
    else:
        overlapped = busy + collective_s
        if impl == "pairwise":
            overlapped += transpose_overhead_s
    total = overlapped + latency_s + replan_s

    return CostBreakdown(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        latency_s=latency_s, replan_s=replan_s, total_s=total, flops=flops,
        local_bytes=float(local_bytes), collective_bytes=float(coll_bytes),
        n_collectives=n_coll, n_procs=p,
        transpose_overhead_s=transpose_overhead_s)


def _searched_schedule_cost(shape: Sequence[int], cand, sched: Schedule,
                            axis_sizes: Mapping[str, int],
                            dtype=torch.complex64,
                            batch: int = 1) -> CostBreakdown:
    """Per-stage §5.1 combine for searched pipelines.

    The legacy formula prices the whole schedule with one global
    ``max(busy, collective)`` — fine for homogeneous knobs, but it can
    hide a stage that *cannot* overlap (chunk-indivisible alltoall)
    under another stage's compute, which per-stage measurements show is
    not physical.  Searched schedules mix
    impls and K per stage, so each stage's overlap is priced against its
    OWN legs — the same decomposition :func:`per_stage_costs` reports —
    and the stage times sum.  Fixed-builder candidates keep the legacy
    combine so existing rankings and pins are bit-identical.
    """
    from repro_torch.core.schedule import flat_axes, stage_transpose_impl
    opts = cand.opts
    itemsize = _itemsize(dtype)
    p = cand.decomp.n_procs(axis_sizes)
    alpha, beta = collective_constants()

    flops = 0.0
    compute_s = 0.0
    for impl_stage, elems, n_fft in sched.fft_events(shape, axis_sizes):
        f = 5.0 * elems * math.log2(n_fft)
        flops += f
        eff = IMPL_EFFICIENCY.get(opts.stage_impl(impl_stage),
                                  _DEFAULT_EFFICIENCY)
        compute_s += f / (PEAK_FLOPS * eff)
    flops *= batch
    compute_s *= batch

    local_bytes = sched.layout_in.bytes(shape, axis_sizes, itemsize) * batch
    memory_s = LOCAL_PASSES * local_bytes / HBM_BW

    events = sched.comm_events(shape, axis_sizes, itemsize)
    coll_bytes = float(sum(ev["bytes"] for ev in events)) * batch
    collective_s = coll_bytes * beta

    eff_ks = iter(sched.effective_k(shape, axis_sizes, opts.overlap_k))
    comm_stages = iter(sched.comm_stages())
    n_coll = 0
    transpose_overhead_s = 0.0
    for ev in events:
        if not ev["chunkable"]:
            n_coll += 1
            continue
        _, st = next(comm_stages)
        impl = stage_transpose_impl(st, opts)
        k_eff = next(eff_ks)
        ops = (ev["comm_size"] - 1) if impl in ("ring", "pairwise") else 1
        n_coll += k_eff * ops
        ev_bytes = ev["bytes"] * batch
        if impl == "ring":
            transpose_overhead_s += 2 * ev_bytes / HBM_BW
        elif impl == "pairwise":
            transpose_overhead_s += (ev["comm_size"] - 1) * ev_bytes / HBM_BW
    latency_s = n_coll * alpha

    replan_s = 0.0
    if not opts.plan_cache:
        replan_s = REPLAN_PASSES * local_bytes / HBM_BW

    # the per-stage combine: each stage hides the smaller of its own two
    # legs when it pipelines (ring overhead is already inside the rows'
    # compute leg; the pairwise chain rides in compute and never hides)
    rows = _stage_rows(shape, cand, sched, axis_sizes, dtype, batch, "fwd")
    staged = 0.0
    for r in rows:
        c, coll = r["compute_s"], r["collective_s"]
        if r["overlaps"]:
            staged += max(c, coll) + 0.1 * min(c, coll)
        else:
            staged += c + coll
    total = staged + latency_s + replan_s

    return CostBreakdown(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        latency_s=latency_s, replan_s=replan_s, total_s=total, flops=flops,
        local_bytes=float(local_bytes), collective_bytes=float(coll_bytes),
        n_collectives=n_coll, n_procs=p,
        transpose_overhead_s=transpose_overhead_s)


def predicted_collectives(sched: Schedule, shape: Sequence[int],
                          axis_sizes: Mapping[str, int], opts) -> dict:
    """Per-kind collective-op counts the executor will emit for this
    schedule — what :func:`counted_collectives` is held against: one ``all-to-all`` per effective chunk of a fused stage,
    ``K_eff * (P-1)`` ``collective-permute`` rounds for ring/pairwise,
    one fused all-to-all per out-of-body reshard."""
    from repro_torch.core.schedule import flat_axes, stage_transpose_impl
    sizes = dict(axis_sizes)
    counts = {"all-to-all": 0, "collective-permute": 0}
    eff = sched.effective_k(shape, axis_sizes, opts.overlap_k)
    for (_, st), k_eff in zip(sched.comm_stages(), eff):
        impl = stage_transpose_impl(st, opts)
        csize = math.prod(sizes[n] for n in flat_axes(st.comm_axis))
        if impl == "alltoall":
            counts["all-to-all"] += k_eff
        else:
            counts["collective-permute"] += k_eff * (csize - 1)
    counts["all-to-all"] += len(sched.extra_comms)
    return counts


def per_stage_costs(shape: Sequence[int], cand: Candidate,
                    axis_sizes: Mapping[str, int],
                    dtype=torch.complex64, batch: int = 1) -> list:
    """Modeled per-stage compute/collective split — what traced per-stage
    timings are joined against.

    One row per schedule stage (plus one per out-of-body reshard), using
    the same conventions as :func:`analytic_cost`: FFT flops at the
    layout-reported block size over ``PEAK_FLOPS * IMPL_EFFICIENCY``,
    the ``LOCAL_PASSES`` HBM budget spread evenly across the stages that
    do local work, ring pack/unpack passes charged to the compute leg,
    and the §5.1 overlap rule (0.9 of the smaller leg hides under the
    larger when the stage pipelines: any chunkable stage with effective
    K >= 2, or the ring's independent rounds even at K=1; the pairwise
    serial chain never overlaps).  ``predicted_efficiency`` is the
    modeled fraction of the stage's collective time hidden under
    compute — the per-stage form of the paper's 42-51% claim.
    """
    rows = []
    scheds = schedules_for(shape, cand)
    for direction, sched in zip(("fwd", "bwd"), scheds):
        rows.extend(_stage_rows(shape, cand, sched, axis_sizes, dtype,
                                batch, direction))
    return rows


def _stage_rows(shape, cand, sched, axis_sizes, dtype, batch,
                direction) -> list:
    opts = cand.opts
    itemsize = _itemsize(dtype)
    _, beta = collective_constants()
    eff_ks = iter(sched.effective_k(shape, axis_sizes, opts.overlap_k))

    from repro_torch.core.schedule import (flat_axes, stage_category,
                                           stage_transpose_impl)
    n_local = sum(1 for st in sched.stages
                  if st.fft_axis is not None or st.prologue or st.epilogue)
    mem_passes = LOCAL_PASSES / max(1, n_local)

    rows = []
    for i, (st, pts) in enumerate(zip(sched.stages, sched.points)):
        compute_s = 0.0
        if st.fft_axis is not None:
            loc = pts.fft.local_shape(shape, axis_sizes)
            f = 5.0 * math.prod(loc) * math.log2(loc[st.fft_axis])
            eff = IMPL_EFFICIENCY.get(opts.stage_impl(st.impl_stage),
                                      _DEFAULT_EFFICIENCY)
            compute_s += f / (PEAK_FLOPS * eff)
        if st.fft_axis is not None or st.prologue or st.epilogue:
            compute_s += (mem_passes
                          * pts.entry.bytes(shape, axis_sizes, itemsize)
                          / HBM_BW)
        compute_s *= batch

        collective_s = 0.0
        k_eff = 1
        overlaps = False
        if st.comm_axis is not None:
            impl = stage_transpose_impl(st, opts)
            ev_bytes = pts.comm.bytes(shape, axis_sizes, itemsize) * batch
            collective_s = ev_bytes * beta
            k_eff = next(eff_ks)
            overlaps = impl != "pairwise" and (k_eff >= 2 or impl == "ring")
            if impl == "ring":
                compute_s += 2 * ev_bytes / HBM_BW
            elif impl == "pairwise":
                csize = math.prod(axis_sizes[n]
                                  for n in flat_axes(st.comm_axis))
                compute_s += (csize - 1) * ev_bytes / HBM_BW

        hidden = 0.9 * min(compute_s, collective_s) if overlaps else 0.0
        rows.append({
            "stage": i,
            "name": st.name,
            "direction": direction,
            "category": stage_category(st),
            "impl": (stage_transpose_impl(st, opts)
                     if st.comm_axis is not None else None),
            "compute_s": compute_s,
            "collective_s": collective_s,
            "k_eff": k_eff,
            "overlaps": overlaps,
            "hidden_s": hidden,
            "predicted_efficiency": (hidden / collective_s
                                     if collective_s else None),
        })
    for ec in sched.extra_comms:
        coll = ec.layout.bytes(shape, axis_sizes, itemsize) * batch * beta
        rows.append({
            "stage": None, "name": ec.name, "direction": direction,
            "category": "collective",
            "compute_s": 0.0, "collective_s": coll, "k_eff": 1,
            "overlaps": False, "hidden_s": 0.0,
            "predicted_efficiency": 0.0 if coll else None,
        })
    return rows


def rank_candidates(shape: Sequence[int], cands: Sequence[Candidate],
                    axis_sizes: Mapping[str, int],
                    dtype=torch.complex64,
                    batch: int = 1) -> list[tuple[Candidate, CostBreakdown]]:
    """Candidates sorted by modeled total time, cheapest first (stable —
    enumeration order breaks ties, keeping ranking deterministic)."""
    scored = [(c, analytic_cost(shape, c, axis_sizes, dtype, batch))
              for c in cands]
    scored.sort(key=lambda t: t[1].total_s)
    return scored


def counted_collectives(plan) -> Optional[dict]:
    """Collective counts/bytes of one forward of ``plan``, counted on the
    wire by ``Mesh.counting`` (the reference's ``hlo_collectives`` keys:
    ``collectives`` per kind as ``{"count", "bytes"}``, their
    ``collective_bytes`` total, and the model's per-rank ``flops`` and
    HBM ``bytes``).  It runs the forward on a zero input, so every rank of
    the plan's mesh must call it; None when the plan has no mesh."""
    if plan.mesh is None:
        return None
    x = torch.zeros(plan.local_input_shape(), dtype=plan.input_dtype,
                    device=plan.device)
    with torch.no_grad(), plan.mesh.counting() as count:
        plan.forward(x)
    cost = analytic_cost(plan.shape, plan.candidate(), plan.mesh.shape,
                         plan.dtype)
    return {
        "collective_bytes": float(count.bytes),
        "collectives": count.collectives,
        "flops": cost.flops,
        "bytes": LOCAL_PASSES * cost.local_bytes,
    }
