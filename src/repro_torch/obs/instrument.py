"""Per-stage traced execution: re-drive a plan's schedule with timing shims.

Port of ``repro/obs/instrument.py``.  The reference cannot time inside
``jit`` and so compiles each stage, and each leg of it, into its own
executable.  The port runs eagerly: :func:`trace_forward` re-drives the
plan's :class:`~repro_torch.core.schedule.Schedule` stage by stage on
this rank's block, calling the executor's own functions, and the host
clocks each call up to ``torch.cuda.synchronize()`` (on CPU tensors the
call returns when its work is done).  For stages with a collective, the
compute leg (:func:`~repro_torch.core.schedule.stage_pre`, on each of
the K chunks cut exactly as ``run_stage`` cuts them) and the collective
leg (:func:`~repro_torch.core.schedule.stage_comm`, waited on) are timed
on their own, so the serialized leg times F (fft) and C (collective) are
measurements, not model splits.

The **measured overlap efficiency** of a comm stage falls out of three
wall clocks: with F = serialized compute leg, C = serialized collective
leg, and W = the pipelined full stage,

    hidden = clamp(F + C - W, 0, C)        efficiency = hidden / C

the fraction of collective time that did NOT extend the stage's
critical path: the per-stage measured form of the paper's 42-51 % hiding
claim, joined against ``tuning.cost_model.per_stage_costs``'s predicted
split by ``python -m repro_torch.obs.report``.

On a mesh every rank runs the same legs, chunks and rounds in the same
order (each collective needs all of its ranks), lines up with the others
before each timed run, and every median is the slowest rank's (one MAX
all-reduce after the timed runs, as ``tuning/measure.py`` does), so
every rank returns the same summary.  The reference's ``hlo`` row of
compiled-HLO statistics becomes the collectives ``Mesh.counting()``
counts over one run of the stage, under the same key names
(``hlo_collectives``, ``hlo_collective_bytes``, ``hlo_<kind>_count`` /
``_bytes``); there are no ``hlo_flops`` / ``hlo_bytes``.

Scope: c2c plans on a mesh (the packed real pipeline's stages carry
``den`` factors whose chunk shapes this stage-by-stage re-run does not
reproduce; r2c and meshless plans get a single end-to-end span).
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import schedule as schedule_lib
from repro_torch.obs import tracer as tracer_lib
from repro_torch.tuning import measure


def _line_up(mesh) -> None:
    """Every rank enters the next timed run together (one all-reduce
    outside the timed window), so a collective leg does not time another
    rank's lag."""
    if mesh is not None and dist.is_initialized() and mesh.size > 1:
        dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        dist.all_reduce(torch.zeros(1, device=dev))


def _slowest(mesh, value: float) -> float:
    """The slowest rank's ``value`` (one MAX all-reduce; identity off a
    mesh)."""
    return measure.agree(mesh, 0, value)[1]


def _timed(tracer, fn, name, cat, iters, span_args, mesh, device):
    """Slowest rank's median wall seconds of ``fn()`` over ``iters`` timed
    runs (one untimed warm-up), one span per run; returns
    (median_s, last_output)."""
    out = fn()
    measure.sync(device)
    times = []
    for n in range(iters):
        _line_up(mesh)
        t0 = time.monotonic()
        out = fn()
        measure.sync(device)
        t1 = time.monotonic()
        times.append(t1 - t0)
        tracer.complete(name, cat, t0, t1, dict(span_args, iter=n))
    return _slowest(mesh, statistics.median(times)), out


def _counted(mesh, fn) -> tuple:
    """The stage's collectives as the reference's ``hlo_cost.summarize``
    row (``hlo_collectives``, ``hlo_collective_bytes``, per kind
    ``hlo_<kind>_count`` / ``_bytes``), counted over one call of ``fn``;
    returns (row, fn's output)."""
    with mesh.counting() as c:
        out = fn()
    row = {"hlo_collective_bytes": c.bytes,
           "hlo_collectives": sum(c.counts.values())}
    for kind, e in sorted(c.collectives.items()):
        row[f"hlo_{kind}_count"] = e["count"]
        row[f"hlo_{kind}_bytes"] = e["bytes"]
    return row, out


def _chunks(blk, st, opts) -> list:
    """The K chunks ``run_stage`` cuts (one when K <= 1 or the chunk axis
    does not divide)."""
    k = schedule_lib.stage_overlap_k(st, opts)
    ax = st.chunk_axis
    if k <= 1 or blk.shape[ax] % k:
        return [blk]
    return list(torch.chunk(blk, k, dim=ax))


@torch.no_grad()
def trace_forward(plan, x, tracer=None, iters: int = 3,
                  label: Optional[str] = None) -> tuple:
    """Run ``plan.forward(x)`` with per-stage/per-chunk attribution.

    Emits spans into ``tracer`` (the process tracer by default), returns
    ``(y, summary)`` where ``y`` is the production ``plan.forward``
    output and ``summary`` the per-stage model-vs-measured rows (also
    attached to the trace metadata under ``"attribution"`` for
    ``repro_torch.obs.report``).  ``x`` is this rank's
    ``plan.input_sharding`` block; on a mesh every rank calls this.
    """
    if tracer is None:
        tracer = tracer_lib.get_tracer()
    # plan.candidate() — not a hand-built Candidate — so searched
    # schedules attribute under their own pipeline identity/model rows
    cand = plan.candidate() if plan.decomp is not None else None
    label = label or (cand.label if cand is not None else "meshless")
    mesh = plan.mesh
    device = plan.device

    _line_up(mesh)
    with tracer.span("e2e", "plan", plan=label):
        t0 = time.monotonic()
        y = plan.forward(x)
        measure.sync(device)
        e2e_s = time.monotonic() - t0
    e2e_s = _slowest(mesh, e2e_s)

    summary = {
        "plan": label,
        "plan_key": cand.plan_key if cand is not None else None,
        "shape": list(plan.shape),
        "transpose_impl": plan.opts.transpose_impl,
        "overlap_k": plan.opts.overlap_k,
        "e2e_s": e2e_s,
        "stages": [],
        "overall": None,
    }
    if mesh is None or plan.problem != "c2c":
        summary["note"] = ("per-stage attribution covers c2c mesh plans; "
                           "only the e2e span was recorded")
        _attach(tracer, summary)
        return y, summary

    opts = plan.opts
    axis_sizes = dict(mesh.shape)
    sched = plan._forward_schedule()
    from repro_torch.tuning.cost_model import per_stage_costs
    model_rows = {r["stage"]: r for r in per_stage_costs(
        plan.shape, cand, axis_sizes, plan.dtype)}
    k_effs = dict(zip((i for i, _ in sched.comm_stages()),
                      sched.effective_k(plan.shape, axis_sizes,
                                        opts.overlap_k)))

    cur = x.to(plan.dtype)
    total_c = total_hidden = 0.0
    for i, st in enumerate(sched.stages):
        cat = schedule_lib.stage_category(st)

        def full(blk=cur, st=st):
            return schedule_lib.run_stage(blk, st, sched.sign, opts, mesh)

        hlo, _ = _counted(mesh, full)
        row = dict(stage=i, name=st.name, category=cat,
                   k_eff=k_effs.get(i, 1), model=model_rows.get(i),
                   hlo=hlo)
        span_args = {"stage": i, "plan": label, "part": "stage",
                     "k_eff": row["k_eff"], **hlo}
        wall, out = _timed(tracer, full, f"s{i}:{st.name}", cat, iters,
                           span_args, mesh, device)
        row["wall_s"] = wall

        if st.comm_axis is not None:
            fft_s, comm_s, rounds = _split_legs(
                tracer, plan, sched, i, st, cur, iters, label)
            hidden = min(max(fft_s + comm_s - wall, 0.0), comm_s)
            row.update(fft_s=fft_s, comm_s=comm_s, hidden_s=hidden,
                       measured_efficiency=(hidden / comm_s if comm_s
                                            else None))
            if rounds:
                row["rounds"] = rounds
            total_c += comm_s
            total_hidden += hidden
        else:
            row.update(fft_s=wall, comm_s=0.0, hidden_s=0.0,
                       measured_efficiency=None)
        summary["stages"].append(row)
        cur = out

    if total_c:
        summary["overall"] = {"collective_s": total_c,
                              "hidden_s": total_hidden,
                              "efficiency": total_hidden / total_c}
    _attach(tracer, summary)
    return y, summary


def _split_legs(tracer, plan, sched, i, st, cur, iters, label):
    """Serialized compute/collective leg times of comm stage ``i``: each
    of the K chunks (cut as ``run_stage`` cuts them) through
    :func:`stage_pre`, then its output through :func:`stage_comm`,
    summed over chunks.  For ring and pairwise stages the collective leg
    of chunk 0 is also split into its P-1 rounds
    (:func:`schedule.ring_round`), so the trace shows where inside the
    ring the stage's wall time goes; returns ``(fft_s, comm_s, rounds)``."""
    mesh, opts, device = plan.mesh, plan.opts, plan.device
    chunks = _chunks(cur, st, opts)
    k = len(chunks)
    impl = schedule_lib.stage_transpose_impl(st, opts)
    p = mesh.axis_size(st.comm_axis)

    fft_s = comm_s = 0.0
    rounds = []
    for j, chunk in enumerate(chunks):
        def pre_j(c=chunk):
            return schedule_lib.stage_pre(c, st, sched.sign, opts)

        dt, pre_out = _timed(
            tracer, pre_j, f"s{i}:{st.name}:fft", "fft", iters,
            {"stage": i, "plan": label, "part": "fft", "chunk": j, "k": k},
            mesh, device)
        fft_s += dt

        def comm_j(c=pre_out):
            return schedule_lib.stage_comm(c, st, opts, mesh).wait()

        dt, _ = _timed(
            tracer, comm_j, f"s{i}:{st.name}:comm", "collective", iters,
            {"stage": i, "plan": label, "part": "comm", "chunk": j, "k": k},
            mesh, device)
        comm_s += dt

        if j == 0 and impl in ("ring", "pairwise") and p > 1:
            for rnd in range(1, p):
                def round_r(c=pre_out, rnd=rnd):
                    return schedule_lib.ring_round(c, st, opts, mesh, rnd)

                rdt, _ = _timed(
                    tracer, round_r, f"s{i}:{st.name}:round[{rnd}]",
                    "collective", iters,
                    {"stage": i, "plan": label, "part": "round",
                     "round": rnd, "p": p}, mesh, device)
                rounds.append({"round": rnd, "wall_s": rdt})
    return fft_s, comm_s, rounds


def _attach(tracer, summary) -> None:
    if not tracer.enabled:
        return
    attrib = tracer.meta().get("attribution", [])
    tracer.add_meta("attribution", attrib + [summary])
