"""One run of one cell on one rank: set-up, the measured window, the
trace, and the check.

Set-up (``setup_s``, from process start to the first timed step):
imports, CUDA, the kernels' build where the checkout has none yet, the
mesh (four-chip cells), the seeded input made on the device, the plan,
and ``warmup_steps`` steps of the cell's own traffic, which load every
kernel and warm every shape the window uses.  Its parts, the build's
apart, go on the result line as ``setup_parts``.  The plan's set-up is
its constructor and its first call's excess over a warm step: buffers,
twiddles, kernel loads and, on a mesh, NCCL's communicators.  From the
warm-up's step time the number of steps is fixed so that the window
lasts about ``--seconds``; on several ranks the largest count is taken,
so every rank runs the same steps.

The window is a closed loop with one caller.  Each step's latency runs
from its issue to its result on the host (``torch.cuda.synchronize``);
the window's clock runs from before the first step to after the last.
With ``--trace 1`` the profiler records the window; nothing else
differs.  After the window the program's state is freed and the
reference judges the answers (``check``).  Rank 0 gathers every rank's
readings and returns the result; the slowest rank's times and the
fullest rank's memory are what it reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import sys
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.harness import check, fields, timeline as timeline_lib
from perfbench.harness import work as work_lib
from perfbench.harness.spec import ROOT, Bench

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
GIB = float(1 << 30)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: list, q: float) -> float:
    """The exact q-th percentile by nearest rank: the smallest value with
    at least q % of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads, on one rank."""
    device_type: str
    steps: int
    step_s: float                 # host window over the steps
    plan_s: float                 # constructor + first call's excess
    mesh_s: Optional[float]
    timeline: Optional[timeline_lib.Timeline]
    work: work_lib.StepWork
    kernels: dict                 # csrc source stem -> kernel names
    comm_bytes_per_step: Optional[float]
    port_ranges: frozenset        # the ranges around calls into the port

    def on_card(self) -> bool:
        return (self.device_type == "cuda" and self.timeline is not None
                and self.timeline.has_device_ops())

    def kernel_ops(self, *sources: str) -> list:
        """Device ops of the hand-written kernels of these csrc files."""
        match = timeline_lib.name_matcher(
            n for s in sources for n in self.kernels.get(s, ()))
        return self.timeline.select(lambda op: match(op[0]))

    def nccl_ops(self) -> list:
        return self.timeline.select(lambda op: timeline_lib.is_nccl(op[0]))

    @functools.cached_property
    def is_handwritten(self):
        """True for a device op of any kernel of ``csrc/``."""
        return timeline_lib.name_matcher(
            n for names in self.kernels.values() for n in names)


def step_work(config: dict, traffic, ranks: int) -> work_lib.StepWork:
    grid = tuple(config["grid"])
    transforms = [work_lib.Transform(k, grid, ranks)
                  for k in traffic.transforms()]
    real = (work_lib.realpipe_bytes(grid, ranks)
            if traffic.uses_real_pipeline() else 0.0)
    return work_lib.StepWork(transforms, real)


def _read_trace(prof) -> timeline_lib.Timeline:
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return timeline_lib.Timeline(doc)


def _agree_steps(n: int, device: torch.device) -> int:
    if not dist.is_initialized():
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def run_rank(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t0: float,
             join_s: float = 0.0, build_s: float = 0.0) -> dict:
    """This rank's readings of one run (see the module docstring)."""
    parts, last = {"kernels_build": build_s}, [t0 + build_s]

    def lap(name: str) -> None:
        now = time.time()
        parts[name] = now - last[0]
        last[0] = now
    from repro_torch.core import Croft3D, Decomposition, FFTOptions
    from repro_torch.core import poisson_solve
    from repro_torch.core.mesh import make_mesh
    lap("start")                  # imports, CUDA, joining the world

    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    reference = bench.reference(config["reference"])
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(config["grid"])
    dtype = getattr(torch, config["dtype"])

    # -- set-up ---------------------------------------------------------------
    mesh, mesh_s, decomp = None, None, None
    if config.get("mesh") is not None:
        t = time.perf_counter()
        mesh = make_mesh(config["mesh"]["shape"], config["mesh"]["axes"],
                         device=device)
        mesh_s = join_s + time.perf_counter() - t
        decomp = Decomposition(config["decomposition"]["kind"],
                               tuple(config["decomposition"]["axes"]))
        lap("mesh")
    elif world > 1:
        raise ValueError(f"{workload}: a meshless cell runs on one rank")
    where = check.blocks(reference, config, traffic, rank)
    x = fields.block(seed, shape, traffic.input_dtype(dtype), where["input"],
                     device)
    sync(device)
    lap("field")
    t = time.perf_counter()
    plan = Croft3D(shape, mesh, decomp, FFTOptions(**config["options"]),
                   dtype=dtype, device=None if mesh else device,
                   **traffic.plan_kwargs())
    construct_s = time.perf_counter() - t
    lap("plan")
    step = traffic.step_fn(plan, poisson_solve)
    warm = []
    for _ in range(traffic.warmup_steps):
        answers = None
        t = time.perf_counter()
        answers = step(x)
        sync(device)
        warm.append(time.perf_counter() - t)
    shapes = {k: tuple(v.shape) for k, v in answers.items()}
    dtypes = {k: v.dtype for k, v in answers.items()}
    answers = None
    lap("warm_up")
    est = statistics.median(warm[1:]) if len(warm) > 1 else warm[0]
    plan_s = construct_s + max(0.0, warm[0] - est)
    n = _agree_steps(max(traffic.min_steps, math.ceil(seconds / est)), device)
    samples = check.Samples(seed, shapes, dtypes, traffic.sample_points, n,
                            device)
    counting = mesh.counting() if mesh is not None else contextlib.nullcontext()
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if mesh is not None:
        dist.barrier()
    sync(device)

    # -- the window -----------------------------------------------------------
    lap("other")
    setup_s = last[0] - t0
    lat = []
    with counting as count:
        t_start = time.perf_counter()
        with record_function(timeline_lib.WINDOW):
            for _ in range(n):
                answers = None
                t = time.perf_counter()
                with record_function("perfbench.step"):
                    answers = step(x)
                    # queued behind the step, so the host's part of it
                    # overlaps the device's
                    with record_function("perfbench.digest"):
                        samples.record(answers)
                    with record_function("perfbench.sync"):
                        sync(device)
                lat.append(time.perf_counter() - t)
        window_s = time.perf_counter() - t_start
    sync(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    mine = {"rank": rank, "n": n, "lat": lat, "window_s": window_s,
            "setup_s": setup_s, "peak": window_peak,
            "device_peak": max(setup_peak, window_peak), "warm_s": warm,
            "setup_parts": parts}
    if trace:
        tl = _read_trace(prof)
        del prof
        ctx = Context(device.type, n, window_s / n, plan_s, mesh_s, tl,
                      step_work(config, traffic, world),
                      timeline_lib.handwritten_kernels(CSRC),
                      count.bytes / n if count is not None else None,
                      frozenset(f"perfbench.{c}" for c in traffic.step))
        mine["layer"] = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                mine["layer"][m["name"]] = value
        mine["busy_s"] = tl.busy_s()
        mine["trace_window_s"] = tl.window_s
        mine["breakdown"] = {"device_ops": tl.top_ops(10),
                             "idle_gaps": tl.idle_gaps(10)}
        del tl, ctx

    # -- the check, after the program's state is freed ---------------------
    del x, step
    plan.release()
    del plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mine["checks"] = check.numbers(reference, config, traffic, seed, rank,
                                   answers, samples, device)
    mine["reference_s"] = time.perf_counter() - t
    del answers, samples
    if mesh is not None:
        dist.barrier()
        mesh.close()
    return mine


def combine(bench: Bench, workload: str, trace: bool, ranks: list,
            device: torch.device) -> dict:
    """The result line from every rank's readings."""
    limits = bench.limits(workload)
    n = ranks[0]["n"]
    step_lat = [max(r["lat"][i] for r in ranks) for i in range(n)]
    e2e = {"step_ms": max(r["window_s"] for r in ranks) / n * 1e3,
           "latency_p95_ms": percentile(step_lat, 95) * 1e3,
           "peak_gib": max(r["peak"] for r in ranks) / GIB,
           "setup_s": max(r["setup_s"] for r in ranks)}
    metrics = {}
    if trace:
        for m in bench.per_layer(workload):
            vals = [r["layer"][m["name"]] for r in ranks
                    if m["name"] in r["layer"]]
            if vals:
                how = bench.reader(m["name"]).COMBINE
                value = {"min": min, "max": max,
                         "mean": statistics.fmean}[how](vals)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks = {}
    for name in ranks[0]["checks"]:
        value = max(r["checks"][name] for r in ranks)
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": len(ranks),
           "memory_peak_bytes": max(r["device_peak"] for r in ranks)}
    result = {"correct": correct, "attempted": n, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = statistics.fmean(r["busy_s"] for r in ranks)
        dev["window_s"] = max(r["trace_window_s"] for r in ranks)
        result["breakdown"] = ranks[0]["breakdown"]
    slowest = max(ranks, key=lambda r: r["setup_s"])
    result["setup_parts"] = {"rank": slowest["rank"], **slowest["setup_parts"]}
    beyond = sum(1 for v in step_lat if v > percentile(step_lat, 95))
    log(f"{workload}: {n} steps in {max(r['window_s'] for r in ranks):.3f} s, "
        f"{beyond} beyond the p95; step {e2e['step_ms']:.4f} ms, p95 "
        f"{e2e['latency_p95_ms']:.4f} ms, peak {e2e['peak_gib']:.4f} GiB, "
        f"set-up {e2e['setup_s']:.3f} s "
        f"({ {k: round(v, 3) for k, v in result['setup_parts'].items()} }); "
        f"warm-up steps "
        f"{[round(s, 4) for s in ranks[0]['warm_s']]} s; reference "
        f"{max(r['reference_s'] for r in ranks):.2f} s")
    result["checks"] = checks
    return result
