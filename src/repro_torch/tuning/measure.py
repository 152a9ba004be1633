"""Empirical measurement — the planner's FFTW-``PATIENT`` leg.

Port of ``repro/tuning/measure.py``.  Builds and wall-clock-times
candidate plans on the live mesh.  Only the model-ranked top-k reach this
stage, mirroring how FFTW's PATIENT mode prunes with heuristics before
timing.

Where the reference times on one JAX controller, every rank of the
port's mesh runs the tuner and times its own part of each plan.  So the
ranks agree before they return anything:

  * a candidate whose plan is refused on any rank (plan validation
    raises ``ValueError`` or ``NotImplementedError``, or an injected
    ``tune.measure`` fault fires) is dropped on every rank — an
    all-reduced flag decides, before any rank runs the plan's
    collectives, so no rank waits on a collective another never issues;
  * any other failure — a hand-written kernel that does not build or
    launch (:class:`~repro_torch.kernels.KernelError`) above all — is
    flagged the same way and then raised on every rank: the tune fails
    rather than race on without the kernel;
  * a failure while timing is flagged once the timing ends; one that
    strikes one rank alone in the middle of a collective cannot be
    recovered here (the other ranks wait in that collective until the
    process group's timeout);
  * every rank's median is reduced with MAX over the mesh's world group,
    so the race decides on the slowest rank's time, the same number on
    every rank.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import tracer as tracer_lib
from repro_torch.tuning.candidates import Candidate


def _random_input(plan, batch: int) -> torch.Tensor:
    """A random block of the plan's input (this rank's block with a mesh),
    with ``batch`` stacked fields when batch > 1."""
    shape = tuple(plan.local_input_shape())
    if batch > 1:
        shape = (batch,) + shape
    gen = torch.Generator(device=plan.device).manual_seed(0)
    dtype = plan.input_dtype
    if dtype.is_complex:
        real = dtype.to_real()
        return torch.complex(
            torch.randn(shape, dtype=real, device=plan.device, generator=gen),
            torch.randn(shape, dtype=real, device=plan.device, generator=gen))
    return torch.randn(shape, dtype=dtype, device=plan.device, generator=gen)


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for off
    the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_wall(step, device: torch.device, warmup: int,
                 iters: int) -> float:
    for _ in range(warmup):
        step()
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_forward(plan, *, warmup: int = 2, iters: int = 5,
                 batch: int = 1) -> float:
    """Median wall seconds per forward transform of a built plan, on this
    rank (the wall ends in ``torch.cuda.synchronize()`` on the card).

    ``batch > 1`` times ``forward_batched`` over B stacked fields — what a
    ``tune(batch=B)`` caller will actually run — instead of the B=1
    proxy (the executor carries the batch through the same collectives,
    so deeper plans amortize their launches and the B=1 timing would
    mis-rank them).
    """
    x = _random_input(plan, batch)
    fwd = plan.forward_batched if batch > 1 else plan.forward

    def step():
        with torch.no_grad():
            fwd(x)
    return _median_wall(step, plan.device, warmup, iters)


def time_train_step(plan, *, warmup: int = 2, iters: int = 5,
                    batch: int = 1) -> float:
    """Median wall seconds per forward + ``backward()`` step through the
    plan, on this rank.

    This is what a ``*_grad`` tune races: a scalar loss (sum |F x|^2)
    differentiated back through the transform, so the timing covers the
    forward schedule *and* the adjoint schedule the autograd plan runs —
    the quantity a training loop actually pays per step.  With a mesh
    every rank runs the step (the backward is collective).
    """
    x = _random_input(plan, batch).requires_grad_(True)
    fwd = plan.forward_batched if batch > 1 else plan.forward

    def step():
        x.grad = None
        y = fwd(x)
        torch.linalg.vector_norm(y).square().backward()
    return _median_wall(step, plan.device, warmup, iters)


# what a failed candidate flags: a refused plan drops it, anything else
# (a kernel error first of all) fails the tune on every rank
_OK, _DROPPED, _KERNEL, _OTHER = 0, 1, 2, 3


def _code(exc: Optional[BaseException]) -> int:
    from repro_torch.kernels import KernelError
    from repro_torch.resil.inject import InjectedFault
    if exc is None:
        return _OK
    if isinstance(exc, KernelError):
        return _KERNEL
    if isinstance(exc, (ValueError, NotImplementedError, InjectedFault)):
        return _DROPPED
    return _OTHER


def agree(mesh, code: int, t: float) -> tuple[int, float]:
    """(worst failure code of any rank, slowest rank's time): one MAX
    all-reduce over the mesh's world group; a meshless or one-rank run
    passes through."""
    if mesh is None or not dist.is_initialized() or mesh.size == 1:
        return code, t
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    v = torch.tensor([float(code), t], dtype=torch.float64, device=dev)
    dist.all_reduce(v, op=dist.ReduceOp.MAX)
    return int(v[0].item()), float(v[1].item())


def _settle(mesh, exc: Optional[BaseException], t: float, label: str
            ) -> tuple[bool, float]:
    """Agree on one step of a measurement: (drop the candidate, the
    slowest rank's time).  A failure that is not a refused plan is
    raised on every rank — the rank's own error where it struck, a
    :class:`KernelError` or ``RuntimeError`` naming the candidate on the
    others."""
    from repro_torch.kernels import KernelError
    code, t = agree(mesh, _code(exc), t)
    if code in (_KERNEL, _OTHER):
        if exc is not None and _code(exc) != _DROPPED:
            raise exc
        kind = KernelError if code == _KERNEL else RuntimeError
        raise kind(f"measuring {label} failed on another rank")
    return code == _DROPPED, t


def measure_candidate(shape: Sequence[int], mesh, cand: Candidate,
                      dtype=torch.complex64, *, warmup: int = 2,
                      iters: int = 5, batch: int = 1) -> Optional[float]:
    """Median forward seconds for one candidate on the live mesh (over
    ``batch`` stacked fields when batch > 1), the slowest rank's; None on
    every rank if the candidate's plan is refused on any rank (it is then
    dropped from the race rather than failing the whole tune).  A kernel
    that does not build or launch, or any other failure, raises on every
    rank instead.  ``*_grad`` candidates race a full forward + backward
    step (see :func:`time_train_step`) on the base problem's plan.  Every
    rank of the mesh calls it, for the same candidates in the same
    order."""
    from repro_torch.core.api import Croft3D
    from repro_torch.resil import inject as inject_lib
    from repro_torch.tuning.candidates import split_grad
    reg = metrics_lib.get_registry()
    # tag_scope marks every span emitted while timing as tuner traffic,
    # so a shared trace never confuses measurement runs with serving
    # traffic
    with tracer_lib.tag_scope(traffic="tuning"):
        with tracer_lib.get_tracer().span("measure:candidate", "plan",
                                          plan=cand.label, batch=batch):
            plan, exc = None, None
            base_problem, is_grad = split_grad(cand.problem)
            try:
                inject_lib.fire("tune.measure", cand.label)
                plan = Croft3D(tuple(shape), mesh, cand.decomp, cand.opts,
                               dtype=dtype, problem=base_problem,
                               strategy=getattr(cand, "strategy", None),
                               schedule=cand if getattr(cand, "is_schedule",
                                                        False) else None)
            except Exception as e:
                exc = e
            # agree on the build before any rank runs the plan's
            # collectives
            dropped, _ = _settle(mesh, exc, 0.0, cand.label)
            t = 0.0
            if not dropped:
                timer = time_train_step if is_grad else time_forward
                try:
                    t = timer(plan, warmup=warmup, iters=iters, batch=batch)
                except Exception as e:
                    exc = e
                dropped, t = _settle(mesh, exc, t, cand.label)
            if dropped:
                reg.counter("tune_measure_failures").inc()
                return None
    reg.counter("tune_measure_runs").inc()
    return t
