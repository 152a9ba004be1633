"""Request/result types for the spectral transform service.

Port of ``repro/serve/request.py`` (a copy: that module imports only
numpy, and the port imports nothing of ``repro``).  A
:class:`TransformRequest` is the service's wire unit: one field (or
spectrum, for inverse requests) plus the problem description that picks
the plan.  Requests carry *host* numpy arrays — like RPC payloads — and
results come back as host arrays, so service latency honestly includes
the host-to-card and card-to-host copies a real deployment pays.

Problem classes:

  "c2c"       complex transform, forward or inverse
  "r2c"       real transform (forward: real field -> half spectrum;
              inverse: half spectrum + the plan's Nz -> real field)
  "filtered"  c2c forward with a fused k-space multiply (the request
              brings its own ``h``; the multiply rides as a schedule
              epilogue inside the same transform)

Two requests may share a batch exactly when every knob that changes the
executed transform matches — shape, dtype, problem, direction,
filteredness.  :func:`bucket_key` captures that contract; the plan-cache
key (``repro_torch.tuning.wisdom.wisdom_key``) is its plan-selection
prefix.  ``dtype`` takes a numpy or a torch dtype; both name the same
key string (``tuning.wisdom.dtype_name``), and the request keeps numpy's.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

PROBLEMS = ("c2c", "r2c", "filtered")
DIRECTIONS = ("forward", "inverse")

#: priority classes: lower value = more important.  Load shedding under
#: a bounded queue rejects the highest-valued (least important) pending
#: request first; dispatch ordering prefers lower-valued buckets.
PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_LOW = 0, 1, 2
PRIORITIES = (PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_LOW)

_ids = itertools.count()


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a numpy or torch dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


@dataclasses.dataclass
class TransformRequest:
    """One transform request (host payload + problem description)."""

    x: np.ndarray
    problem: str = "c2c"
    direction: str = "forward"
    #: "filtered" only: the k-space filter, shaped like the spectrum
    h: Optional[np.ndarray] = None
    #: global (Nx, Ny, Nz) grid shape; inferred from the payload for
    #: forward requests, REQUIRED for r2c inverse (Nz is ambiguous there)
    shape: Optional[tuple] = None
    #: spectrum dtype the plan computes in (numpy or torch; kept as numpy)
    dtype: np.dtype = np.complex64
    #: priority class (PRIORITY_HIGH/NORMAL/LOW): sheds last/first under
    #: a bounded queue, dispatches first/last among ready buckets
    priority: int = PRIORITY_NORMAL
    #: seconds after submit by which dispatch must start; a request whose
    #: deadline has passed when its batch forms resolves with a typed
    #: ShedResult instead of running (None = no deadline)
    deadline_s: Optional[float] = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_submit: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def t_deadline(self) -> Optional[float]:
        """Absolute dispatch deadline on the ``time.monotonic()`` clock."""
        return (None if self.deadline_s is None
                else self.t_submit + self.deadline_s)

    def expired(self, now: Optional[float] = None) -> bool:
        td = self.t_deadline
        if td is None:
            return False
        return (time.monotonic() if now is None else now) > td

    def payload_finite(self) -> bool:
        """True when every payload value (x, and h if present) is finite
        — the NaN/Inf isolation predicate, checked only when a batch's
        output came back non-finite (never on the happy path)."""
        if not np.isfinite(self.x).all():
            return False
        return self.h is None or bool(np.isfinite(self.h).all())

    def __post_init__(self):
        if self.problem not in PROBLEMS:
            raise ValueError(f"problem must be one of {PROBLEMS}, "
                             f"got {self.problem!r}")
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, "
                             f"got {self.direction!r}")
        if self.problem == "filtered":
            if self.direction != "forward":
                raise ValueError("filtered requests are forward-only (the "
                                 "filter fuses into the forward epilogue)")
            if self.h is None:
                raise ValueError("filtered requests need a filter h")
        elif self.h is not None:
            raise ValueError('a filter rides only on problem="filtered"')
        if getattr(self.x, "ndim", None) != 3:
            raise ValueError("request payload must be a rank-3 array "
                             f"(got shape {getattr(self.x, 'shape', None)})")
        if self.shape is None:
            if self.problem == "r2c" and self.direction == "inverse":
                raise ValueError("r2c inverse requests must pass shape= — "
                                 "Nz cannot be inferred from the half "
                                 "spectrum (Nh = Nz//2 + 1 is two-to-one)")
            self.shape = tuple(int(s) for s in self.x.shape)
        else:
            self.shape = tuple(int(s) for s in self.shape)
        if len(self.shape) != 3:
            raise ValueError(f"shape must be 3-D, got {self.shape}")
        self.dtype = numpy_dtype(self.dtype)
        self.priority = int(self.priority)
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0 (0 = most "
                             f"important), got {self.priority}")
        if self.deadline_s is not None:
            self.deadline_s = float(self.deadline_s)
            if self.deadline_s < 0:
                raise ValueError(f"deadline_s must be >= 0, "
                                 f"got {self.deadline_s}")

    @property
    def plan_problem(self) -> str:
        """The Croft3D problem class serving this request ("filtered" is
        a c2c plan; the filter is an argument, not a different plan)."""
        return "r2c" if self.problem == "r2c" else "c2c"

    def expected_payload_shape(self) -> tuple:
        """What ``x`` must look like for (shape, problem, direction)."""
        nx, ny, nz = self.shape
        if self.problem == "r2c" and self.direction == "inverse":
            return (nx, ny, nz // 2 + 1)
        return self.shape

    def validate_payload(self) -> None:
        """Early shape/dtype validation (raise at submit, not dispatch —
        a malformed request must not poison a whole batch)."""
        expect = self.expected_payload_shape()
        if tuple(self.x.shape) != expect:
            raise ValueError(
                f"payload shape {tuple(self.x.shape)} != expected {expect} "
                f"for {self.problem}/{self.direction} on grid {self.shape}")
        if self.problem == "r2c" and self.direction == "forward":
            if np.iscomplexobj(self.x):
                raise ValueError("r2c forward payload must be real")
        if self.h is not None:
            nx, ny, nz = self.shape
            hshape = (self.shape if self.plan_problem == "c2c"
                      else (nx, ny, nz // 2 + 1))
            if tuple(self.h.shape) != hshape:
                raise ValueError(f"filter shape {tuple(self.h.shape)} != "
                                 f"spectrum shape {hshape}")


def bucket_key(req: TransformRequest, plan_key: str) -> str:
    """Batchability key: requests sharing it run in ONE stacked dispatch.

    ``plan_key`` (the wisdom key: shape|mesh|dtype|backend[|problem])
    already pins shape, spectrum dtype, mesh, and plan problem class; the
    suffix adds the per-request knobs that select a *different transform
    on the same plan* — direction, and whether a fused filter argument is
    present.  Omitting either would silently alias batches (a forward
    batched with an inverse, or a filtered request dropped into an
    unfiltered batch losing its ``h``).
    """
    return f"{plan_key}|{req.direction}" + ("|filt" if req.h is not None
                                            else "")


@dataclasses.dataclass
class TransformResult:
    """What the caller's future resolves to."""

    req_id: int
    value: Optional[np.ndarray]
    ok: bool = True
    error: Optional[str] = None
    #: end-to-end seconds from submit to result materialization
    latency_s: float = 0.0
    #: how many real requests shared the dispatch, and the padded size
    batch_size: int = 1
    padded_size: int = 1
    #: plan provenance: "hit" | "cold" | "warm" (see serve.plan_cache)
    plan_state: str = "hit"
    plan_key: str = ""
    #: lifecycle timestamps on the ``time.monotonic()`` clock (the same
    #: clock spans use): submit -> dispatch (batch formed, device work
    #: starts) -> done (result on host).  0.0 on failure paths.
    t_submit: float = 0.0
    t_dispatch: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class ShedResult(TransformResult):
    """A request the service *rejected* rather than ran — typed so
    clients can tell load shedding from a transform failure and decide
    to retry elsewhere/later.  Futures always resolve (never hang):
    ``ok`` is False, ``value`` is None, and ``shed_reason`` says why:

      "queue-full"  bounded-queue load shedding evicted it (lowest
                    priority class first, newest first within a class)
      "deadline"    its dispatch deadline passed before its batch formed
      "preempted"   the service was draining for preemption/shutdown
    """

    shed_reason: str = ""
