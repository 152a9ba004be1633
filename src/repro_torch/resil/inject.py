"""Deterministic fault injection — the chaos plane of ``repro_torch.resil``.

Port of ``repro/resil/inject.py``, a copy of that pure-Python module (the
port imports nothing of ``repro``); the same site names fire at the same
places of the ported modules.

Production resilience claims are only testable if failures can be
*scripted*: a chaos gate that asserts "every injected fault maps to
exactly one quarantine/retry/shed event" needs faults that fire at
exactly the scripted call-site invocations, every run.  This module is
that script engine:

  * a :class:`FaultPlan` holds :class:`FaultSpec`\\ s — (site, which
    invocation indices fire, what kind of failure, an optional key
    filter) — plus a log of everything that actually fired, so a bench
    can diff predicted-vs-observed exactly;
  * instrumented call sites are written ``inject.fire("site", key)``
    (raising sites) or ``inject.corrupt("site", key)`` (value-poisoning
    sites).  With no plan installed both are one module-global read and
    a ``None`` check — the same zero-cost-when-disabled contract as
    ``repro_torch.obs.tracer``.

Named sites (grep for the string to find the call site), the
reference's names at the same places of the ported modules:

  ``wisdom.write.crash`` Wisdom.save, between temp-write and atomic rename
  ``tune.measure``       tuning.measure.measure_candidate, before the
                         candidate's plan is built
  ``plan.build``         the serving plan cache's tuned plan construction
  ``plan.upgrade``       the serving plan cache's measured re-plan
  ``serve.dispatch``     the transform service's batch dispatch
  ``exec.output``        the executor's output poisoning

Determinism: explicit ``times`` tuples are exact by construction; for
randomized scripts, :func:`seeded_times` derives the firing indices from
``(seed, site)`` so a bench can compute its prediction from the same
seed it arms the plan with.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
from typing import Optional, Sequence

SITES = ("plan.build", "plan.upgrade", "serve.dispatch",
         "wisdom.write.crash", "tune.measure", "exec.output")


class InjectedFault(RuntimeError):
    """A scripted fault fired at a named site."""

    def __init__(self, site: str, key: str = "", index: int = 0):
        super().__init__(f"injected fault at {site}"
                         + (f" [{key}]" if key else "") + f" #{index}")
        self.site = site
        self.key = key
        self.index = index


class TransientFault(InjectedFault):
    """A retryable fault: the dispatch retry loop may re-attempt."""


class CrashMidWrite(InjectedFault):
    """The process 'dies' between temp-write and atomic rename."""


_KIND_EXC = {"error": InjectedFault, "transient": TransientFault,
             "crash": CrashMidWrite, "nan": InjectedFault}
KINDS = tuple(_KIND_EXC)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted failure: where, when, what, and to whom.

    ``times`` are 0-based indices into the stream of *this spec's
    matching invocations* of ``site`` (``match`` filters first, then the
    index counts) — ``None`` means every matching invocation fires.
    ``kind`` picks the failure mode: "error" (InjectedFault), "transient"
    (TransientFault, retryable), "crash" (CrashMidWrite), "nan" (value
    poisoning — only meaningful at ``corrupt`` sites).
    """

    site: str
    times: Optional[tuple] = None
    kind: str = "error"
    match: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _KIND_EXC:
            raise ValueError(f"kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.times is not None:
            object.__setattr__(self, "times",
                               tuple(int(t) for t in self.times))


class FaultPlan:
    """A set of :class:`FaultSpec`\\ s plus exact firing bookkeeping.

    Thread-safe: the serve worker, upgrade threads and client threads
    may all consult sites concurrently; per-spec invocation counters and
    the fired log are guarded by one lock (sites with no spec never take
    it).
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._by_site: dict[str, list[tuple[int, FaultSpec]]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append((i, s))
        self._spec_counts: dict[int, int] = {}
        #: (site, key, index, kind) tuples, in firing order
        self.fired: list[tuple] = []
        self._lock = threading.Lock()

    def check(self, site: str, key: str = "") -> Optional[tuple]:
        """Count one invocation of ``site``; return ``(spec, index)`` if
        a spec fires on it, else None.  Sites with no spec return None
        without taking the lock (zero bookkeeping off-script)."""
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            for spec_id, spec in specs:
                if spec.match is not None and spec.match not in key:
                    continue
                idx = self._spec_counts.get(spec_id, 0)
                self._spec_counts[spec_id] = idx + 1
                if spec.times is not None and idx not in spec.times:
                    continue
                self.fired.append((site, key, idx, spec.kind))
                return spec, idx
        return None

    def fired_counts(self) -> dict:
        """Observed firings per site — what a chaos gate diffs against
        :meth:`predicted_counts`."""
        out: dict[str, int] = {}
        with self._lock:
            for site, _key, _idx, _kind in self.fired:
                out[site] = out.get(site, 0) + 1
        return out

    def predicted_counts(self) -> dict:
        """Scripted firings per site (specs with ``times=None`` fire an
        input-dependent number of times and predict ``None``)."""
        out: dict = {}
        for s in self.specs:
            if s.times is None or out.get(s.site, 0) is None:
                out[s.site] = None
            else:
                out[s.site] = out.get(s.site, 0) + len(s.times)
        return out


def seeded_times(seed: int, site: str, n_invocations: int,
                 n_faults: int) -> tuple:
    """Deterministically pick ``n_faults`` firing indices out of
    ``n_invocations`` from ``(seed, site)`` — the bench computes its
    prediction from the same call it builds the script with."""
    rng = random.Random(f"{int(seed)}:{site}")
    return tuple(sorted(rng.sample(range(n_invocations), n_faults)))


# -- module slot (mirrors obs.tracer's global-tracer pattern) ---------------

_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def get_plan() -> Optional[FaultPlan]:
    return _plan


def install(plan: Optional[FaultPlan]) -> None:
    global _plan
    with _plan_lock:
        _plan = plan


def clear() -> None:
    install(None)


@contextlib.contextmanager
def injection(specs_or_plan, seed: int = 0):
    """Arm a fault plan for the scope; always disarms on exit."""
    plan = (specs_or_plan if isinstance(specs_or_plan, FaultPlan)
            else FaultPlan(specs_or_plan, seed=seed))
    install(plan)
    try:
        yield plan
    finally:
        clear()


def _count(site: str) -> None:
    # lazy import: inject must be importable from anywhere (core included)
    # without dragging repro_torch.obs in at module-import time
    from repro_torch.obs import metrics as metrics_lib
    reg = metrics_lib.get_registry()
    reg.counter("faults_injected").inc()
    reg.counter("fault_" + site.replace(".", "_")).inc()


def fire(site: str, key: str = "") -> None:
    """Raising site: no-op unless an armed spec matches this invocation,
    in which case the spec's exception type is raised."""
    plan = _plan
    if plan is None:
        return
    hit = plan.check(site, str(key))
    if hit is None:
        return
    spec, idx = hit
    _count(site)
    raise _KIND_EXC[spec.kind](site, str(key), idx)


def corrupt(site: str, key: str = "") -> bool:
    """Value-poisoning site: True when the armed plan says this
    invocation's output should be corrupted (the call site applies the
    poison — e.g. a NaN multiply at trace time)."""
    plan = _plan
    if plan is None:
        return False
    hit = plan.check(site, str(key))
    if hit is None:
        return False
    _count(site)
    return True
