"""Plan cache — FFTW's planner-in-production, fronting ``repro_torch.tuning``.

Port of ``repro/serve/plan_cache.py``.  The serving story for plan
selection:

  cold   the FIRST request of a problem key builds its plan with
         ``mode="wisdom"`` — a stored plan if the wisdom file has one,
         otherwise the zero-execution analytic model (FFTW ESTIMATE).
         Nothing is ever timed on the request path.
  warm   once a key turns hot (``measure_after`` dispatches), the cache
         re-plans it with ``mode="measure"`` (FFTW PATIENT) and
         atomically merges the measured winner into the wisdom store
         (``tuning.upgrade_wisdom``).  The cache swaps the measured plan
         in; every later process starts warm from wisdom.
  hit    every other request reuses the cached plan.

Hygiene: shape diversity is the production hazard — every distinct
(shape, dtype, problem) holds its own plan and, once differentiated, its
autograd plans (``repro_torch.grad.vjp``).  The cache is LRU-capped at
``max_plans``; eviction calls ``Croft3D.release()``, so the live set
tracks the working set.

With a mesh every rank holds a cache and calls it in the same order
(the plans' collectives run on every rank).  A measured upgrade races
candidates with collectives, so it runs synchronously, inside the
``get`` that arms it, on every rank at once (the reference runs it on a
background thread).
``control`` (set by a meshed ``TransformService``) makes the fault
decisions of one rank everyone's: an injected ``plan.build`` or
``plan.upgrade`` fault is decided on rank 0 and broadcast before any
collective it affects, and a build or upgrade that fails on any rank
fails on all of them, so every rank walks the same ladder rung.  A
kernel that does not build or launch (:class:`~repro_torch.kernels.
KernelError`) is no plan failure: it never counts toward quarantine,
never walks the ladder and never rolls an upgrade back — it is raised,
on every rank, to the service, which stops.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import tracer as tracer_lib
from repro_torch.resil import degrade as degrade_lib
from repro_torch.resil import inject as inject_lib

# what one step of a build or an upgrade agrees on, across the ranks
_OK, _FAILED, _KERNEL = 0, 1, 2


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    from repro_torch.tuning.wisdom import dtype_name
    return getattr(torch, dtype_name(dtype))


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    upgrades: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "upgrades": self.upgrades,
                "hit_rate": round(self.hit_rate, 4)}


@dataclasses.dataclass
class CachedPlan:
    """A cached ``Croft3D`` plus its serving lifecycle state."""

    plan: object                 # Croft3D
    key: str
    state: str                   # "cold" (model/wisdom-model) | "warm"
    hits: int = 0
    last_used: int = 0           # monotonic use counter (LRU order)
    upgrading: bool = False
    #: degradation-ladder rung serving this key ("primary" = tuner pick;
    #: see repro_torch.resil.degrade.RUNGS)
    rung: str = "primary"
    #: consecutive dispatch failures on this entry; at
    #: PlanCache.quarantine_after the entry is quarantined and the
    #: bucket re-routes to the next rung down
    failures: int = 0
    #: failed measurement upgrades; capped at upgrade_max_retries
    upgrade_failures: int = 0
    #: a quarantined key never re-arms the measurement upgrade (the
    #: measured winner is the plan that just got it quarantined)
    quarantined: bool = False

    @property
    def plan_token(self) -> str:
        """The plan's pipeline identity (searched plans included) — what
        batch-compatibility bucketing must key on, since two plans for
        the same wisdom key stop being batchable the moment an upgrade
        swaps a searched pipeline in under one of them."""
        if self.plan.mesh is None:
            return self.key  # meshless plans carry no candidate identity
        return self.plan.candidate().plan_key


class PlanCache:
    """LRU plan cache keyed by the wisdom problem key.

    ``mesh=None`` serves single-device plans on ``device`` (the card
    unless the caller passes ``device="cpu"``; nothing to tune, and every
    plan is built directly and stays "warm" — there is no better plan to
    measure).  With a mesh, plans come from the tuner: cold =
    wisdom-or-model, and ``measure_after=N`` arms the measurement upgrade
    after N dispatches of a key.  The upgrade runs in the ``get`` that
    arms it (the reference runs it on a thread of its own): its race's
    collectives would otherwise interleave with the dispatches' on the
    same process groups.
    """

    def __init__(self, mesh=None, *, device=None, max_plans: int = 16,
                 wisdom_path: Optional[str] = None,
                 measure_after: Optional[int] = None,
                 tune_kw: Optional[dict] = None,
                 registry: Optional[metrics_lib.MetricsRegistry] = None,
                 quarantine_after: int = 3,
                 upgrade_max_retries: int = 2):
        if max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        if quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.max_plans = max_plans
        self.wisdom_path = wisdom_path
        self.measure_after = measure_after
        self.quarantine_after = quarantine_after
        self.upgrade_max_retries = upgrade_max_retries
        self.tune_kw = dict(tune_kw or {})
        #: a meshed service's control channel (``service._Control``), or
        #: None: each rank then decides its own injected faults
        self.control = None
        self.stats = CacheStats()
        # lifecycle counters mirror CacheStats into the metrics registry
        # (the service passes its own registry in; standalone caches get
        # a private one so two caches never mix counts)
        self.registry = registry if registry is not None \
            else metrics_lib.MetricsRegistry()
        self._plans: dict[str, CachedPlan] = {}
        self._clock = 0
        self._lock = threading.RLock()

    # -- decisions every rank shares -----------------------------------------
    def _fire(self, site: str, key: str) -> None:
        if self.control is None:
            inject_lib.fire(site, key)
        else:
            self.control.fire(site, key)

    def _settle(self, err: Optional[BaseException]) -> bool:
        """Agree on one step of a build or an upgrade: True when it
        succeeded on every rank.  A :class:`KernelError` on any rank is
        raised on every rank — the rank's own where it struck."""
        from repro_torch.kernels import KernelError
        code = (_OK if err is None else
                _KERNEL if isinstance(err, KernelError) else _FAILED)
        if self.control is not None:
            code = self.control.worst(code)
        if code == _KERNEL:
            if isinstance(err, KernelError):
                raise err
            raise KernelError("a kernel failed on another rank")
        return code == _OK

    # -- keys ---------------------------------------------------------------
    def key_for(self, shape, dtype, problem: str) -> str:
        """The wisdom key this (shape, dtype, problem) plans under — the
        same string the tuner reads/writes, so cache misses warm-start
        from whatever wisdom previous runs persisted.  Its backend field
        is ``"local"`` without a mesh, else the mesh's (``"gpu"`` on the
        card, ``"cpu"`` on CPU tensors)."""
        from repro_torch.tuning.wisdom import backend_of, wisdom_key
        if self.mesh is None:
            return wisdom_key(shape, {}, dtype, "local", problem)
        return wisdom_key(shape, dict(self.mesh.shape), dtype,
                          backend_of(self.mesh), problem)

    def token_for(self, shape, dtype, problem: str) -> str:
        """Batch-bucket token for (shape, dtype, problem): the wisdom key
        while the plan is unbuilt (cold requests for one key can always
        bucket together — they will share whatever plan the miss builds),
        extended with the built plan's pipeline token afterwards.  The
        wisdom-key prefix keeps shape/dtype separation; the plan-token
        suffix splits buckets when an upgrade swaps in a different
        pipeline (e.g. a searched schedule), since requests stacked into
        one batched call must share one plan."""
        key = self.key_for(shape, dtype, problem)
        with self._lock:
            cp = self._plans.get(key)
        if cp is None:
            return key
        return f"{key}@{cp.plan_token}"

    # -- lookup/build -------------------------------------------------------
    def get(self, shape, dtype=torch.complex64, problem: str = "c2c"
            ) -> CachedPlan:
        """The plan for (shape, dtype, problem): cached, or built cold."""
        key = self.key_for(shape, dtype, problem)
        with self._lock:
            cp = self._plans.get(key)
            if cp is not None:
                self.stats.hits += 1
                self.registry.counter("plan_cache_hits").inc()
                tracer_lib.get_tracer().instant(
                    "plan:hit", "plan", {"key": key, "state": cp.state})
                self._touch(cp)
                self._maybe_upgrade(cp)
                return cp
            self.stats.misses += 1
            self.registry.counter("plan_cache_misses").inc()
            with tracer_lib.get_tracer().span("plan:build", "plan",
                                              key=key):
                cp = self._build(key, tuple(shape), torch_dtype(dtype),
                                 problem)
            self._plans[key] = cp
            self._touch(cp)
            # _evict_lru returns False when every other plan is mid-upgrade
            # (upgrading plans are pinned); bail rather than spin — the
            # upgrade threads need this lock to finish, so looping here
            # would livelock the worker.  Temporary over-capacity drains
            # on the next miss once upgrades land.
            while (len(self._plans) > self.max_plans
                   and self._evict_lru(keep=key)):
                pass
            return cp

    def _touch(self, cp: CachedPlan) -> None:
        self._clock += 1
        cp.last_used = self._clock
        cp.hits += 1

    def _build(self, key: str, shape, dtype, problem: str) -> CachedPlan:
        cp = err = None
        try:
            self._fire("plan.build", key)
            cp = self._build_primary(key, shape, dtype, problem)
        except Exception as e:
            err = e  # handled below, on every rank alike
        try:
            if self._settle(err):
                return cp
        except Exception:
            if cp is not None:
                cp.plan.release()
            raise
        # a failed build must not fail the request if any ladder rung
        # below the tuner's pick still builds (repro_torch.resil.degrade);
        # _build_fallback re-raises when nothing does
        if cp is not None:
            cp.plan.release()  # built here, failed on another rank
        self.registry.counter("plan_build_failures").inc()
        tracer_lib.get_tracer().instant("plan:build-fail", "plan",
                                        {"key": key})
        cp = self._build_fallback(key, shape, dtype, problem)
        self.registry.counter("plan_build_fallbacks").inc()
        tracer_lib.get_tracer().instant(
            "plan:build-fallback", "plan", {"key": key, "rung": cp.rung})
        return cp

    def _build_primary(self, key: str, shape, dtype,
                       problem: str) -> CachedPlan:
        from repro_torch.core.api import Croft3D
        if self.mesh is None:
            # single device: nothing to tune, and nothing to upgrade to
            plan = Croft3D(shape, dtype=dtype, problem=problem,
                           device=self.device)
            return CachedPlan(plan=plan, key=key, state="warm")
        plan = Croft3D.tuned(shape, self.mesh, mode="wisdom",
                             wisdom_path=self.wisdom_path, dtype=dtype,
                             problem=problem, **self.tune_kw)
        measured = (plan.tune_result is not None
                    and plan.tune_result.measured_s is not None)
        return CachedPlan(plan=plan, key=key,
                          state="warm" if measured else "cold")

    def _build_fallback(self, key: str, shape, dtype,
                        problem: str) -> CachedPlan:
        from repro_torch.core.api import Croft3D
        err = None
        try:
            if self.mesh is None:
                # the plain meshless plan IS the bottom rung; retry it
                plan = Croft3D(shape, dtype=dtype, problem=problem,
                               device=self.device)
                cp = CachedPlan(plan=plan, key=key, state="warm",
                                rung="default")
            else:
                cand = degrade_lib.bottom_candidate(
                    shape, dict(self.mesh.shape), problem)
                if cand is None:
                    raise RuntimeError(f"no fallback plan for {key}: even "
                                       "the default decomposition is "
                                       "invalid")
                plan = Croft3D(shape, self.mesh, cand.decomp, cand.opts,
                               dtype=dtype, problem=problem,
                               strategy=getattr(cand, "strategy", None))
                cp = CachedPlan(plan=plan, key=key, state="cold",
                                rung="default")
        except Exception as e:
            err = e
        try:
            ok = self._settle(err)
        except Exception:
            if err is None:
                cp.plan.release()
            raise
        if not ok:
            if err is not None:
                raise err
            cp.plan.release()
            raise RuntimeError(f"no fallback plan for {key}: the default "
                               "plan failed to build on another rank")
        return cp

    def _evict_lru(self, keep: str) -> bool:
        """Evict the LRU evictable plan; False if none is evictable."""
        victims = [cp for cp in self._plans.values()
                   if cp.key != keep and not cp.upgrading]
        if not victims:
            return False
        victim = min(victims, key=lambda cp: cp.last_used)
        del self._plans[victim.key]
        self.stats.evictions += 1
        self.registry.counter("plan_cache_evictions").inc()
        tracer_lib.get_tracer().instant(
            "plan:evict", "plan", {"key": victim.key, "hits": victim.hits})
        victim.plan.release()  # drop its autograd plans
        return True

    # -- failure reporting and quarantine ----------------------------------
    def report_dispatch_failure(self, key: str) -> Optional[CachedPlan]:
        """One dispatch on ``key``'s plan failed (after retries).  At
        ``quarantine_after`` consecutive failures the entry is
        quarantined: the next ladder rung is built and swapped in, its
        plan token re-routes the bucket, and the failure counter resets
        so the *new* rung gets its own budget before walking further
        down.  Returns the (possibly replaced) entry.  On a mesh every
        rank reports the same failures (a meshed service sends them)."""
        with self._lock:
            cp = self._plans.get(key)
            if cp is None:
                return None
            cp.failures += 1
            self.registry.counter("plan_dispatch_failures").inc()
            if cp.failures < self.quarantine_after:
                return cp
            return self._quarantine(cp)

    def _quarantine(self, cp: CachedPlan) -> CachedPlan:
        """Swap ``cp`` for the first ladder rung below it that builds (on
        every rank).  Caller holds the lock."""
        self.registry.counter("plan_quarantines").inc()
        tracer_lib.get_tracer().instant(
            "plan:quarantine", "plan",
            {"key": cp.key, "rung": cp.rung, "failures": cp.failures})
        for rung, cand in degrade_lib.ladder(cp.plan):
            plan = err = None
            try:
                plan = degrade_lib.build_plan(cp.plan, cand)
            except Exception as e:
                err = e  # this rung does not build; every rank walks down
            try:
                ok = self._settle(err)
            except Exception:
                if plan is not None:
                    plan.release()
                raise
            if not ok:
                if plan is not None:
                    plan.release()
                continue
            new = CachedPlan(plan=plan, key=cp.key, state="cold",
                             hits=cp.hits, last_used=cp.last_used,
                             rung=rung, quarantined=True,
                             upgrade_failures=cp.upgrade_failures)
            self._plans[cp.key] = new
            self.registry.counter("plan_degradations").inc()
            tracer_lib.get_tracer().instant(
                "plan:degrade", "plan", {"key": cp.key, "rung": rung,
                                         "plan": cand.label})
            if cp.plan is not plan and not cp.upgrading:
                cp.plan.release()
            return new
        # bottom of the ladder (or meshless): keep serving the entry;
        # callers keep seeing failures rather than a silent swallow
        self.registry.counter("plan_degrade_exhausted").inc()
        cp.failures = 0  # one quarantine event per quarantine_after burst
        return cp

    # -- measurement upgrade ------------------------------------------------
    def _maybe_upgrade(self, cp: CachedPlan) -> None:
        if (self.measure_after is None or self.mesh is None
                or cp.state != "cold" or cp.upgrading or cp.quarantined
                or cp.upgrade_failures >= self.upgrade_max_retries
                or cp.hits < self.measure_after):
            return
        cp.upgrading = True
        self.registry.counter("plan_cache_upgrade_starts").inc()
        tracer_lib.get_tracer().instant(
            "plan:upgrade-start", "plan", {"key": cp.key, "hits": cp.hits})
        self._upgrade(cp)

    def _upgrade(self, cp: CachedPlan) -> None:
        """Measure-mode re-plan of a hot key.

        Builds and times the model-ranked top candidates on the live
        mesh, merges the winner into the wisdom store (atomic, locked —
        see ``tuning.wisdom.merge_entries``), and swaps the measured plan
        into the cache — on every rank, or on none when it failed on
        any.  A kernel failure is raised instead (the tuner raises it on
        every rank): the entry keeps its plan and its retry budget.
        """
        from repro_torch.core.api import Croft3D
        tracer = tracer_lib.get_tracer()
        plan = result = err = None
        try:
            with tracer.span("plan:upgrade", "plan", key=cp.key):
                self._fire("plan.upgrade", cp.key)
                from repro_torch import tuning
                result = tuning.upgrade_wisdom(
                    cp.plan.shape, self.mesh, dtype=cp.plan.dtype,
                    problem=cp.plan.problem, wisdom_path=self.wisdom_path,
                    **self.tune_kw)
                plan = Croft3D(cp.plan.shape, self.mesh, result.decomp,
                               result.opts, dtype=cp.plan.dtype,
                               problem=cp.plan.problem,
                               strategy=result.strategy,
                               schedule=result.schedule)
                plan.tune_result = result
        except Exception as e:
            err, plan = e, None
        try:
            ok = self._settle(err)
        except Exception:
            cp.upgrading = False
            raise
        if ok:
            with self._lock:
                old = self._plans.get(cp.key)
                new = CachedPlan(plan=plan, key=cp.key, state="warm",
                                 hits=cp.hits, last_used=cp.last_used)
                self._plans[cp.key] = new
                self.stats.upgrades += 1
                self.registry.counter("plan_cache_upgrades").inc()
                if old is not None and old.plan is not plan:
                    old.plan.release()
            tracer.instant("plan:upgrade-win", "plan",
                           {"key": cp.key, "plan": result.summary()})
            return
        # an upgrade failure must never take the service down: roll the
        # *current* map entry (cp may be stale if something swapped it
        # meanwhile) back to its servable cold state, and cap retries — a
        # deterministically failing measure mode must not re-arm on every
        # Nth hit forever
        if plan is not None:
            plan.release()  # measured here, failed on another rank
        tracer.instant("plan:upgrade-fail", "plan", {"key": cp.key})
        self.registry.counter("serve_upgrade_failures").inc()
        with self._lock:
            cp.upgrading = False
            cp.upgrade_failures += 1
            cur = self._plans.get(cp.key)
            if cur is not None and cur is not cp:
                cur.upgrading = False
                cur.upgrade_failures += 1

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """True: no upgrade runs in the background here (each runs inside
        the ``get`` that arms it).  Kept for the reference's API."""
        del timeout
        return True

    def alive_upgrades(self) -> int:
        """0: no upgrade thread outlives its ``get``.  Kept for the
        reference's API."""
        return 0

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._plans)

    def snapshot(self) -> dict:
        """Stats + per-key lifecycle state, for logs and reports."""
        with self._lock:
            return {
                "stats": self.stats.as_dict(),
                "plans": {k: {"state": cp.state, "hits": cp.hits,
                              "rung": cp.rung, "failures": cp.failures,
                              "quarantined": cp.quarantined}
                          for k, cp in self._plans.items()},
            }
