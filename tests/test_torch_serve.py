"""The port's transform service (``repro_torch.serve``, with
``resil.degrade`` and ``train.fault.PreemptionHandler``) against the
reference's (``repro.serve``), meshless, on the CPU.

* Host policy: ``padded_size``, ``stack_and_pad``, ``bucket_key``,
  request validation and every ``Batcher`` decision (under an injected
  clock) equal the reference's for the same adds.
* Keys: ``PlanCache.key_for``/``token_for`` equal the reference's (the
  backend field is ``"local"`` meshless in both, ``"cpu"`` for a CPU
  mesh); the degradation ladder's rungs and ``plan_key``\\ s are
  byte-equal on the same axis sizes.
* Results: every served result matches the reference plan's on the same
  numpy input, within the reference tests' tolerances relative to
  max|ref| (c2c 5e-4, tests/test_kernels_fft.py:78; r2c 5e-5,
  tests/test_real_fft.py:160; filtered 1e-5, tests/test_kernels_fft.py:68),
  and is bitwise equal to the port's direct (unbatched) call — every
  local impl is batch-invariant on the CPU (``test_batched_is_bitwise``).
* Resilience (tests/test_resil.py:126-300): each request-lifecycle
  scenario runs through both packages and must meet the reference
  test's expected counters in both.
"""

import concurrent.futures
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import resil as ref_resil
from repro import serve as ref_serve
from repro.core import Croft3D as RefCroft3D
from repro.resil import degrade as ref_degrade
from repro.serve import service as ref_service_mod
from repro.train import fault as ref_fault
from repro.tuning import candidates as ref_cand
from repro_torch import resil, serve
from repro_torch.core import Croft3D, FFTOptions
from repro_torch.core import schedule as schedule_lib
from repro_torch.resil import degrade
from repro_torch.serve import service as service_mod
from repro_torch.train import fault
from repro_torch.tuning import candidates as cand_lib

N = 8
C2C_TOL = 5e-4     # tests/test_kernels_fft.py:78
R2C_TOL = 5e-5     # tests/test_real_fft.py:160
FILT_TOL = 1e-5    # tests/test_kernels_fft.py:68


def _cplx(rng, n=N):
    return (rng.randn(n, n, n) + 1j * rng.randn(n, n, n)).astype(np.complex64)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- batching policy --------------------------------------------------------

@pytest.mark.parametrize("n,max_batch", [(n, m) for m in (1, 4, 8)
                                         for n in range(0, m + 2)])
def test_padded_size_matches_reference(n, max_batch):
    try:
        want = ref_serve.padded_size(n, max_batch)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            serve.padded_size(n, max_batch)
        return
    assert serve.padded_size(n, max_batch) == want


@pytest.mark.parametrize("rows,pad", [(1, 1), (3, 4), (4, 4), (5, 8)])
def test_stack_and_pad_matches_reference(rows, pad):
    rng = np.random.RandomState(rows)
    arrays = [_cplx(rng) for _ in range(rows)]
    want = ref_serve.stack_and_pad(arrays, pad)
    got = serve.stack_and_pad(arrays, pad)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # into a preallocated buffer (the service's pinned stack), its dtype
    out = np.full((pad, N, N, N), np.nan + 1j, np.complex64)
    assert serve.stack_and_pad(arrays, pad, out=out) is out
    assert np.array_equal(out, want)


class _Item:
    """A pending item with the two fields the batcher reads."""

    def __init__(self, priority, req_id):
        self.req = types.SimpleNamespace(priority=priority, req_id=req_id)


# (op, key, now, priority): "add" a request, "pop" ready buckets, "shed"
# the lowest, "next" deadline, "all" drain
SCRIPTS = {
    "full-or-expired": (2, 10.0, [
        ("add", "k1", 0.0, 1), ("pop", None, 0.1, None),
        ("add", "k1", 0.2, 1), ("pop", None, 0.3, None),
        ("add", "k2", 1.0, 1), ("pop", None, 5.0, None),
        ("pop", None, 11.5, None), ("add", "k3", 20.0, 1),
        ("next", None, 25.0, None), ("all", None, None, None)]),
    "priorities": (4, 1.0, [
        ("add", "lo", 0.0, 2), ("add", "hi", 0.1, 0), ("add", "mid", 0.2, 1),
        ("add", "lo", 0.3, 2), ("next", None, 0.5, None),
        ("shed", None, None, None), ("shed", None, None, None),
        ("pop", None, 2.0, None), ("shed", None, None, None)]),
    "shed-newest-first": (8, 100.0, [
        ("add", "a", 0.0, 1), ("add", "b", 0.0, 1), ("add", "a", 0.0, 1),
        ("add", "c", 0.0, 0), ("shed", None, None, None),
        ("shed", None, None, None), ("next", None, 50.0, None),
        ("all", None, None, None), ("shed", None, None, None),
        ("next", None, 60.0, None)]),
    "many-buckets": (3, 0.5, [
        ("add", f"k{i % 4}", 0.1 * i, i % 3) for i in range(14)]
        + [("pop", None, 0.7, None), ("pop", None, 1.0, None),
           ("pop", None, 3.0, None)]),
}


def _replay(mod, max_batch, wait, script) -> list:
    b = mod.Batcher(max_batch=max_batch, max_wait_s=wait)
    log, ids = [], iter(range(1000))

    def ids_of(bucket):
        return [it.req.req_id for it in bucket.requests]

    for op, key, now, prio in script:
        if op == "add":
            b.add(key, _Item(prio, next(ids)), now=now)
        elif op == "pop":
            log.append([(x.key, x.reason, ids_of(x))
                        for x in b.pop_ready(now=now)])
        elif op == "shed":
            it = b.shed_lowest()
            log.append(None if it is None else it.req.req_id)
        elif op == "next":
            log.append(b.next_deadline(now=now))
        else:
            log.append([(x.key, x.reason, ids_of(x)) for x in b.pop_all()])
        log.append(b.pending)
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_batcher_decisions_match_reference(name):
    max_batch, wait, script = SCRIPTS[name]
    assert (_replay(serve, max_batch, wait, script)
            == _replay(ref_serve, max_batch, wait, script))


# --- requests and bucket keys -----------------------------------------------

def _bad_requests(x):
    xr = np.abs(x).real.astype(np.float32)
    return {
        "problem": dict(x=x, problem="dct"),
        "no-filter": dict(x=x, problem="filtered"),
        "filtered-inverse": dict(x=x, problem="filtered", h=x,
                                 direction="inverse"),
        "stray-filter": dict(x=x, h=x),
        "direction": dict(x=x, direction="sideways"),
        "r2c-inverse-shape": dict(x=x[:, :, :5], problem="r2c",
                                  direction="inverse"),
        "rank-2": dict(x=x[0]),
        "shape-2d": dict(x=x, shape=(N, N)),
        "priority": dict(x=x, priority=-1),
        "deadline": dict(x=x, deadline_s=-1.0),
        "complex-r2c": dict(x=x, problem="r2c"),
        "payload-shape": dict(x=x[:, :, :5], shape=(N, N, N)),
        "filter-shape": dict(x=x, problem="filtered", h=x[:, :, :5]),
        "ok-filtered-real-x": dict(x=xr, problem="filtered", h=x),
        "ok-r2c": dict(x=xr, problem="r2c"),
        "ok-r2c-inverse": dict(x=x[:, :, :N // 2 + 1], problem="r2c",
                               direction="inverse", shape=(N, N, N)),
        "ok-filtered": dict(x=x, problem="filtered", h=x),
    }


@pytest.mark.parametrize("case", sorted(_bad_requests(np.zeros((1, 1, 1)))))
def test_request_validation_matches_reference(case):
    """The same request is accepted, or refused with the same message, at
    construction or at ``validate_payload``."""
    x = _cplx(np.random.RandomState(0))
    kw = _bad_requests(x)[case]

    def outcome(mod):
        try:
            req = mod.TransformRequest(**kw)
            req.validate_payload()
        except ValueError as e:
            return "refused", str(e)
        return ("ok", req.shape, req.dtype, req.plan_problem,
                req.expected_payload_shape(), req.payload_finite())

    got, want = outcome(serve), outcome(ref_serve)
    assert got == want
    assert (got[0] == "ok") == case.startswith("ok")


def test_request_dtype_takes_torch_and_numpy():
    x = _cplx(np.random.RandomState(0))
    keys = set()
    for dt in (np.complex64, "complex64", torch.complex64):
        req = serve.TransformRequest(x=x, dtype=dt)
        assert req.dtype == np.dtype(np.complex64)
        cache = serve.PlanCache(device="cpu")
        keys.add(cache.key_for(req.shape, dt, req.plan_problem))
    assert len(keys) == 1
    assert (serve.TransformRequest(x=x, dtype=torch.complex128).dtype
            == np.dtype(np.complex128))


def test_bucket_key_matches_reference():
    x = _cplx(np.random.RandomState(0))
    for kw in (dict(), dict(direction="inverse"),
               dict(problem="filtered", h=x)):
        assert (serve.bucket_key(serve.TransformRequest(x=x, **kw), "plan")
                == ref_serve.bucket_key(ref_serve.TransformRequest(x=x, **kw),
                                        "plan"))
    keys = {serve.bucket_key(serve.TransformRequest(x=x, **kw), "plan")
            for kw in (dict(), dict(direction="inverse"),
                       dict(problem="filtered", h=x))}
    assert len(keys) == 3


# --- plan cache: keys, hits, LRU --------------------------------------------

class _FakeMesh:
    """What the caches read of a mesh for their keys."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.size = int(np.prod(list(sizes.values())))
        self.device = torch.device("cpu")


KEY_CASES = [((8, 8, 8), np.complex64, "c2c"), ((8, 8, 8), np.complex64, "r2c"),
             ((8, 8, 8), np.complex128, "c2c"), ((8, 8, 16), np.complex64, "c2c"),
             ((16, 8, 4), np.complex128, "r2c")]


@pytest.mark.parametrize("sizes", [None, {"y": 2, "z": 2}, {"p": 4},
                                   {"a": 2, "b": 2, "c": 2}])
def test_plan_cache_keys_match_reference(sizes):
    mesh = None if sizes is None else _FakeMesh(sizes)
    port = (serve.PlanCache(device="cpu") if mesh is None
            else serve.PlanCache(mesh))
    ref = ref_serve.PlanCache(mesh)
    for shape, dt, problem in KEY_CASES:
        assert port.key_for(shape, dt, problem) \
            == ref.key_for(shape, dt, problem)
        assert port.token_for(shape, dt, problem) \
            == ref.token_for(shape, dt, problem)
    want = "|local" if mesh is None else "|cpu"
    assert port.key_for((8, 8, 8), np.complex64, "c2c").endswith(want)


def test_plan_cache_tokens_after_build_match_reference():
    port, ref = serve.PlanCache(device="cpu"), ref_serve.PlanCache()
    for shape, dt, problem in KEY_CASES[:3]:
        port.get(shape, dt, problem)
        ref.get(shape, dt, problem)
        assert port.token_for(shape, dt, problem) \
            == ref.token_for(shape, dt, problem)


def test_plan_cache_hits_and_lru_eviction():
    cache = serve.PlanCache(max_plans=2, device="cpu")
    a = cache.get((8, 8, 8))
    assert cache.get((8, 8, 8)).plan is a.plan          # hit
    cache.get((16, 16, 16))
    cache.get((8, 8, 8))                                 # A now most recent
    cache.get((8, 8, 12))                                # evicts 16^3 (LRU)
    assert len(cache) == 2
    assert cache.stats.evictions == 1
    assert cache.key_for((16, 16, 16), np.complex64, "c2c") not in cache.keys()
    assert cache.key_for((8, 8, 8), np.complex64, "c2c") in cache.keys()
    # meshless plans are warm from birth: nothing to measure-upgrade
    assert all(cp["state"] == "warm"
               for cp in cache.snapshot()["plans"].values())
    assert a.plan.device == torch.device("cpu")


def test_plan_cache_over_capacity_does_not_livelock():
    """When every other plan is pinned by an in-flight upgrade, eviction
    must bail (temporary over-capacity) instead of spinning on the lock
    the upgrade threads need to finish."""
    cache = serve.PlanCache(max_plans=2, device="cpu")
    cache.get((8, 8, 8))
    cache.get((16, 16, 16))
    for cp in cache._plans.values():
        cp.upgrading = True  # simulate in-flight measurement upgrades
    done = []

    def miss():
        cache.get((8, 8, 12))
        done.append(True)

    t = threading.Thread(target=miss, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert done, "plan-cache eviction livelocked with all plans upgrading"
    assert len(cache) == 3  # over capacity until upgrades land
    for cp in cache._plans.values():
        cp.upgrading = False
    cache.get((8, 8, 16))  # next miss drains the excess
    assert len(cache) == 2


def test_plan_cache_refuses_async_upgrades_on_a_mesh():
    """The port has no background upgrade: it runs inside the ``get``
    that arms it (its race's collectives would otherwise interleave with
    the dispatches'), so there is no option to ask for one, and nothing
    is ever left for ``wait_idle`` to join."""
    with pytest.raises(TypeError, match="upgrade_async"):
        serve.PlanCache(_FakeMesh({"y": 2, "z": 2}), upgrade_async=True)
    for cache in (serve.PlanCache(_FakeMesh({"y": 2, "z": 2})),
                  serve.PlanCache(device="cpu")):
        assert cache.wait_idle(timeout=0.0) is True
        assert cache.alive_upgrades() == 0


# --- degradation ladder ------------------------------------------------------

LADDER_MESHES = {"pencil": {"y": 2, "z": 2}, "slab": {"p": 4},
                 "cell": {"a": 2, "b": 2, "c": 2}}


def _walk(mod, cand, shape, sizes) -> list:
    out = []
    while True:
        step = mod.next_rung(cand, shape, sizes)
        if step is None:
            return out
        out.append((step[0], step[1].plan_key))
        cand = step[1]


@pytest.mark.parametrize("kind", sorted(LADDER_MESHES))
@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_degrade_ladders_match_reference(kind, problem):
    """From every candidate of the search space (and, for c2c, every
    searched schedule), the rungs below it are the reference's, byte for
    byte."""
    sizes, shape = LADDER_MESHES[kind], (16, 16, 16)
    cands = cand_lib.enumerate_candidates(shape, sizes, problem=problem)
    refs = ref_cand.enumerate_candidates(shape, sizes, problem=problem)
    if problem == "c2c" and kind == "pencil":
        cands = list(cands) + list(cand_lib.enumerate_schedule_candidates(
            shape, sizes))[:24]
        refs = list(refs) + list(ref_cand.enumerate_schedule_candidates(
            shape, sizes))[:24]
    assert [c.plan_key for c in cands] == [c.plan_key for c in refs]
    assert cands
    for c, r in zip(cands, refs):
        assert _walk(degrade, c, shape, sizes) \
            == _walk(ref_degrade, r, shape, sizes)
        stub = types.SimpleNamespace(mesh=types.SimpleNamespace(shape=sizes),
                                     shape=shape)
        got = degrade.ladder(types.SimpleNamespace(
            **vars(stub), candidate=lambda c=c: c))
        want = ref_degrade.ladder(types.SimpleNamespace(
            **vars(stub), candidate=lambda r=r: r))
        assert [(n, x.plan_key) for n, x in got] \
            == [(n, x.plan_key) for n, x in want]


@pytest.mark.parametrize("shape,sizes", [
    ((8, 8, 8), {"y": 2, "z": 2}), ((16, 16, 16), {"p": 4}),
    ((16, 16, 16), {"a": 2, "b": 2, "c": 2}), ((6, 6, 6), {"p": 4})])
@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_bottom_candidate_matches_reference(shape, sizes, problem):
    got = degrade.bottom_candidate(shape, sizes, problem)
    want = ref_degrade.bottom_candidate(shape, sizes, problem)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.plan_key == want.plan_key
        assert got.opts.transpose_impl == "alltoall"
        assert got.opts.overlap_k == 1
        assert problem == "c2c" or got.strategy == "embed"
    assert degrade.RUNGS == ref_degrade.RUNGS


def test_degrade_meshless_plan_has_no_ladder():
    assert degrade.ladder(Croft3D((N, N, N), device="cpu")) == []


# --- the executor's output-poisoning site -----------------------------------

class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _local_schedule():
    return schedule_lib.build_local_c2c(-1)


def test_exec_output_hook_costs_nothing_unarmed():
    """``run_schedule``'s ``exec.output`` site launches no op unless an
    armed spec matches (counted with a dispatch mode), and poisons the
    output when one does — on every call (the port runs eagerly)."""
    sched = _local_schedule()
    x = torch.from_numpy(_cplx(np.random.RandomState(0)))
    opts = FFTOptions(overlap_k=1)

    def run():
        with _OpCount() as c:
            y = schedule_lib.run_schedule(x, sched, opts, None)
        return c.ops, y

    run()  # warm the plan constants' cache
    bare, want = run()
    with resil.injection([resil.FaultSpec("exec.output",
                                          match="no-such-schedule")]):
        unmatched, y_un = run()
    assert unmatched == bare and torch.equal(y_un, want)
    assert torch.allclose(want, torch.fft.fftn(x), atol=1e-4)
    with resil.injection([resil.FaultSpec("exec.output", kind="nan",
                                          match="local/c2c")]) as plan:
        armed, y1 = run()
        _, y2 = run()
    assert armed > bare and torch.isnan(y1).all() and torch.isnan(y2).all()
    assert plan.fired_counts() == {"exec.output": 2}


# --- the meshless service against the reference -----------------------------

def _direct(plan, x, kind, h=None):
    t = torch.from_numpy(np.array(x))
    if kind == "filtered":
        return plan.forward_filtered(t, torch.from_numpy(h)).numpy()
    if kind == "inverse":
        return plan.inverse(t).numpy()
    return plan.forward(t).numpy()


def test_batched_is_bitwise():
    """Every local impl computes a (4, ...) stack bitwise like four
    single calls on the CPU — the property the service's bitwise
    assertions rest on."""
    rng = np.random.RandomState(5)
    for impl in ("matmul", "stockham", "xla", "pallas"):
        for problem in ("c2c", "r2c"):
            plan = Croft3D((N, N, N), device="cpu", problem=problem,
                           opts=FFTOptions(local_impl=impl))
            xs = (np.stack([_cplx(rng) for _ in range(4)]) if problem == "c2c"
                  else rng.randn(4, N, N, N).astype(np.float32))
            hs = np.stack([(rng.randn(*plan.spectrum_shape) + 0j)
                           .astype(np.complex64) for _ in range(4)])
            yb = plan.forward_batched(torch.from_numpy(xs))
            assert torch.equal(yb, torch.stack(
                [plan.forward(torch.from_numpy(x)) for x in xs]))
            assert torch.equal(plan.inverse_batched(yb), torch.stack(
                [plan.inverse(y) for y in yb]))
            fb = plan.forward_filtered_batched(torch.from_numpy(xs),
                                               torch.from_numpy(hs))
            assert torch.equal(fb, torch.stack([plan.forward_filtered(
                torch.from_numpy(x), torch.from_numpy(h))
                for x, h in zip(xs, hs)]))


def test_service_concurrent_heterogeneous_matches_reference():
    """Interleaved c2c/r2c/filtered forward and inverse requests from
    concurrent clients: each result within the reference tests'
    tolerance of the reference plan's, and bitwise equal to the port's
    direct call."""
    rng = np.random.RandomState(0)
    xc, h = _cplx(rng), _cplx(rng)
    xr = rng.randn(N, N, N).astype(np.float32)
    ref_c, ref_r = RefCroft3D((N, N, N)), RefCroft3D((N, N, N), problem="r2c")
    spec_c = np.asarray(ref_c.forward(xc))
    spec_r = np.asarray(ref_r.forward(xr))
    plan_c = Croft3D((N, N, N), device="cpu")
    plan_r = Croft3D((N, N, N), problem="r2c", device="cpu")
    cases = {  # name: (submit kw, payload, reference, direct, tol)
        "c2c-fwd": (dict(), xc, spec_c, _direct(plan_c, xc, "fwd"), C2C_TOL),
        "c2c-inv": (dict(direction="inverse"), spec_c,
                    np.asarray(ref_c.inverse(spec_c)),
                    _direct(plan_c, spec_c, "inverse"), C2C_TOL),
        "r2c-fwd": (dict(problem="r2c"), xr, spec_r,
                    _direct(plan_r, xr, "fwd"), R2C_TOL),
        "r2c-inv": (dict(problem="r2c", direction="inverse",
                         shape=(N, N, N)), spec_r,
                    np.asarray(ref_r.inverse(spec_r)),
                    _direct(plan_r, spec_r, "inverse"), R2C_TOL),
        "filtered": (dict(problem="filtered", h=h), xc,
                     np.asarray(ref_c.forward_filtered(xc, h)),
                     _direct(plan_c, xc, "filtered", h), FILT_TOL),
    }
    failures = []

    def client(name, reps=3):
        kw, x, ref, direct, tol = cases[name]
        for _ in range(reps):
            got = svc.transform(x, **kw)
            if not np.array_equal(got, direct) or _rel(got, ref) >= tol:
                failures.append((name, _rel(got, ref),
                                 float(np.abs(got - direct).max())))

    with serve.TransformService(max_batch=4, max_wait_ms=2.0,
                                device="cpu") as svc:
        threads = [threading.Thread(target=client, args=(name,))
                   for name in cases for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        stats = svc.stats()
    assert not failures, failures
    assert stats["requests"] == 2 * 3 * len(cases)
    assert stats["pending"] == 0
    assert stats["batches"] < stats["requests"]  # something co-batched


def test_service_ragged_batch_pads_and_round_trips():
    """3 same-key requests coalesce into one dispatch padded to 4; the
    pad row never leaks into results."""
    rng = np.random.RandomState(1)
    xs = [_cplx(rng) for _ in range(3)]
    plan = Croft3D((N, N, N), device="cpu")
    ref = RefCroft3D((N, N, N))
    with serve.TransformService(max_batch=4, max_wait_ms=100.0,
                                device="cpu") as svc:
        futs = [svc.submit(x) for x in xs]
        results = [f.result(timeout=120) for f in futs]
    assert all(r.ok for r in results)
    for x, r in zip(xs, results):
        assert np.array_equal(r.value, _direct(plan, x, "fwd"))
        assert _rel(r.value, np.asarray(ref.forward(x))) < C2C_TOL
    assert {r.batch_size for r in results} == {3}
    assert {r.padded_size for r in results} == {4}
    assert {r.plan_key for r in results} == {
        ref_serve.PlanCache().key_for((N, N, N), np.complex64, "c2c")}


def test_service_stop_drains_pending():
    rng = np.random.RandomState(2)
    svc = serve.TransformService(max_batch=8, max_wait_ms=5000.0,
                                 device="cpu")
    svc.start()
    futs = [svc.submit(_cplx(rng)) for _ in range(3)]
    svc.stop(drain=True)  # wait budget far away: stop must still serve
    assert all(f.result(timeout=60).ok for f in futs)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(_cplx(rng))


def test_service_stop_without_drain_fails_pending():
    rng = np.random.RandomState(2)
    svc = serve.TransformService(max_batch=8, max_wait_ms=5000.0,
                                 device="cpu")
    svc.start()
    futs = [svc.submit(_cplx(rng)) for _ in range(3)]
    svc.stop(drain=False)
    results = [f.result(timeout=60) for f in futs]
    assert not any(r.ok for r in results)
    assert {r.error for r in results} == {"service stopped"}


def test_service_drain_chunks_oversized_buckets():
    """stop(drain=True) can inherit a same-key bucket larger than
    max_batch; it must chunk into max_batch-sized dispatches and serve
    every request, not fail them with a padded_size error."""
    rng = np.random.RandomState(4)
    xs = [_cplx(rng) for _ in range(5)]
    plan = Croft3D((N, N, N), device="cpu")
    svc = serve.TransformService(max_batch=2, max_wait_ms=5000.0,
                                 device="cpu")
    pendings = []
    for x in xs:  # straight to the queue, as if racing past the sentinel
        req = serve.TransformRequest(x=x)
        req.validate_payload()
        pendings.append(service_mod._Pending(
            req, concurrent.futures.Future()))
        svc._queue.put(pendings[-1])
    svc._drain_all()
    results = [p.future.result(timeout=60) for p in pendings]
    assert all(r.ok for r in results), [r.error for r in results]
    assert [r.padded_size for r in results] == [2, 2, 2, 2, 1]
    for r, x in zip(results, xs):
        assert np.array_equal(r.value, _direct(plan, x, "fwd"))


def test_service_rejects_malformed_at_submit():
    with serve.TransformService(device="cpu") as svc:
        with pytest.raises(ValueError, match="rank-3"):
            svc.submit(np.zeros((4, 4), np.complex64))
        with pytest.raises(ValueError, match="must be real"):
            svc.submit(_cplx(np.random.RandomState(0)), problem="r2c")
        # a malformed request must not have poisoned the worker
        x = _cplx(np.random.RandomState(3))
        assert np.array_equal(svc.transform(x), _direct(
            Croft3D((N, N, N), device="cpu"), x, "fwd"))


def test_service_wants_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.TransformService()


# --- resilience: the same scenarios through both packages -------------------

class _Pkg:
    """One package's service surface, for scenarios run through both."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.serve = serve if port else ref_serve
        self.resil = resil if port else ref_resil
        self.degrade = degrade if port else ref_degrade
        self.fault = fault if port else ref_fault
        self.service_mod = service_mod if port else ref_service_mod
        self._kw = {"device": "cpu"} if port else {}

    def service(self, **kw):
        return self.serve.TransformService(**self._kw, **kw)

    def cache(self, **kw):
        return self.serve.PlanCache(**self._kw, **kw)

    def direct(self, x, shape=(N, N, N)):
        if self.name == "port":
            return _direct(Croft3D(shape, device="cpu"), x, "fwd")
        return np.asarray(RefCroft3D(shape).forward(x))


@pytest.fixture(params=["port", "reference"])
def pkg(request):
    return _Pkg(request.param)


def _count(reg, name):
    return reg.snapshot()[name]["value"]


def test_plan_build_fault_falls_back_and_serves(pkg):
    rng = np.random.RandomState(0)
    cache = pkg.cache()
    with pkg.resil.injection([pkg.resil.FaultSpec("plan.build",
                                                  times=(0,))]):
        cp = cache.get((N, N, N))
    assert cp.rung == "default"
    assert _count(cache.registry, "plan_build_failures") == 1
    assert _count(cache.registry, "plan_build_fallbacks") == 1
    x = _cplx(rng)
    y = cp.plan.forward(torch.from_numpy(x) if pkg.name == "port" else x)
    assert np.array_equal(np.asarray(y), pkg.direct(x))
    # a fresh key after the scripted window builds primary again
    assert cache.get((N, N, 2 * N)).rung == "primary"


def test_quarantine_exhausted_resets_failure_counter(pkg):
    """A meshless plan has no ladder: quarantine bottoms out, counts one
    exhaustion event, and resets the burst counter (bounded events)."""
    cache = pkg.cache(quarantine_after=3)
    cp = cache.get((N, N, N))
    for _ in range(3):
        cache.report_dispatch_failure(cp.key)
    assert _count(cache.registry, "plan_dispatch_failures") == 3
    assert _count(cache.registry, "plan_quarantines") == 1
    assert _count(cache.registry, "plan_degrade_exhausted") == 1
    assert cache._plans[cp.key].failures == 0
    assert cache._plans[cp.key].plan is cp.plan  # still serving


def test_upgrade_failure_rolls_back_and_caps_retries(pkg):
    """A failing upgrade rolls the entry back to its servable cold state,
    counts serve_upgrade_failures, and stops re-arming after
    upgrade_max_retries."""
    # the port's upgrade is always synchronous (no upgrade_async option)
    sync = {} if pkg.name == "port" else {"upgrade_async": False}
    cache = pkg.cache(measure_after=1, upgrade_max_retries=2, **sync)
    cp = cache.get((N, N, N))
    cp.state = "cold"           # meshless plans are born warm; force the
    cache.mesh = object()       # upgrade path (injection raises before
    #                             anything touches the fake mesh)
    with pkg.resil.injection([pkg.resil.FaultSpec("plan.upgrade")]) as plan:
        for _ in range(5):
            cache._maybe_upgrade(cache._plans[cp.key])
        assert plan.fired_counts() == {"plan.upgrade": 2}  # capped
    cur = cache._plans[cp.key]
    assert cur.upgrade_failures == 2 and not cur.upgrading
    assert cur.state == "cold"
    assert _count(cache.registry, "serve_upgrade_failures") == 2
    assert _count(cache.registry, "plan_cache_upgrade_starts") == 2


def test_wait_idle_reports_timeout_and_prunes(pkg):
    cache = pkg.cache()
    assert cache.wait_idle(timeout=0.1) is True  # nothing outstanding
    if pkg.name == "port":
        # no upgrade thread exists to time out: an upgrade finishes
        # inside its get (test_plan_cache_refuses_async_upgrades_on_a_mesh)
        assert cache.alive_upgrades() == 0
        return
    t = threading.Thread(target=lambda: time.sleep(0.5), daemon=True)
    cache._upgrade_threads.append(t)
    t.start()
    assert cache.wait_idle(timeout=0.05) is False
    assert cache.alive_upgrades() == 1
    assert cache.wait_idle(timeout=10.0) is True
    assert cache.alive_upgrades() == 0
    assert cache._upgrade_threads == []


def _raise_kernel_error(*args, **kw):
    from repro_torch.kernels import KernelError
    raise KernelError("nvcc not found: the CUDA kernels are built on a "
                      "machine with the CUDA toolkit")


def test_kernel_error_stops_the_service_and_keeps_the_rung(monkeypatch):
    """A kernel that fails (the scale kernel's wrapper, made to raise the
    ``KernelError`` of a failed build) is no plan failure: the key stays
    on its rung with no failure counted, the batch and every pending
    request fail with the error, submit refuses, and stop() raises it."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels import spectral_scale as ss
    rng = np.random.RandomState(7)
    x, h = _cplx(rng), _cplx(rng)
    svc = serve.TransformService(device="cpu", max_batch=4,
                                 max_wait_ms=60000.0, quarantine_after=1)
    svc.start()
    try:
        monkeypatch.setattr(ss, "spectral_scale_planes_full",
                            _raise_kernel_error)
        waiting = svc.submit(x, direction="inverse")  # a bucket of its own
        futs = [svc.submit(x, problem="filtered", h=h) for _ in range(4)]
        for f in futs + [waiting]:
            with pytest.raises(KernelError, match="nvcc not found"):
                f.result(timeout=60)
        with pytest.raises(RuntimeError, match="kernel failure"):
            svc.submit(x)
    finally:
        with pytest.raises(KernelError, match="nvcc not found"):
            svc.stop()
    key = svc.cache.key_for((N, N, N), np.complex64, "c2c")
    plan = svc.cache.snapshot()["plans"][key]
    assert plan["rung"] == "primary" and plan["failures"] == 0
    assert not plan["quarantined"]
    snap = svc.registry.snapshot()
    for name in ("plan_dispatch_failures", "plan_quarantines",
                 "plan_degradations", "serve_requests"):
        assert name not in snap or snap[name]["value"] == 0, name


@pytest.mark.parametrize("step", ["build", "upgrade"])
def test_kernel_error_is_no_plan_failure(monkeypatch, step):
    """A ``KernelError`` while a plan builds, or while the tuner races the
    upgrade's candidates, reaches the caller: no fallback plan
    is built, and the entry keeps its plan and its retry budget."""
    from repro_torch import tuning
    from repro_torch.core import api
    from repro_torch.kernels import KernelError
    cache = serve.PlanCache(device="cpu", measure_after=1)
    if step == "build":
        monkeypatch.setattr(api.Croft3D, "__init__", _raise_kernel_error)
        with pytest.raises(KernelError):
            cache.get((N, N, N))
        assert len(cache) == 0
        snap = cache.registry.snapshot()
        assert all(snap[k]["value"] == 0 for k in (
            "plan_build_failures", "plan_build_fallbacks") if k in snap)
        return
    cp = cache.get((N, N, N))
    cp.state = "cold"           # meshless plans are born warm; force the
    cache.mesh = object()       # upgrade path (the tuner is patched out)
    monkeypatch.setattr(tuning, "upgrade_wisdom", _raise_kernel_error)
    with pytest.raises(KernelError):
        cache._maybe_upgrade(cp)  # what get's hit does
    cur = cache._plans[cp.key]
    assert cur is cp and cur.state == "cold" and not cur.upgrading
    assert cur.upgrade_failures == 0 and cur.rung == "primary"
    snap = cache.registry.snapshot()
    assert "serve_upgrade_failures" not in snap \
        or snap["serve_upgrade_failures"]["value"] == 0


def test_transient_dispatch_fault_retries_and_succeeds(pkg):
    x = _cplx(np.random.RandomState(1))
    with pkg.resil.injection([pkg.resil.FaultSpec(
            "serve.dispatch", times=(0,), kind="transient")]):
        with pkg.service(max_batch=4, retry_backoff_s=0.0) as svc:
            got = svc.transform(x)
            assert np.array_equal(got, pkg.direct(x))
            assert _count(svc.registry, "serve_dispatch_retries") == 1
            assert _count(svc.registry, "serve_failures") == 0


def test_transient_fault_exhausts_retries_then_fails(pkg):
    with pkg.resil.injection([pkg.resil.FaultSpec("serve.dispatch",
                                                  kind="transient")]):
        with pkg.service(max_batch=4, dispatch_retries=1,
                         retry_backoff_s=0.0) as svc:
            r = svc.submit(_cplx(np.random.RandomState(2))).result(
                timeout=60)
            assert not r.ok and "TransientFault" in r.error
            assert _count(svc.registry, "serve_dispatch_retries") == 1
            # the exhausted failure counts toward quarantine
            assert _count(svc.registry, "plan_dispatch_failures") == 1


def test_deadline_miss_resolves_typed_and_batchmates_survive(pkg):
    rng = np.random.RandomState(3)
    with pkg.service(max_batch=4, max_wait_ms=20.0) as svc:
        f_dead = svc.submit(_cplx(rng), deadline_s=0.0)
        f_live = svc.submit(_cplx(rng))
        rd = f_dead.result(timeout=60)
        assert isinstance(rd, pkg.serve.ShedResult)
        assert rd.shed_reason == "deadline"
        assert not rd.ok and "deadline" in rd.error
        assert f_live.result(timeout=60).ok
        assert _count(svc.registry, "serve_deadline_misses") == 1


def test_bounded_queue_sheds_lowest_priority_first(pkg):
    rng = np.random.RandomState(4)
    with pkg.service(max_batch=8, max_wait_ms=60000.0, max_queue=4) as svc:
        highs = [svc.submit(_cplx(rng), priority=serve.PRIORITY_HIGH)
                 for _ in range(4)]
        lows = [svc.submit(_cplx(rng), priority=serve.PRIORITY_LOW)
                for _ in range(3)]
        shed = [f.result(timeout=60) for f in lows]  # resolve pre-stop
        assert all(isinstance(r, pkg.serve.ShedResult)
                   and r.shed_reason == "queue-full" for r in shed)
        assert _count(svc.registry, "serve_shed_requests") == 3
    assert all(f.result(timeout=60).ok for f in highs)


def test_nan_payload_isolated_healthy_batchmates_redispatch(pkg):
    """One NaN payload co-batched with two healthy requests: the poisoned
    request fails typed, both batch-mates re-dispatch individually and
    come back bitwise-equal to the direct transform."""
    rng = np.random.RandomState(5)
    xs = [_cplx(rng) for _ in range(2)]
    bad = _cplx(rng)
    bad[0, 0, 0] = np.nan
    with pkg.service(max_batch=4, max_wait_ms=200.0) as svc:
        fb = svc.submit(bad)
        fh = [svc.submit(x) for x in xs]
        rb = fb.result(timeout=120)
        assert not rb.ok and "poisoned payload" in rb.error
        for x, f in zip(xs, fh):
            r = f.result(timeout=120)
            assert r.ok, r.error
            assert np.array_equal(r.value, pkg.direct(x))
        assert _count(svc.registry, "serve_poisoned_requests") == 1
        assert _count(svc.registry, "serve_poison_redispatches") == 2


def test_preemption_drains_and_refuses_new_work(pkg):
    """SIGTERM flips the PreemptionHandler flag; the worker serves
    everything pending, stops cleanly, and submit() refuses."""
    rng = np.random.RandomState(6)
    old = signal.getsignal(signal.SIGTERM)
    try:
        svc = pkg.service(max_batch=8, max_wait_ms=60000.0,
                          preemption=pkg.fault.PreemptionHandler())
        svc.start()
        futs = [svc.submit(_cplx(rng)) for _ in range(3)]
        signal.raise_signal(signal.SIGTERM)
        results = [f.result(timeout=120) for f in futs]
        assert all(r.ok for r in results), [r.error for r in results]
        t0 = time.monotonic()
        while svc._worker.is_alive() and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert not svc._worker.is_alive(), "worker did not stop after drain"
        with pytest.raises(RuntimeError, match="not started"):
            svc.submit(_cplx(rng))
        assert _count(svc.registry, "serve_preemption_drains") == 1
        svc.stop()  # idempotent after the drain
    finally:
        signal.signal(signal.SIGTERM, old)


def test_package_exports_match_reference():
    assert sorted(serve.__all__) == sorted(ref_serve.__all__)
    assert all(hasattr(serve, name) for name in serve.__all__)


def test_registry_names_match_reference():
    """Every counter and histogram keeps the reference's name."""
    with serve.TransformService(device="cpu") as svc:
        got = set(svc.registry.snapshot())
    with ref_serve.TransformService() as ref:
        want = set(ref.registry.snapshot())
    assert got == want
