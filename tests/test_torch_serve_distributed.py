"""The port's SPMD transform service on 4 gloo ranks (pencil 2x2) against
the reference's service on a 4-device mesh (mirrors
tests/test_serve.py:367-420).

One reference subprocess serves a heterogeneous mix (3 c2c coalescing
into a ragged batch padded to 4, r2c, filtered, c2c and r2c inverse)
through ``repro.serve.TransformService`` on a (2, 2) ``("y", "z")``
mesh and saves the results (the r2c inverse is numpy's ``irfftn``: the
reference service refuses it on this mesh).  One spawn of 4 torch ranks (gloo, CPU
tensors, ``tests/torch_ranks.py``) runs the port's service on the same
mesh shape, rank 0 as the only front end:

  * every served result within the reference tests' tolerance of the
    reference service's (c2c 5e-4, r2c 5e-5, filtered 1e-5 of max|ref|),
    and each rank's block of it bitwise equal to that rank's direct call
    of the cached plan;
  * cold -> warm through a synchronous measured upgrade on every rank,
    the measured entry in the wisdom file and no lock left behind; LRU
    eviction at ``max_plans=2``, the same on every rank;
  * the batching gate under ``Mesh.counting()``: a B=4 stack counts the
    same collectives as B=1 and exactly 4x the bytes, for the tuned c2c
    plan and for the packed r2c plan;
  * an ``exec.output`` fault armed on rank 0 quarantines the c2c key and
    every rank walks to the same rung; the degraded results equal the
    direct fallback plan's bit for bit.  (Held to its counters: the
    reference's own test of this path fails, ``ROADMAP.md`` §3.)
  * faults armed on rank 0 alone (a transient dispatch fault, a plan
    build fault, failing upgrades) neither hang nor desynchronise the
    ranks: every rank's cache ends in the same state with the same
    counters; a follower's ``submit`` refuses.
  * a kernel that fails on one rank (its scale wrapper raises the
    ``KernelError`` of a failed launch, after the last collective)
    stops every rank's service alike: the request fails with it on rank
    0, every rank's ``close()`` raises it, and the key stays on its rung
    with no failure counted.
"""

import json

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice

N = 16
C2C_TOL = 5e-4     # tests/test_kernels_fft.py:78
R2C_TOL = 5e-5     # tests/test_real_fft.py:160
FILT_TOL = 1e-5    # tests/test_kernels_fft.py:68
KINDS = ("c2c", "r2c", "filtered", "c2c-inv", "r2c-inv")

REFERENCE = """
import numpy as np, jax
from repro.serve import PlanCache, TransformService
N = %d
mesh = jax.make_mesh((2, 2), ("y", "z"))
rng = np.random.RandomState(0)
c = lambda: (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
xc, h = c(), c()
xr = rng.randn(N, N, N).astype(np.float32)
yc, yr = np.fft.fftn(xc).astype(np.complex64), np.fft.rfftn(xr).astype(np.complex64)
svc = TransformService(mesh, max_batch=4, max_wait_ms=200.0,
                       cache=PlanCache(mesh, max_plans=4))
with svc:
    futs = [svc.submit(xc) for _ in range(3)]
    futs += [svc.submit(xr, problem="r2c"), svc.submit(xc, problem="filtered", h=h),
             svc.submit(yc, direction="inverse")]
    res = [f.result(timeout=400) for f in futs]
assert all(r.ok for r in res), [r.error for r in res]
# the reference service refuses a batched r2c inverse on this mesh (a JAX
# sharding error: the half spectrum's 9 planes do not divide over 4
# devices); that case is held against numpy's irfftn
np.savez(%r, xc=xc, h=h, xr=xr, yc=yc, yr=yr, **{
    k: r.value for k, r in zip(("c2c", "c2c1", "c2c2", "r2c", "filtered",
                                 "c2c-inv"), res)},
    **{"r2c-inv": np.fft.irfftn(yr, s=(N, N, N)).astype(np.float32)})
print("OK reference")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import Croft3D, Decomposition, make_mesh
from repro_torch.resil import FaultSpec, degrade, injection
from repro_torch.serve import PlanCache, TransformService
from repro_torch.tuning import wisdom as wisdom_lib
from repro_torch.tuning.candidates import default_candidate
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 4)
mesh = make_mesh((2, 2), ("y", "z"), device="cpu")
ref = np.load(npz)
xc, h, xr, yc, yr = (ref[k] for k in ("xc", "h", "xr", "yc", "yr"))
N = xc.shape[0]
shape = (N, N, N)
lead = rank == 0
rec = {"rank": rank}
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def from_lead(obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# A: the heterogeneous mix, against the reference service
cache = PlanCache(mesh, max_plans=4)
svc = TransformService(mesh, max_batch=4, max_wait_ms=200.0, cache=cache)
served = None
with svc:
    if lead:
        futs = [svc.submit(xc) for _ in range(3)]
        futs += [svc.submit(xr, problem="r2c"),
                 svc.submit(xc, problem="filtered", h=h),
                 svc.submit(yc, direction="inverse"),
                 svc.submit(yr, problem="r2c", direction="inverse",
                            shape=shape)]
        res = [f.result(timeout=200) for f in futs]
        served = {k: (r.ok, r.error, r.batch_size, r.padded_size, r.value)
                  for k, r in zip(("c2c", "c2c1", "c2c2", "r2c", "filtered",
                                   "c2c-inv", "r2c-inv"), res)}
        rec["mix"] = {k: dict(ok=v[0], error=v[1], batch=v[2], padded=v[3],
                              err=float(np.abs(v[4] - ref[k]).max()
                                        / np.abs(ref[k]).max()))
                      for k, v in served.items()}
served = from_lead(served)
pc = cache._plans[cache.key_for(shape, np.complex64, "c2c")].plan
pr = cache._plans[cache.key_for(shape, np.complex64, "r2c")].plan
with torch.no_grad():
    direct = {
        "c2c": (pc.forward(t(xc[pc.input_sharding])), pc.output_sharding),
        "r2c": (pr.forward(t(xr[pr.input_sharding])), pr.output_sharding),
        "filtered": (pc.forward_filtered(t(xc[pc.input_sharding]),
                                         t(h[pc.output_sharding])),
                     pc.output_sharding),
        "c2c-inv": (pc.inverse(t(yc[pc.output_sharding])),
                    pc.input_sharding),
        "r2c-inv": (pr.inverse(t(yr[pr.output_sharding])),
                    pr.input_sharding)}
rec["bitwise"] = {k: bool(np.array_equal(served[k][4][sl], y.numpy()))
                  for k, (y, sl) in direct.items()}
rec["mix_snapshot"] = cache.snapshot()
svc.close()

# B: cold -> warm through a synchronous measured upgrade; LRU eviction
wis = os.path.join(out, "w.json")
cache = PlanCache(mesh, wisdom_path=wis, max_plans=2, measure_after=3,
                  tune_kw=dict(top_k=2, measure_iters=1))
svc = TransformService(mesh, max_batch=4, max_wait_ms=30.0, cache=cache)
with svc:
    if lead:
        first = svc.submit(xc).result(timeout=200)
        states = [svc.submit(xc).result(timeout=200).plan_state
                  for _ in range(3)]
        lru = svc.submit(xr, problem="r2c").result(timeout=200)
        small = svc.submit(xc[:8, :8, :8]).result(timeout=200)
        rec["upgrade"] = dict(first=first.plan_state, states=states,
                              ok=first.ok and lru.ok and small.ok,
                              err=float(np.abs(small.value - np.fft.fftn(
                                  xc[:8, :8, :8])).max()))
warm = cache.key_for(shape, np.complex64, "c2c")
rec["cache"] = dict(upgrades=cache.stats.upgrades, size=len(cache),
                    evictions=cache.stats.evictions, keys=cache.keys(),
                    warm_evicted=warm not in cache.keys())
if lead:
    blob = json.load(open(wis))
    rec["wisdom"] = dict(
        measured=[k for k, e in blob["entries"].items()
                  if e["source"] == "measure"],
        lock=os.path.exists(wis + ".lock"))
svc.close()

# C: the batching gate, for the tuned c2c plan and the packed r2c plan
tuned = Croft3D(shape, mesh, tune="wisdom", wisdom_path=wis)
packed = Croft3D(shape, mesh, Decomposition("pencil", ("y", "z")),
                 problem="r2c", strategy="packed")
rec["gate"] = {}
for name, plan, dtype in (("c2c-tuned", tuned, torch.complex64),
                          ("r2c-packed", packed, torch.float32)):
    counted = []
    for b in (1, 4):
        x = torch.zeros((b,) + plan.local_input_shape(), dtype=dtype)
        with torch.no_grad(), mesh.counting() as c:
            plan.forward_batched(x)
        counted.append(({k: e["count"] for k, e in c.collectives.items()},
                        c.bytes))
    rec["gate"][name] = dict(label=plan.candidate().label, b1=counted[0],
                             b4=counted[1])

# D: exec.output armed on rank 0 -> quarantine, the same rung everywhere
wis2 = os.path.join(out, "w2.json")
key = wisdom_lib.wisdom_key(shape, {"y": 2, "z": 2}, np.complex64, "cpu")
if lead:
    wisdom_lib.merge_entries(wis2, {key: wisdom_lib.WisdomEntry.from_candidate(
        default_candidate(shape, {"y": 2, "z": 2}), source="measure",
        measured_s=1e-3)})
dist.barrier()
cache = PlanCache(mesh, wisdom_path=wis2, quarantine_after=1)
svc = TransformService(mesh, max_batch=4, max_wait_ms=20.0, cache=cache,
                       registry=cache.registry)
degraded = None
with svc:
    if lead:
        with injection([FaultSpec("exec.output", kind="nan")]):
            r = svc.submit(xc).result(timeout=200)
        r2 = svc.submit(xc).result(timeout=200)
        snap = svc.registry.snapshot()
        rec["poison"] = dict(
            ok=r.ok, error=r.error, ok2=r2.ok,
            counters={k: snap[k]["value"] for k in (
                "serve_nan_outputs", "plan_quarantines", "plan_degradations",
                "serve_failures", "serve_requests")})
        degraded = r2.value
degraded = from_lead(degraded)
cp = cache._plans[key]
bottom = degrade.bottom_candidate(shape, {"y": 2, "z": 2})
fallback = Croft3D(shape, mesh, bottom.decomp, bottom.opts)
with torch.no_grad():
    yf = fallback.forward(t(xc[fallback.input_sharding]))
rec["quarantine"] = dict(
    rung=cp.rung, quarantined=cp.quarantined,
    plan_key=cp.plan.candidate().plan_key, bottom=bottom.plan_key,
    bitwise=bool(np.array_equal(degraded[fallback.output_sharding],
                                yf.numpy())),
    failures=cache.registry.snapshot()["plan_dispatch_failures"]["value"])
svc.close()

# E: faults armed on rank 0 alone keep every rank in step
wis3 = os.path.join(out, "w3.json")
cache = PlanCache(mesh, wisdom_path=wis3, measure_after=1,
                  tune_kw=dict(top_k=1, measure_iters=1))
svc = TransformService(mesh, max_batch=4, max_wait_ms=20.0, cache=cache,
                       registry=cache.registry, retry_backoff_s=0.0)
try:
    svc.submit(xc)
    rec["follower_submit"] = "accepted"
except RuntimeError as e:
    rec["follower_submit"] = str(e)
with svc:
    if lead:
        with injection([FaultSpec("serve.dispatch", times=(0,),
                                  kind="transient"),
                        FaultSpec("plan.build", times=(0,)),
                        FaultSpec("plan.upgrade")]):
            got = [svc.submit(xc).result(timeout=200) for _ in range(4)]
        rec["faults"] = dict(
            ok=[g.ok for g in got],
            err=max(float(np.abs(g.value - np.fft.fftn(xc)).max()
                          / np.abs(np.fft.fftn(xc)).max()) for g in got),
            retries=svc.registry.snapshot()["serve_dispatch_retries"]["value"])
snap = cache.registry.snapshot()
rec["fault_state"] = dict(
    snapshot=cache.snapshot(),
    counters={k: snap[k]["value"] for k in (
        "plan_build_failures", "plan_build_fallbacks", "serve_upgrade_failures",
        "plan_cache_upgrade_starts") if k in snap})
svc.close()

# F: a kernel failure on one rank stops every rank's service alike
from repro_torch.kernels import KernelError
from repro_torch.kernels import spectral_scale as ss
cache = PlanCache(mesh, quarantine_after=1)
svc = TransformService(mesh, max_batch=4, max_wait_ms=20.0, cache=cache,
                       registry=cache.registry)
scale = ss.spectral_scale_planes_full
if rank == 2:
    def launch_failed(*a, **kw):
        raise KernelError("spectral_scale_full launch failed: CUDA error 700")
    ss.spectral_scale_planes_full = launch_failed
svc.start()
if lead:
    first = svc.submit(xc).result(timeout=200)
    try:
        svc.submit(xc, problem="filtered", h=h).result(timeout=200)
        filtered = "served"
    except KernelError as e:
        filtered = str(e)
    rec["kernel"] = dict(first=first.ok, filtered=filtered)
try:
    svc.close()
    closed = "returned"
except KernelError as e:
    closed = str(e)
ss.spectral_scale_planes_full = scale
snap = cache.registry.snapshot()
rec["kernel_state"] = dict(
    closed=closed, snapshot=cache.snapshot(),
    counters={k: snap[k]["value"] for k in (
        "plan_dispatch_failures", "plan_quarantines", "plan_degradations")
        if k in snap})

with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    run_multidevice(REFERENCE % (N, path), n_devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(reference_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER, 4, [reference_path, out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("kind", KINDS)
def test_served_results_match_reference_service(ranks, kind):
    tol = {"c2c": C2C_TOL, "r2c": R2C_TOL, "filtered": FILT_TOL,
           "c2c-inv": C2C_TOL, "r2c-inv": R2C_TOL}[kind]
    got = ranks[0]["mix"][kind]
    assert got["ok"], got["error"]
    assert got["err"] < tol, got
    assert all(r["bitwise"][kind] for r in ranks), [r["bitwise"]
                                                     for r in ranks]


def test_ragged_batch_pads_to_four(ranks):
    mix = ranks[0]["mix"]
    for k in ("c2c", "c2c1", "c2c2"):
        assert mix[k]["ok"] and mix[k]["err"] < C2C_TOL
        assert (mix[k]["batch"], mix[k]["padded"]) == (3, 4)
    assert len({json.dumps(r["mix_snapshot"], sort_keys=True)
                for r in ranks}) == 1


def test_cold_to_warm_upgrade_on_every_rank(ranks):
    up = ranks[0]["upgrade"]
    assert up["ok"] and up["first"] == "cold", up
    assert up["states"][-1] == "warm", up
    assert up["err"] < 1e-3
    assert all(r["cache"]["upgrades"] == 1 for r in ranks)
    w = ranks[0]["wisdom"]
    assert w["measured"] and not w["lock"], w


def test_lru_eviction_on_every_rank(ranks):
    caches = [r["cache"] for r in ranks]
    assert all(c["size"] == 2 and c["evictions"] >= 1 for c in caches)
    assert all(c["warm_evicted"] for c in caches)
    assert len({tuple(c["keys"]) for c in caches}) == 1


@pytest.mark.parametrize("name", ["c2c-tuned", "r2c-packed"])
def test_batching_gate_counts(ranks, name):
    """B=4 costs B=1's collectives, each carrying 4x the bytes."""
    for r in ranks:
        g = r["gate"][name]
        (c1, b1), (c4, b4) = g["b1"], g["b4"]
        assert c1 == c4 and sum(c1.values()) > 0, g
        assert b4 == 4 * b1 > 0, g
    if name == "r2c-packed":
        assert "packed" in ranks[0]["gate"][name]["label"]


def test_exec_output_fault_quarantines_on_every_rank(ranks):
    p = ranks[0]["poison"]
    assert not p["ok"] and "non-finite output" in p["error"], p
    assert p["ok2"], p
    assert p["counters"] == {"serve_nan_outputs": 1, "plan_quarantines": 1,
                             "plan_degradations": 1, "serve_failures": 1,
                             "serve_requests": 1}, p
    for r in ranks:
        q = r["quarantine"]
        assert q["rung"] == "default" and q["quarantined"], q
        assert q["plan_key"] == q["bottom"], q
        assert q["failures"] == 1, q


def test_degraded_results_equal_the_fallback_plan(ranks):
    assert all(r["quarantine"]["bitwise"] for r in ranks)


def test_front_end_faults_keep_ranks_in_step(ranks):
    f = ranks[0]["faults"]
    assert all(f["ok"]) and f["err"] < C2C_TOL, f
    assert f["retries"] == 1, f
    states = {json.dumps(r["fault_state"], sort_keys=True) for r in ranks}
    assert len(states) == 1, states
    c = ranks[0]["fault_state"]["counters"]
    assert c["plan_build_failures"] == 1 and c["plan_build_fallbacks"] == 1
    assert c["serve_upgrade_failures"] == 2 == c["plan_cache_upgrade_starts"]
    plan = next(iter(ranks[0]["fault_state"]["snapshot"]["plans"].values()))
    assert plan["rung"] == "default" and plan["state"] == "cold"


def test_only_rank_zero_takes_requests(ranks):
    assert ranks[0]["follower_submit"] != "accepted"
    assert "not started" in ranks[0]["follower_submit"]
    for r in ranks[1:]:
        assert "front end" in r["follower_submit"], r["follower_submit"]


def test_kernel_error_on_one_rank_stops_every_rank(ranks):
    k = ranks[0]["kernel"]
    assert k["first"], k
    assert k["filtered"] == "the batch failed on another rank", k
    for i, r in enumerate(ranks):
        st = r["kernel_state"]
        assert st["closed"] == (
            "spectral_scale_full launch failed: CUDA error 700" if i == 2
            else "the batch failed on another rank"), st
        assert not any(st["counters"].values()), st
        (plan,) = st["snapshot"]["plans"].values()
        assert plan["rung"] == "primary" and plan["failures"] == 0, plan
