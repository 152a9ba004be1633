"""The port's tuner and the ``Croft3D`` surface it gates, on gloo ranks
against the JAX reference on as many virtual devices.

4 ranks (pencil 2x2, slab 4, N = 16) against a 4-device reference run:
``Croft3D.tuned(mode="model")`` picks the reference's plan (wisdom key
included) with the reference's constants patched in; ``mode="measure"``
returns one winner on every rank; a candidate made to fail on one rank
(``inject``) is dropped on all of them, and a kernel that does not
build on one rank fails the tune on every rank; the ``mode="wisdom"`` round trip makes no measurement; counted
collectives equal
``predicted_collectives`` and counted bytes are within 5 % of
``comm_bytes_model()`` for every transpose — of its (P-1)/P for ring
and pairwise, which never send the piece a rank keeps (the reference's
``tests/test_roofline.py:126-138`` gate); ``forward_filtered_batched``
matches the reference and equals two ``forward_filtered`` calls.

8 ranks (2x4, the reference's ``MIXED_KEY`` searched schedule at
16x16x8) against an 8-device reference run: it executes, inverts and
matches the reference's output; its counted collectives equal the
prediction; its gradient holds the Parseval oracle ``2 N x`` within
1e-3 (``tests/test_schedule_search.py:394-422``; the reference's own
gradient of this plan fails, so it is not the oracle here).
"""

import json

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice
from repro.tuning import cost_model as ref_cost

N = 16
KINDS = {"pencil": ((2, 2), ("data", "model")), "slab": ((4,), ("p",))}
PICKS = [("c2c", False), ("r2c", False), ("c2c", True)]
MIXED_KEY = ("sched:pencil[data,model]|k1/matmul/spectral/alltoall/"
             "pipelined|f0.t0s0c1h2r;f1.t1s1c2h0k2;f2")
MIXED_SHAPE = (16, 16, 8)             # tests/test_schedule_search.py:364
REL_TOL = 1e-5                        # tests/test_distributed_fft.py:27
SCHED_TOL = 1e-4                      # tests/test_schedule_search.py:378
PARSEVAL_TOL = 1e-3                   # tests/test_schedule_search.py:420
BYTES_TOL = 0.05                      # tests/test_roofline.py:136
CONSTANTS = {name: getattr(ref_cost, name) for name in (
    "IMPL_EFFICIENCY", "_DEFAULT_EFFICIENCY", "LOCAL_PASSES",
    "COLLECTIVE_LATENCY_S", "REPLAN_PASSES", "PEAK_FLOPS", "HBM_BW",
    "LINK_BW")}

REFERENCE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D, Decomposition, FFTOptions
N, KINDS, PICKS, path = %d, %r, %r, %r
auto = jax.sharding.AxisType.Auto
picks = {}
for kind, (sizes, names) in KINDS.items():
    mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
    for problem, grad in PICKS:
        plan = Croft3D.tuned((N, N, N), mesh, mode="model", problem=problem,
                             grad=grad)
        picks[f"{kind}/{problem}/{grad}"] = [plan.candidate().plan_key,
                                             plan.tune_result.key]
sizes, names = KINDS["pencil"]
mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
rng = np.random.RandomState(5)
x = (rng.randn(2, N, N, N) + 1j * rng.randn(2, N, N, N)).astype(np.complex64)
h = (rng.randn(2, N, N, N) + 1j * rng.randn(2, N, N, N)).astype(np.complex64)
plan = Croft3D((N, N, N), mesh, Decomposition("pencil", names),
               FFTOptions(overlap_k=2))
y = plan.forward_filtered_batched(
    jax.device_put(jnp.asarray(x), plan.batched_sharding("input")),
    jax.device_put(jnp.asarray(h), plan.batched_sharding("output")))
np.savez(path, x=x, h=h, y=np.asarray(y), picks=np.array(json.dumps(picks)))
print("OK reference")
"""

REFERENCE_MIXED = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D
from repro.tuning.candidates import ScheduleCandidate
shape, key, path = %r, %r, %r
mesh = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
x = (rng.standard_normal(shape)
     + 1j * rng.standard_normal(shape)).astype(np.complex64)
plan = Croft3D(shape, mesh=mesh, schedule=ScheduleCandidate.from_plan_key(key))
y = plan.forward(jax.device_put(jnp.asarray(x), plan.input_sharding))
np.savez(path, x=x, y=np.asarray(y))
print("OK reference")
"""

SENT_BYTES = r"""
from repro_torch.core.schedule import stage_transpose_impl


def sent_bytes_model(plan):
    # comm_bytes_model() less the piece a ring or pairwise stage keeps:
    # such a stage sends (P-1)/P of its volume, an all-to-all all of it
    sched = plan._forward_schedule()
    events = sched.comm_events(plan.shape, plan.mesh.shape,
                               plan.dtype.itemsize)
    kept = sum(ev["bytes"] / ev["comm_size"] for (_, st), ev
               in zip(sched.comm_stages(), events)
               if stage_transpose_impl(st, plan.opts) != "alltoall")
    return plan.comm_bytes_model() - kept
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch import tuning
from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
from repro_torch.obs import metrics
from repro_torch.resil import inject
from repro_torch.tuning import cost_model
%s
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
N, KINDS, PICKS, CONSTANTS = %d, %r, %r, %r
join(rank, port, 4)
ref = np.load(npz)
rec = {"rank": rank}
meshes = {kind: make_mesh(sizes, names, device="cpu")
          for kind, (sizes, names) in KINDS.items()}
shape = (N, N, N)

# model mode with the reference's constants patched in
saved = {k: getattr(cost_model, k) for k in CONSTANTS}
for k, v in CONSTANTS.items():
    setattr(cost_model, k, v)
rec["picks"] = {}
for kind, mesh in meshes.items():
    for problem, grad in PICKS:
        plan = Croft3D.tuned(shape, mesh, mode="model", problem=problem,
                             grad=grad)
        rec["picks"][f"{kind}/{problem}/{grad}"] = [
            plan.candidate().plan_key, plan.tune_result.key]
for k, v in saved.items():
    setattr(cost_model, k, v)

# measure mode: the first candidate timed fails on rank 1 only
mesh = meshes["pencil"]
reg = metrics.get_registry()
specs = [inject.FaultSpec("tune.measure", times=(0,))] if rank == 1 else []
wpath = os.path.join(out, "wisdom.json")
with inject.injection(specs) as fplan:
    r = tuning.tune(shape, mesh, mode="measure", top_k=3, measure_iters=2,
                    measure_warmup=1, wisdom_path=wpath)
pool = [row["label"] for row in r.ranked[:3]]
rec["measure"] = dict(
    winner=r.candidate().plan_key, source=r.source,
    measured=sorted(row["label"] for row in r.ranked if "measured_s" in row),
    first=pool[0], fired=fplan.fired_counts(),
    failures=reg.counter("tune_measure_failures").value,
    measured_s=r.measured_s)

# a kernel that does not build on one rank, before any collective, fails
# the tune on every rank (no other plan races in its place); one that
# fails while every rank times the plan fails it too; a plan refused
# while timing is dropped
from repro_torch.kernels import KernelError
from repro_torch.tuning import measure
real_fire, real_timer = inject.fire, measure.time_forward


def no_kernel_here(site, key=""):
    if rank == 2:
        raise KernelError("nvcc not found")


def raises(exc):
    def timer(plan, **kw):
        raise exc
    return timer


rec["kernel_error"] = []
for patch in ((no_kernel_here, measure.time_forward),
              (real_fire, raises(KernelError("launch failed")))):
    inject.fire, measure.time_forward = patch
    try:
        tuning.tune(shape, mesh, mode="measure", top_k=2, measure_iters=1,
                    measure_warmup=0, save=False)
        rec["kernel_error"].append(None)
    except KernelError as e:
        rec["kernel_error"].append(str(e))
inject.fire, measure.time_forward = real_fire, raises(ValueError("refused"))
failures = reg.counter("tune_measure_failures").value
rec["refused"] = [measure.measure_candidate(
    shape, mesh, tuning.default_candidate(shape, mesh.shape), iters=1,
    warmup=0), reg.counter("tune_measure_failures").value - failures]
measure.time_forward = real_timer

g = tuning.tune(shape, mesh, mode="measure", problem="c2c_grad", top_k=2,
                measure_iters=2, measure_warmup=1)
rec["measure_grad"] = [g.candidate().plan_key, g.key]
rr = tuning.tune(shape, mesh, mode="measure", problem="r2c", top_k=2,
                 measure_iters=2, measure_warmup=1)
rec["measure_r2c"] = [rr.candidate().plan_key, rr.strategy]

# the wisdom round trip: same plan, no measurement
runs = reg.counter("tune_measure_runs").value
plan = Croft3D(shape, mesh, tune="wisdom", wisdom_path=wpath)
entry = tuning.Wisdom.load(wpath).lookup(r.key)
rec["wisdom"] = dict(
    source=plan.tune_result.source, plan=plan.candidate().plan_key,
    new_runs=reg.counter("tune_measure_runs").value - runs,
    hlo={k: v["count"] for k, v in entry.hlo["collectives"].items()},
    predicted=cost_model.predicted_collectives(
        plan._forward_schedule(), shape, mesh.shape, plan.opts))

# counted collectives and bytes, every transpose
rec["counts"] = []
for kind, mesh in meshes.items():
    dec = Decomposition(kind, KINDS[kind][1])
    for impl in ("alltoall", "ring", "pairwise"):
        for k in (1, 2):
            for layout in ("natural", "spectral"):
                plan = Croft3D(shape, mesh, dec, FFTOptions(
                    overlap_k=k, transpose_impl=impl, output_layout=layout))
                c = cost_model.counted_collectives(plan)
                pred = cost_model.predicted_collectives(
                    plan._forward_schedule(), shape, mesh.shape, plan.opts)
                rec["counts"].append(dict(
                    tag=f"{kind}/{impl}/k{k}/{layout}",
                    counted={a: e["count"] for a, e in
                             c["collectives"].items() if e["count"]},
                    predicted={a: n for a, n in pred.items() if n},
                    bytes=c["collective_bytes"],
                    model=plan.comm_bytes_model(),
                    sent=sent_bytes_model(plan)))

# forward_filtered_batched: the reference's output, and bitwise two calls
mesh = meshes["pencil"]
plan = Croft3D(shape, mesh, Decomposition("pencil", KINDS["pencil"][1]),
               FFTOptions(overlap_k=2))
xb = torch.from_numpy(np.ascontiguousarray(
    ref["x"][plan.batched_sharding("input")]))
hb = torch.from_numpy(np.ascontiguousarray(
    ref["h"][plan.batched_sharding("output")]))
yb = plan.forward_filtered_batched(xb, hb)
ys = torch.stack([plan.forward_filtered(xb[i].contiguous(),
                                        hb[i].contiguous())
                  for i in range(2)])
want = ref["y"][plan.batched_sharding("output")]
rec["batched"] = dict(
    err=float(np.abs(yb.numpy() - want).max() / np.abs(ref["y"]).max()),
    bitwise=bool(torch.equal(yb, ys)))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(*meshes.values())
"""

WORKER_MIXED = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import Croft3D, make_mesh
from repro_torch.tuning import cost_model
from repro_torch.tuning.candidates import ScheduleCandidate
%s
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
shape, key = %r, %r
join(rank, port, 8)
ref = np.load(npz)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
plan = Croft3D(shape, mesh, schedule=ScheduleCandidate.from_plan_key(key))
xl = torch.from_numpy(np.ascontiguousarray(ref["x"][plan.input_sharding]))
with torch.no_grad():
    y = plan.forward(xl)
    xb = plan.inverse(y)
want = ref["y"][plan.output_sharding]
c = cost_model.counted_collectives(plan)
pred = cost_model.predicted_collectives(plan._forward_schedule(), shape,
                                        mesh.shape, plan.opts)
xg = xl.clone().requires_grad_(True)
torch.linalg.vector_norm(plan.forward(xg)).square().backward()
n = float(np.prod(shape))
grad_ok = bool(np.allclose(xg.grad.numpy(), 2 * n * xl.numpy(),
                           rtol=%r, atol=%r))
rec = dict(
    rank=rank,
    err=float(np.abs(y.numpy() - want).max() / np.abs(ref["y"]).max()),
    rt=float(np.abs(xb.numpy() - xl.numpy()).max()
             / np.abs(ref["x"]).max()),
    counted={a: e["count"] for a, e in c["collectives"].items()
             if e["count"]},
    predicted={a: k for a, k in pred.items() if k},
    bytes=c["collective_bytes"], model=plan.comm_bytes_model(),
    sent=sent_bytes_model(plan), grad_ok=grad_ok,
    grad_err=float(np.abs(xg.grad.numpy() - 2 * n * xl.numpy()).max()))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


def _spawn(script_text, ranks, npz, out):
    torch_ranks.spawn(script_text, ranks, [npz, out], out,
                      env={"OMP_NUM_THREADS": "1"})
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(ranks)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    run_multidevice(REFERENCE % (N, KINDS, PICKS, path), n_devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return _spawn(WORKER % (SENT_BYTES, N, KINDS, PICKS, CONSTANTS), 4, reference, out)


@pytest.fixture(scope="module")
def mixed_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref8") / "ref.npz")
    run_multidevice(REFERENCE_MIXED % (MIXED_SHAPE, MIXED_KEY, path),
                    n_devices=8)
    out = tmp_path_factory.mktemp("ranks8")
    return _spawn(WORKER_MIXED % (SENT_BYTES, MIXED_SHAPE, MIXED_KEY,
                                  PARSEVAL_TOL, PARSEVAL_TOL), 8, path, out)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("problem,grad", PICKS)
def test_model_mode_picks_the_reference_plan(reference, ranks, kind,
                                             problem, grad):
    want = json.loads(str(np.load(reference)["picks"]))[
        f"{kind}/{problem}/{grad}"]
    for rec in ranks:
        assert rec["picks"][f"{kind}/{problem}/{grad}"] == want


def test_measure_returns_one_winner_on_every_rank(ranks):
    m = [rec["measure"] for rec in ranks]
    assert all(x["source"] == "measure" for x in m)
    assert len({x["winner"] for x in m}) == 1
    assert len({x["measured_s"] for x in m}) == 1   # the slowest rank's
    for key in ("measure_grad", "measure_r2c"):
        assert len({tuple(rec[key]) for rec in ranks}) == 1, key


def test_failure_on_one_rank_drops_the_candidate_everywhere(ranks):
    m = [rec["measure"] for rec in ranks]
    assert m[1]["fired"] == {"tune.measure": 1}
    assert all(x["fired"] == {} for i, x in enumerate(m) if i != 1)
    for x in m:
        assert x["first"] not in x["measured"]
        assert x["measured"] == m[0]["measured"]
        assert len(x["measured"]) >= 2
        assert x["failures"] == 1


def test_kernel_error_fails_the_tune_everywhere(ranks):
    first = ranks[0]["measure"]["first"]
    for i, rec in enumerate(ranks):
        # on one rank before any collective: raised on every rank
        assert rec["kernel_error"][0] == (
            "nvcc not found" if i == 2 else
            f"measuring {first} failed on another rank")
        # while every rank times the plan
        assert rec["kernel_error"][1] == "launch failed"


def test_plan_refused_while_timing_is_dropped(ranks):
    for rec in ranks:
        assert rec["refused"] == [None, 1]


def test_wisdom_round_trip_makes_no_measurement(ranks):
    for rec in ranks:
        w = rec["wisdom"]
        assert w["source"] == "wisdom"
        assert w["plan"] == rec["measure"]["winner"]
        assert w["new_runs"] == 0
        # the stored collective counts are the winner's, as predicted
        assert w["hlo"] == {k: v for k, v in w["predicted"].items() if v}


def test_counted_collectives_equal_prediction(ranks):
    for rec in ranks:
        assert len(rec["counts"]) == 2 * 3 * 2 * 2
        for c in rec["counts"]:
            assert c["counted"] == c["predicted"], c
            # bytes sent: all of comm_bytes_model() for an all-to-all,
            # (P-1)/P of it for ring and pairwise
            if "/alltoall/" in c["tag"]:
                assert c["sent"] == c["model"], c
            else:
                assert c["sent"] < c["model"], c
            assert abs(c["bytes"] - c["sent"]) <= BYTES_TOL * c["sent"], c


def test_forward_filtered_batched_matches(ranks):
    for rec in ranks:
        assert rec["batched"]["err"] < REL_TOL, rec["batched"]
        assert rec["batched"]["bitwise"]


def test_mixed_schedule_executes_and_inverts(mixed_ranks):
    for rec in mixed_ranks:
        assert rec["err"] < SCHED_TOL, rec
        assert rec["rt"] < SCHED_TOL, rec


def test_mixed_schedule_collectives_as_predicted(mixed_ranks):
    for rec in mixed_ranks:
        assert rec["counted"] == rec["predicted"] == {
            "all-to-all": 2, "collective-permute": 1}
        assert rec["sent"] < rec["model"]      # one ring stage
        assert abs(rec["bytes"] - rec["sent"]) <= BYTES_TOL * rec["sent"]


def test_mixed_schedule_gradient_is_parseval(mixed_ranks):
    for rec in mixed_ranks:
        assert rec["grad_ok"], rec["grad_err"]
