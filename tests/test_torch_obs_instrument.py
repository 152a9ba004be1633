"""The port's per-stage overlap attribution against the JAX reference.

8 gloo ranks on a 2x4 pencil mesh (the reference tests' mesh and sizes):

* the ring-round hook (``tests/test_schedule_search.py:427-482``): an
  identity ``ring_round_cb`` leaves ``run_schedule``'s output bitwise
  equal, it sees rounds {1, 2, 3} (round 1 twice: both rings), and
  ``trace_forward`` records rounds ``{"x-fft+xy": [1], "y-fft+yz": [1, 2,
  3]}`` and the span ``s1:y-fft+yz:round[3]``; a standalone
  ``ring_round`` receives the piece the ring transpose receives;
* the zero-cost pin in the form ``tests/test_obs.py:318`` takes for the
  port: with the tracer on and off, ``plan.forward`` runs the same op
  sequence (a dispatch-mode op list) and gives bitwise equal outputs;
* the acceptance plans ``alltoall-k2`` and ``ring-k1`` at 16^3: each row
  has the reference summary's keys, two comm stages, an efficiency in
  [0, 1], a model row, collective counts equal to the reference's HLO
  counts, and ``y`` within 2e-4 of ``plan.forward``; every rank returns
  the same summary (slowest-rank medians);
* ``render_plan`` / ``build_report`` / ``main`` byte-equal to the
  reference report's on the same summary and trace document, and the
  trace (with a short service run in it) passing the reference trace
  smoke's ``_validate``.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_ranks
from conftest import run_multidevice
from repro.obs import report as ref_report
from repro_torch import obs
from repro_torch.core import Croft3D, FFTOptions
from repro_torch.obs import instrument
from repro_torch.obs import report

N = 16
TOL = 2e-4                      # tests/test_obs.py:349-351
PLANS = ("alltoall-k2", "ring-k1")

REFERENCE = """
import json, jax, jax.numpy as jnp
from repro import obs
from repro.core import Croft3D, Decomposition, FFTOptions
from repro.obs import instrument
from repro.tuning.measure import _random_input
N, path = %d, %r
mesh = jax.make_mesh((2, 4), ("y", "z"))
out = {}
tracer = obs.enable()
for label, impl, k in (("alltoall-k2", "alltoall", 2), ("ring-k1", "ring", 1)):
    plan = Croft3D((N, N, N), mesh, Decomposition("pencil", ("y", "z")),
                   FFTOptions(overlap_k=k, transpose_impl=impl,
                              output_layout="spectral"))
    x = _random_input((N, N, N), jnp.complex64, plan.input_sharding)
    _, summary = instrument.trace_forward(plan, x, tracer=tracer, iters=1,
                                          label=label)
    out[label] = summary
json.dump(out, open(path, "w"), default=str)
print("OK reference")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_ranks import join, leave
from repro_torch import obs
from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.distributed import build_schedule
from repro_torch.obs import instrument
from repro_torch.serve import TransformService

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
N = %d
join(rank, port, 8)
rec = {"rank": rank}


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def block(plan, seed):
    g = torch.Generator().manual_seed(seed)
    full = torch.complex(torch.randn(plan.shape, generator=g),
                         torch.randn(plan.shape, generator=g))
    return full[plan.input_sharding].contiguous()


# -- the ring-round hook (tests/test_schedule_search.py:427-482) ----------
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
dec = Decomposition("pencil", ("data", "model"))
opts = FFTOptions(overlap_k=1, transpose_impl="ring", output_layout="spectral")
sched = build_schedule(dec, opts)
shape = (16, 16, 8)
plan = Croft3D(shape, mesh, dec, opts)
x = block(plan, 0)
seen, pieces = [], {}

def cb(rnd, piece):
    seen.append(rnd)
    pieces.setdefault(rnd, piece.clone())   # stage 0's round 1 first
    return piece

def wrap(rnd, piece):
    return piece * 1      # a new tensor: the slot takes it

y_cb = schedule_lib.run_schedule(x, sched, opts, mesh, ring_round_cb=cb)
y_wrap = schedule_lib.run_schedule(x, sched, opts, mesh, ring_round_cb=wrap)
y_plain = schedule_lib.run_schedule(x, sched, opts, mesh)
rec["hook_bitwise"] = bool(torch.equal(y_cb, y_plain))
rec["wrap_bitwise"] = bool(torch.equal(y_wrap, y_plain))
rec["seen"] = seen
st0 = sched.stages[0]
pre = schedule_lib.stage_pre(x, st0, sched.sign, opts)
got = schedule_lib.ring_round(pre, st0, opts, mesh, 1)
rec["round_piece_equal"] = bool(torch.equal(got, pieces[1]))
own = schedule_lib.ring_round(pre, st0, opts, mesh, 0)
rec["round0_own_piece"] = list(own.shape) == list(got.shape)

tracer = obs.enable()
_, summary = instrument.trace_forward(plan, x, tracer=tracer, iters=1,
                                      label="ring")
rec["rounds"] = {row["name"]: [r["round"] for r in row.get("rounds", [])]
                 for row in summary["stages"] if row["comm_s"] > 0}
rec["round_span"] = "s1:y-fft+yz:round[3]" in {e["name"]
                                               for e in tracer.events()}
obs.disable()

# -- the zero-cost pin: tracer on / off ------------------------------------
def ops_of(p, xx):
    with torch.no_grad(), Ops() as m:
        y = p.forward(xx)
    return m.ops, y

ops_off, y_off = ops_of(plan, x)
obs.enable()
ops_on, y_on = ops_of(plan, x)
obs.disable()
rec["same_ops"] = ops_off == ops_on and len(ops_off) > 0
rec["n_ops"] = len(ops_off)
rec["forward_bitwise"] = bool(torch.equal(y_off, y_on))
mesh.close()

# -- the acceptance plans (tests/test_obs.py:318-370) ----------------------
mesh = make_mesh((2, 4), ("y", "z"), device="cpu")
tracer = obs.enable()
rec["plans"] = {}
for label, impl, k in (("alltoall-k2", "alltoall", 2), ("ring-k1", "ring", 1)):
    plan = Croft3D((N, N, N), mesh, Decomposition("pencil", ("y", "z")),
                   FFTOptions(overlap_k=k, transpose_impl=impl,
                              output_layout="spectral"))
    x = block(plan, 1)
    y, summary = instrument.trace_forward(plan, x, tracer=tracer, iters=2,
                                          label=label)
    with torch.no_grad():
        want = plan.forward(x)
    rec["plans"][label] = dict(
        summary=summary, n_stages=len(plan._forward_schedule().stages),
        err=float((y - want).abs().max() / want.abs().max()))

# -- a short meshless service run under the same tracer (rank 0) ----------
if rank == 0:
    rng = np.random.RandomState(0)
    xs = (rng.randn(8, 8, 8) + 1j * rng.randn(8, 8, 8)).astype(np.complex64)
    with TransformService(device="cpu", max_batch=4,
                          max_wait_ms=2.0) as svc:
        futs = [svc.submit(xs) for _ in range(5)]
        rec["served"] = all(f.result(timeout=120).ok for f in futs)
    tracer.save(os.path.join(out, "trace.json"))
obs.disable()

with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f, default=str)
leave(mesh)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.json")
    run_multidevice(REFERENCE % (N, path), n_devices=8)
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER % N, 8, [out], out)
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(8)]
    with open(out / "trace.json") as f:
        recs[0]["trace"] = json.load(f)
    recs[0]["trace_path"] = str(out / "trace.json")
    return recs


# --- the ring-round hook -----------------------------------------------------

def test_identity_ring_callback_is_bitwise(ranks):
    for r in ranks:
        assert r["hook_bitwise"] and r["wrap_bitwise"], r["rank"]


def test_ring_callback_sees_every_round(ranks):
    for r in ranks:
        # stage 0 rings over data (P=2): round 1; stage 1 over model (P=4)
        assert sorted(set(r["seen"])) == [1, 2, 3], r["seen"]
        assert r["seen"].count(1) == 2, r["seen"]


def test_ring_round_receives_the_ring_piece(ranks):
    for r in ranks:
        assert r["round_piece_equal"] and r["round0_own_piece"], r["rank"]


def test_trace_forward_times_ring_rounds(ranks):
    for r in ranks:
        assert r["rounds"] == {"x-fft+xy": [1], "y-fft+yz": [1, 2, 3]}, \
            r["rounds"]
        assert r["round_span"]


# --- the zero-cost pin -------------------------------------------------------

def test_tracer_changes_no_op_on_a_mesh(ranks):
    for r in ranks:
        assert r["same_ops"] and r["forward_bitwise"], (r["rank"], r["n_ops"])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_tracer_changes_no_op_meshless(problem):
    plan = Croft3D((8, 8, 8), problem=problem, device="cpu",
                   opts=FFTOptions(local_impl="pallas"))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8, 8, 8), generator=g).to(plan.input_dtype)
    runs = []
    for on in (False, True):
        if on:
            obs.enable()
        try:
            with torch.no_grad(), _Ops() as m:
                y = plan.forward(x)
        finally:
            obs.disable()
        runs.append((m.ops, y))
    assert runs[0][0] == runs[1][0] and runs[0][0]
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_meshless_plan_gets_only_the_e2e_span(problem):
    plan = Croft3D((8, 8, 8), problem=problem, device="cpu")
    x = torch.randn((8, 8, 8), generator=torch.Generator().manual_seed(4)
                    ).to(plan.input_dtype)
    tracer = obs.enable()
    try:
        y, summary = instrument.trace_forward(plan, x, tracer=tracer,
                                              iters=1)
        events = tracer.events()
        meta = tracer.meta()["attribution"]
    finally:
        obs.disable()
    # the attribution's own spans (each names its plan) are the e2e one;
    # the plan's hot-path spans lie inside it
    assert [e["name"] for e in events if "plan" in e["args"]] == ["e2e"]
    (e2e,) = [e for e in events if e["name"] == "e2e"]
    inner = [e for e in events if e is not e2e]
    assert {e["name"] for e in inner} >= {"croft3d:forward", "stage:fft"}
    assert all(e2e["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= e2e["ts"] + e2e["dur"] for e in inner)
    assert summary["stages"] == [] and summary["overall"] is None
    assert "note" in summary and summary["plan"] == "meshless"
    assert meta == [summary]
    with torch.no_grad():
        assert torch.equal(y, plan.forward(x))


# --- the acceptance plans ----------------------------------------------------

@pytest.mark.parametrize("label", PLANS)
def test_acceptance_plan_attribution(ranks, label):
    got = ranks[0]["plans"][label]
    s = got["summary"]
    assert got["err"] < TOL, got["err"]
    assert s["overall"] is not None
    assert 0.0 <= s["overall"]["efficiency"] <= 1.0
    assert sum(1 for row in s["stages"] if row["comm_s"] > 0) == 2
    assert len(s["stages"]) == got["n_stages"]
    for row in s["stages"]:
        assert row["model"] is not None  # joined against per_stage_costs
        assert row["hlo"].get("hlo_collectives", 0) >= 0
        if row["comm_s"] > 0:
            assert 0.0 <= row["measured_efficiency"] <= 1.0
            assert row["hidden_s"] <= row["comm_s"]


@pytest.mark.parametrize("label", PLANS)
def test_every_rank_returns_the_same_summary(ranks, label):
    first = json.dumps(ranks[0]["plans"][label]["summary"], sort_keys=True)
    for r in ranks[1:]:
        assert json.dumps(r["plans"][label]["summary"],
                          sort_keys=True) == first, r["rank"]


@pytest.mark.parametrize("label", PLANS)
def test_summary_keys_match_reference(ranks, reference, label):
    got, want = ranks[0]["plans"][label]["summary"], reference[label]
    assert set(got) == set(want)
    assert [r["name"] for r in got["stages"]] == [r["name"]
                                                  for r in want["stages"]]
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w), g["name"]
        assert (g["stage"], g["category"], g["k_eff"]) == (
            w["stage"], w["category"], w["k_eff"])
        assert set(g["model"]) == set(w["model"])
        assert [r["round"] for r in g.get("rounds", [])] == [
            r["round"] for r in w.get("rounds", [])]
    assert set(got["overall"]) == set(want["overall"])
    assert (got["plan_key"], got["shape"], got["transpose_impl"],
            got["overlap_k"]) == (want["plan_key"], want["shape"],
                                  want["transpose_impl"], want["overlap_k"])


@pytest.mark.parametrize("label", PLANS)
def test_counted_collectives_match_reference_hlo(ranks, reference, label):
    """The ``hlo`` row from ``Mesh.counting()`` has the reference's
    collective keys and counts; only ``hlo_flops``/``hlo_bytes`` are
    left out."""
    got, want = ranks[0]["plans"][label]["summary"], reference[label]
    for g, w in zip(got["stages"], want["stages"]):
        ref = {k: v for k, v in w["hlo"].items()
               if k not in ("hlo_flops", "hlo_bytes")}
        assert set(g["hlo"]) == set(ref), g["name"]
        counts = {k: v for k, v in ref.items() if k.endswith("_count")
                  or k == "hlo_collectives"}
        assert {k: g["hlo"][k] for k in counts} == counts, g["name"]


# --- the report and the trace ------------------------------------------------

@pytest.mark.parametrize("label", PLANS)
def test_render_plan_byte_equal_to_reference(ranks, label):
    s = ranks[0]["plans"][label]["summary"]
    text = report.render_plan(s)
    assert text == ref_report.render_plan(s)
    assert "overlap efficiency" in text and label in text


def test_build_report_and_main_byte_equal_to_reference(ranks):
    doc = ranks[0]["trace"]
    assert report.build_report(doc) == ref_report.build_report(doc)
    assert report.category_rollup(doc["traceEvents"]) == \
        ref_report.category_rollup(doc["traceEvents"])
    for argv in ([ranks[0]["trace_path"]], [ranks[0]["trace_path"], "--json"]):
        outs = []
        for mod in (report, ref_report):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert mod.main(argv) == 0
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]


def test_trace_passes_the_trace_smoke_validation(ranks):
    root = os.path.dirname(torch_ranks.TESTS)
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks.trace_smoke import _validate
    assert ranks[0]["served"]
    expected = {label: ranks[0]["plans"][label]["n_stages"]
                for label in PLANS}
    assert _validate(ranks[0]["trace"], expected) == []
    attrib = ranks[0]["trace"]["metadata"]["attribution"]
    assert [a["plan"] for a in attrib] == list(PLANS)
