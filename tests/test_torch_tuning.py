"""The port's tuner (``repro_torch.tuning``) against the reference's
(``repro.tuning``), meshless.

Candidates, plan keys, labels, schedule-search keys and wisdom keys are
byte-equal to the reference's on the shapes of ``tests/test_tuning.py``
and ``tests/test_schedule_search.py``.  With the reference's constants
patched into the port's cost model, every cost term, per-stage row,
ranking and predicted collective count equals the reference's; with
the port's own H100 priors the reference's qualitative model tests hold.
Wisdom files cross between the packages in both directions.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro import tuning as ref_tuning
from repro.core import Decomposition as RefDecomposition
from repro.core import FFTOptions as RefFFTOptions
from repro.obs import metrics as ref_metrics
from repro.tuning import candidates as ref_cand
from repro.tuning import cost_model as ref_cost
from repro.tuning import planner as ref_planner
from repro.tuning import wisdom as ref_wisdom
from repro_torch import tuning
from repro_torch.core import Croft3D, Decomposition, FFTOptions
from repro_torch.kernels import KernelError
from repro_torch.obs import metrics as metrics_lib
from repro_torch.resil import inject
from repro_torch.tuning import candidates as cand_lib
from repro_torch.tuning import cost_model, measure, planner
from repro_torch.tuning import wisdom as wisdom_lib
from repro_torch.tuning.candidates import ScheduleCandidate

SIZES = {"data": 2, "model": 4}          # tests/test_tuning.py:19
SHAPE = (32, 32, 32)                     # tests/test_tuning.py:20
GATE_SHAPE = (512, 512, 4)               # tests/test_schedule_search.py:32
MIXED_KEY = ("sched:pencil[data,model]|k1/matmul/spectral/alltoall/"
             "pipelined|f0.t0s0c1h2r;f1.t1s1c2h0k2;f2")
REL = 1e-12
#: the cost model's constants, patched from the reference in
#: ``reference_constants``
CONSTANTS = ("IMPL_EFFICIENCY", "_DEFAULT_EFFICIENCY", "LOCAL_PASSES",
             "COLLECTIVE_LATENCY_S", "REPLAN_PASSES", "PEAK_FLOPS",
             "HBM_BW", "LINK_BW")

SPACES = {
    "c2c": dict(),
    "r2c": dict(problem="r2c"),
    "c2c_grad": dict(problem="c2c_grad"),
    "r2c_grad": dict(problem="r2c_grad"),
    "heterogeneous": dict(heterogeneous_impls=True),
    "baselines": dict(include_baselines=True),
}
MESHES = {"pencil": SIZES, "slab": {"p": 8}, "cell": {"a": 2, "b": 2, "c": 2}}


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's constants in the port's cost model, and no
    calibration in either package."""
    for name in CONSTANTS:
        monkeypatch.setattr(cost_model, name, getattr(ref_cost, name))
    monkeypatch.delenv(cost_model.CALIBRATION_ENV, raising=False)
    for mod in (metrics_lib, ref_metrics):
        for g in ("collective_alpha_s", "collective_beta_s_per_byte"):
            gauge = mod.get_registry().gauge(g)
            monkeypatch.setattr(gauge, "_value", 0.0)


def _close(a, b) -> bool:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b or abs(a - b) <= REL * max(abs(a), abs(b))
    return a == b


# --- candidates and plan keys -------------------------------------------------

@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_candidate_lists_byte_equal(space, mesh):
    kw, sizes = SPACES[space], MESHES[mesh]
    ref = ref_tuning.enumerate_candidates(SHAPE, sizes, **kw)
    got = tuning.enumerate_candidates(SHAPE, sizes, **kw)
    assert ref, "the reference's search space must be non-empty"
    assert [c.plan_key for c in got] == [c.plan_key for c in ref]
    assert [c.label for c in got] == [c.label for c in ref]
    for c in got:
        assert tuning.Candidate.from_plan_key(c.plan_key) == c


@pytest.mark.parametrize("shape", [(30, 30, 30), (32, 32, 16)])
def test_divisibility_filters_match(shape):
    assert ([c.plan_key for c in tuning.enumerate_candidates(shape, SIZES)]
            == [c.plan_key
                for c in ref_tuning.enumerate_candidates(shape, SIZES)])


@pytest.mark.parametrize("problem", ["c2c", "r2c", "c2c_grad", "r2c_grad"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_default_candidate_matches(problem, mesh):
    sizes = MESHES[mesh]
    ref = ref_tuning.default_candidate(SHAPE, sizes, problem=problem)
    got = tuning.default_candidate(SHAPE, sizes, problem=problem)
    assert got.plan_key == ref.plan_key and got.label == ref.label


@pytest.mark.parametrize("shape", [GATE_SHAPE, (64, 64, 4)])
def test_schedule_candidate_keys_byte_equal(shape):
    ref = ref_cand.enumerate_schedule_candidates(shape, SIZES)
    got = cand_lib.enumerate_schedule_candidates(shape, SIZES)
    assert ref and [c.plan_key for c in got] == [c.plan_key for c in ref]
    assert [c.label for c in got] == [c.label for c in ref]
    deduped = cand_lib.dedupe_candidates(
        list(tuning.enumerate_candidates(shape, SIZES)) + got)
    want = ref_cand.dedupe_candidates(
        list(ref_tuning.enumerate_candidates(shape, SIZES)) + ref)
    assert [c.plan_key for c in deduped] == [c.plan_key for c in want]


def test_schedule_describe_matches_reference():
    for key in (MIXED_KEY,):
        got = ScheduleCandidate.from_plan_key(key)
        ref = ref_cand.ScheduleCandidate.from_plan_key(key)
        assert got.build_schedule().describe() \
            == ref.build_schedule().describe()
        assert got.stage_summary() == ref.stage_summary()


# --- cost model with the reference's constants ---------------------------------

def _cost_pairs(shape, kw):
    ref = ref_tuning.enumerate_candidates(shape, SIZES, **kw)
    got = tuning.enumerate_candidates(shape, SIZES, **kw)
    return list(zip(ref, got))


@pytest.mark.parametrize("space", ["c2c", "r2c", "c2c_grad", "r2c_grad",
                                   "baselines"])
@pytest.mark.parametrize("batch", [1, 3])
def test_cost_terms_equal_reference(reference_constants, space, batch):
    for ref, got in _cost_pairs(SHAPE, SPACES[space]):
        a = ref_cost.analytic_cost(SHAPE, ref, SIZES, jnp.complex64,
                                   batch).to_dict()
        b = cost_model.analytic_cost(SHAPE, got, SIZES, torch.complex64,
                                     batch).to_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert _close(a[k], b[k]), (got.label, k, a[k], b[k])
        ra = ref_cost.per_stage_costs(SHAPE, ref, SIZES, jnp.complex64,
                                      batch)
        rb = cost_model.per_stage_costs(SHAPE, got, SIZES, torch.complex64,
                                        batch)
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert x.keys() == y.keys()
            for k in x:
                assert _close(x[k], y[k]), (got.label, k, x[k], y[k])


def test_searched_costs_equal_reference(reference_constants):
    ref = ref_cand.enumerate_schedule_candidates(GATE_SHAPE, SIZES)
    got = cand_lib.enumerate_schedule_candidates(GATE_SHAPE, SIZES)
    for r, g in zip(ref, got):
        a = ref_cost.analytic_cost(GATE_SHAPE, r, SIZES).to_dict()
        b = cost_model.analytic_cost(GATE_SHAPE, g, SIZES).to_dict()
        for k in a:
            assert _close(a[k], b[k]), (g.plan_key, k)
        assert (cost_model.per_stage_costs(GATE_SHAPE, g, SIZES)
                == ref_cost.per_stage_costs(GATE_SHAPE, r, SIZES))
        sched_r, sched_g = r.build_schedule(), g.build_schedule()
        assert (cost_model.predicted_collectives(sched_g, GATE_SHAPE, SIZES,
                                                 g.opts)
                == ref_cost.predicted_collectives(sched_r, GATE_SHAPE, SIZES,
                                                  r.opts))


@pytest.mark.parametrize("space", ["c2c", "r2c", "c2c_grad", "baselines"])
def test_rankings_and_predictions_equal_reference(reference_constants, space):
    pairs = _cost_pairs(SHAPE, SPACES[space])
    ref = ref_cost.rank_candidates(SHAPE, [r for r, _ in pairs], SIZES)
    got = cost_model.rank_candidates(SHAPE, [g for _, g in pairs], SIZES)
    assert [c.plan_key for c, _ in got] == [c.plan_key for c, _ in ref]
    for r, g in pairs:
        sr = ref_cost.schedules_for(SHAPE, r)
        sg = cost_model.schedules_for(SHAPE, g)
        assert [s.describe() for s in sg] == [s.describe() for s in sr]
        for a, b in zip(sr, sg):
            assert (cost_model.predicted_collectives(b, SHAPE, SIZES, g.opts)
                    == ref_cost.predicted_collectives(a, SHAPE, SIZES,
                                                      r.opts))


@pytest.mark.parametrize("search,problem", [
    ("options", "c2c"), ("options", "c2c_grad"), ("options", "r2c"),
    ("options", "r2c_grad"), ("schedule", "c2c"), ("schedule", "c2c_grad")])
def test_model_mode_pick_equals_reference(reference_constants, search,
                                          problem):
    shape = GATE_SHAPE if search == "schedule" else SHAPE
    ref = ref_planner.tune(shape, axis_sizes=SIZES, mode="model",
                           problem=problem, search=search, save=False)
    got = planner.tune(shape, axis_sizes=SIZES, mode="model",
                       problem=problem, search=search, save=False)
    assert got.key == ref.key
    assert got.summary() == ref.summary()
    assert [r["label"] for r in got.ranked] == [r["label"] for r in ref.ranked]


# --- cost model with the H100 priors --------------------------------------------

def test_priors_are_the_cards():
    from repro_torch.launch import roofline
    assert cost_model.PEAK_FLOPS == roofline.PEAK_FLOPS_FP32 == 67e12
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert set(cost_model.IMPL_EFFICIENCY) == set(ref_cost.IMPL_EFFICIENCY)
    assert cost_model.collective_constants() == (
        cost_model.COLLECTIVE_LATENCY_S, 1.0 / cost_model.LINK_BW)


def test_spectral_beats_natural_on_comm_bytes():
    dec = Decomposition("pencil", ("data", "model"))
    nat = tuning.analytic_cost(
        SHAPE, tuning.Candidate(dec, FFTOptions(output_layout="natural")),
        SIZES)
    spec = tuning.analytic_cost(
        SHAPE, tuning.Candidate(dec, FFTOptions(output_layout="spectral")),
        SIZES)
    assert spec.collective_bytes == nat.collective_bytes / 2
    assert spec.total_s < nat.total_s


def test_pairwise_and_replan_are_penalised():
    dec = Decomposition("slab", ("model",))
    base = tuning.analytic_cost(
        SHAPE, tuning.Candidate(dec, FFTOptions(overlap_k=1)), SIZES)
    pair = tuning.analytic_cost(
        SHAPE, tuning.Candidate(
            dec, FFTOptions(overlap_k=1, transpose_impl="pairwise")), SIZES)
    noplan = tuning.analytic_cost(
        SHAPE, tuning.Candidate(
            dec, FFTOptions(overlap_k=1, plan_cache=False)), SIZES)
    assert pair.n_collectives > base.n_collectives
    assert pair.total_s > base.total_s
    assert noplan.replan_s > 0 and noplan.total_s > base.total_s


def test_overlap_hides_communication():
    dec = Decomposition("pencil", ("data", "model"))
    big = (256, 256, 256)
    k1 = tuning.analytic_cost(
        big, tuning.Candidate(dec, FFTOptions(overlap_k=1)), SIZES)
    k2 = tuning.analytic_cost(
        big, tuning.Candidate(dec, FFTOptions(overlap_k=2)), SIZES)
    assert k2.total_s < k1.total_s


def test_mixed_schedule_beats_homogeneous_at_gate_point():
    """The reference's search-bench gate A under the card's priors."""
    mixed = ScheduleCandidate.from_plan_key(MIXED_KEY)
    base = mixed.opts
    plain = tuple(dataclasses.replace(sp, impl=None, k=None)
                  for sp in mixed.stages)
    hom_ring = dataclasses.replace(
        mixed, opts=dataclasses.replace(base, transpose_impl="ring"),
        stages=plain)
    hom_a2a_k2 = dataclasses.replace(
        mixed, opts=dataclasses.replace(base, overlap_k=2), stages=plain)
    t = {c: cost_model.analytic_cost(GATE_SHAPE, c, SIZES).total_s
         for c in (mixed, hom_ring, hom_a2a_k2)}
    assert t[mixed] < t[hom_ring]
    assert t[mixed] < t[hom_a2a_k2]


def test_calibration_precedence(tmp_path, monkeypatch):
    """Registry gauges > ``$CROFT_CALIBRATION`` > the priors; a
    non-positive fit is ignored."""
    reg = metrics_lib.get_registry()
    ga = reg.gauge("collective_alpha_s")
    gb = reg.gauge("collective_beta_s_per_byte")
    monkeypatch.setattr(ga, "_value", 0.0)
    monkeypatch.setattr(gb, "_value", 0.0)
    monkeypatch.delenv(cost_model.CALIBRATION_ENV, raising=False)
    path = str(tmp_path / "calibration.json")
    with open(path, "w") as f:
        json.dump({"collective_alpha_s": 3e-6,
                   "collective_beta_s_per_byte": 2e-11}, f)
    monkeypatch.setenv(cost_model.CALIBRATION_ENV, path)
    assert cost_model.collective_constants() == (3e-6, 2e-11)
    ga.set(5e-6)
    gb.set(-1.0)
    assert cost_model.collective_constants() == (5e-6, 2e-11)


# --- wisdom --------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["c2c", "r2c", "c2c_grad", "r2c_grad"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("backend", ["cpu", "any"])
def test_wisdom_keys_byte_equal(problem, batch, backend):
    for sizes in MESHES.values():
        for dt, jdt in ((torch.complex64, jnp.complex64),
                        (torch.complex128, jnp.complex128)):
            assert (wisdom_lib.wisdom_key(SHAPE, sizes, dt, backend, problem,
                                          batch)
                    == ref_wisdom.wisdom_key(SHAPE, sizes, jdt, backend,
                                             problem, batch))
            key = wisdom_lib.wisdom_key(SHAPE, sizes, dt, backend, problem,
                                        batch)
            assert wisdom_lib.wisdom_key(**_parse_key(key)) == key


def test_backend_field():
    class FakeMesh:
        def __init__(self, device):
            self.device = torch.device(device)
    assert wisdom_lib.backend_of(None) == "any"
    assert wisdom_lib.backend_of(FakeMesh("cpu")) == "cpu"
    assert wisdom_lib.backend_of(FakeMesh("cuda")) == "gpu"


def _entries(mod, cand_mod):
    folded = Decomposition("pencil", (("a", "b"), "c"))
    slab = Decomposition("slab", ("p",))
    keys = [tuning.Candidate(folded, FFTOptions(
                overlap_k=4, output_layout="spectral")).plan_key,
            tuning.Candidate(slab, FFTOptions(
                local_impl=("stockham", "xla", "matmul"),
                transpose_impl="ring"), problem="r2c",
                strategy="embed").plan_key]
    cands = [cand_mod.Candidate.from_plan_key(k) for k in keys]
    cands.append(cand_mod.ScheduleCandidate.from_plan_key(MIXED_KEY))
    return {f"k{i}": mod.WisdomEntry.from_candidate(c, "measure",
                                                     model_s=1e-4,
                                                     measured_s=2e-4 + i)
            for i, c in enumerate(cands)}


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_wisdom_files_cross(tmp_path, direction):
    path = str(tmp_path / "w.json")
    writer, reader = ((wisdom_lib, ref_wisdom) if direction == "port->ref"
                      else (ref_wisdom, wisdom_lib))
    wcand = cand_lib if writer is wisdom_lib else ref_cand
    w = writer.Wisdom(_entries(writer, wcand), path=path)
    w.save()
    got = reader.Wisdom.load(path)
    assert sorted(got.entries) == sorted(w.entries)
    for key, e in w.entries.items():
        back = got.lookup(key)
        assert back.measured_s == e.measured_s
        assert back.candidate().plan_key == e.candidate().plan_key
    # a merge through the other package keeps the file's checksum valid
    reader.merge_entries(path, {})
    assert sorted(writer.Wisdom.load(path).entries) == sorted(w.entries)
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt-1")


def test_checksum_mismatch_quarantines(tmp_path):
    path = str(tmp_path / "w.json")
    wisdom_lib.Wisdom(_entries(wisdom_lib, cand_lib), path=path).save()
    blob = json.load(open(path))
    blob["entries"]["k0"]["measured_s"] = 9.0
    json.dump(blob, open(path, "w"))
    before = metrics_lib.get_registry().counter("wisdom_corrupt_files").value
    assert len(wisdom_lib.Wisdom.load(path)) == 0
    assert os.path.exists(path + ".corrupt-1") and not os.path.exists(path)
    assert (metrics_lib.get_registry().counter("wisdom_corrupt_files").value
            == before + 1)
    # unparseable -> the next free quarantine name
    with open(path, "w") as f:
        f.write("{not json")
    assert len(wisdom_lib.Wisdom.load(path)) == 0
    assert os.path.exists(path + ".corrupt-2")


def test_newer_version_is_not_quarantined(tmp_path):
    path = str(tmp_path / "w.json")
    json.dump({"version": wisdom_lib.WISDOM_VERSION + 1, "entries": {}},
              open(path, "w"))
    assert len(wisdom_lib.Wisdom.load(path)) == 0
    assert os.path.exists(path)


def test_crash_mid_write_leaves_store_intact(tmp_path):
    path = str(tmp_path / "w.json")
    entries = _entries(wisdom_lib, cand_lib)
    wisdom_lib.merge_entries(path, {"k0": entries["k0"]})
    with inject.injection([inject.FaultSpec("wisdom.write.crash",
                                            kind="crash")]):
        with pytest.raises(inject.CrashMidWrite):
            wisdom_lib.merge_entries(path, {"k1": entries["k1"]})
    assert sorted(wisdom_lib.Wisdom.load(path).entries) == ["k0"]
    assert os.path.exists(path + ".tmp")
    # the next locked merge cleans the stale temp file up
    wisdom_lib.merge_entries(path, {"k1": entries["k1"]})
    assert sorted(wisdom_lib.Wisdom.load(path).entries) == ["k0", "k1"]
    assert not os.path.exists(path + ".tmp")


def test_file_lock_excludes_and_breaks_stale(tmp_path):
    lock = str(tmp_path / "w.json.lock")
    with wisdom_lib._FileLock(lock):
        assert os.path.exists(lock)
        with pytest.raises(TimeoutError):
            with wisdom_lib._FileLock(lock, timeout=0.1):
                pass
    assert not os.path.exists(lock)
    open(lock, "w").close()
    os.utime(lock, (0, 0))                  # a writer that died long ago
    with wisdom_lib._FileLock(lock, timeout=1.0, stale_s=30.0):
        assert os.path.exists(lock)
    assert not os.path.exists(lock)


def test_better_of_matches_reference():
    c = tuning.Candidate(Decomposition("slab", ("p",)), FFTOptions())
    rc = ref_tuning.Candidate(RefDecomposition("slab", ("p",)),
                              RefFFTOptions())
    for a, b in ((dict(measured_s=2e-3), dict(measured_s=1e-3)),
                 (dict(measured_s=1e-3), dict(model_s=1e-9)),
                 (dict(model_s=1e-3), dict(model_s=2e-3))):
        port = wisdom_lib.WisdomEntry.from_candidate(c, "x", **a).better_of(
            wisdom_lib.WisdomEntry.from_candidate(c, "x", **b))
        ref = ref_wisdom.WisdomEntry.from_candidate(rc, "x", **a).better_of(
            ref_wisdom.WisdomEntry.from_candidate(rc, "x", **b))
        assert (port.measured_s, port.model_s) == (ref.measured_s,
                                                   ref.model_s)


def test_wisdom_mode_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "w.json")
    r = tuning.tune(SHAPE, axis_sizes=SIZES, mode="wisdom", wisdom_path=path)
    assert r.source == "model"

    def boom(*a, **k):
        raise AssertionError("measurement ran on a wisdom hit")
    monkeypatch.setattr(planner.measure, "measure_candidate", boom)
    r2 = tuning.tune(SHAPE, axis_sizes=SIZES, mode="wisdom", wisdom_path=path)
    assert r2.source == "wisdom"
    assert r2.candidate().plan_key == r.candidate().plan_key


def test_schedule_search_wisdom_round_trip(tmp_path):
    path = str(tmp_path / "w.json")
    r = planner.tune(GATE_SHAPE, axis_sizes=SIZES, mode="model",
                     search="schedule", wisdom_path=path)
    r2 = planner.tune(GATE_SHAPE, axis_sizes=SIZES, mode="wisdom",
                      search="schedule", wisdom_path=path)
    assert r2.source == "wisdom"
    assert r2.candidate().plan_key == r.candidate().plan_key


def test_tune_errors():
    with pytest.raises(ValueError):
        tuning.tune(SHAPE, axis_sizes=SIZES, mode="measure")
    with pytest.raises(ValueError):
        tuning.tune((30, 30, 30), axis_sizes=SIZES, mode="model")
    with pytest.raises(ValueError):
        tuning.tune((32, 32, 32), axis_sizes=SIZES, search="schedule",
                    problem="r2c")


@pytest.mark.parametrize("exc,drops", [
    (None, False),
    (ValueError("plan refused"), True),
    (NotImplementedError("not in this executor"), True),
    (inject.InjectedFault("tune.measure"), True),
    (KernelError("nvcc not found"), None),
    (TypeError("a bug"), None),
])
def test_measure_drops_refused_plans_and_raises_kernel_errors(exc, drops):
    """A refused plan is dropped from the race; a kernel that does not
    build or launch, or any other failure, fails the measurement."""
    if drops is None:
        with pytest.raises(type(exc), match=str(exc)):
            measure._settle(None, exc, 0.25, "cand")
    else:
        assert measure._settle(None, exc, 0.25, "cand") == (drops, 0.25)


def test_croft3d_tuner_errors():
    cand = ScheduleCandidate.from_plan_key(MIXED_KEY)
    with pytest.raises(ValueError, match="needs a mesh"):
        Croft3D(SHAPE, tune="model", device="cpu")
    with pytest.raises(ValueError, match="c2c problem only"):
        Croft3D(SHAPE, schedule=cand, problem="r2c", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        Croft3D(SHAPE, schedule=cand, device="cpu")
    with pytest.raises(ValueError, match="grad=True"):
        Croft3D(SHAPE, problem="c2c_grad", device="cpu")


def test_wisdom_cli(tmp_path, capsys):
    out = str(tmp_path / "m.json")
    assert wisdom_lib._main(["merge", out, "--seed"]) == 0
    assert len(wisdom_lib.Wisdom.load(out)) == len(wisdom_lib.load_seed())
    assert wisdom_lib._main(["show", out]) == 0
    assert wisdom_lib._main(["stats", out]) == 0
    text = capsys.readouterr().out
    assert "|r2c" in text and "by mode:    model=64" in text
    # the reference's CLI reads the port's merged file
    assert ref_wisdom._main(["show", out]) == 0


def _parse_key(key: str) -> dict:
    """The problem a wisdom key names, as ``wisdom_key``'s arguments."""
    fields = key.split("|")
    problem, batch, grad = "c2c", 1, False
    for f in fields[4:]:
        if f == "grad":
            grad = True
        elif f.startswith("b") and f[1:].isdigit():
            batch = int(f[1:])
        else:
            problem = f
    return dict(shape=tuple(int(n) for n in fields[0].split("x")),
                axis_sizes={n: int(v) for n, v in (
                    kv.split("=") for kv in fields[1].split(","))},
                dtype=fields[2], backend=fields[3],
                problem=problem + ("_grad" if grad else ""), batch=batch)


def _regenerate_seed(keys) -> wisdom_lib.Wisdom:
    """How the shipped seed is made: for each key, the plan mode="model"
    picks under the port's cost model.  To rewrite the seed after a
    change of priors, save this over ``SEED_PATH`` for every key of the
    reference's seed."""
    w = wisdom_lib.Wisdom()
    for key in keys:
        k = _parse_key(key)
        r = planner.tune(k["shape"], axis_sizes=k["axis_sizes"],
                         mode="model", dtype=k["dtype"], problem=k["problem"],
                         batch=k["batch"], save=False)
        best = r.schedule or cand_lib.Candidate(
            r.decomp, r.opts, problem=r.problem, strategy=r.strategy)
        w.record(key, wisdom_lib.WisdomEntry.from_candidate(
            best, "model", model_s=r.model_s))
    return w


def test_seed_has_reference_key_set_and_is_regenerated():
    seed = wisdom_lib.load_seed()
    keys = sorted(ref_wisdom.load_seed().entries)
    assert sorted(seed.entries) == keys
    assert all(e.source == "model" for e in seed.entries.values())
    # re-planning every key under the port's priors reproduces the
    # shipped entries
    again = _regenerate_seed(keys)
    for k in keys:
        assert (again.lookup(k).candidate().plan_key
                == seed.lookup(k).candidate().plan_key), k
        assert again.lookup(k).model_s == pytest.approx(
            seed.lookup(k).model_s, rel=1e-12), k
