"""The port's copies of the metrics registry, the span tracer and the
fault-injection plane against the reference's modules: the same calls
give the same exposition text, span records and fired counts."""

import pytest

from repro.obs import metrics as ref_metrics
from repro.obs import tracer as ref_tracer
from repro.resil import inject as ref_inject
from repro_torch.obs import metrics, tracer
from repro_torch.resil import inject


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("tune_measure_runs", "timed candidates").inc(3)
    reg.counter("wisdom_corrupt_files").inc()
    g = reg.gauge("collective_alpha_s", "fitted alpha")
    g.set(2.5e-6)
    g.inc(1e-6)
    g.dec(0.5e-6)
    h = reg.histogram("latency_s", "request latency")
    for v in (1e-6, 3e-5, 3e-5, 2e-3, 0.4, 7.0, 1e4):
        h.observe(v)
    b = reg.histogram("batch_size", bounds=range(1, 9))
    for v in (1, 2, 2, 3, 8, 8, 8, 9):
        b.observe(v)
    with pytest.raises(TypeError):
        reg.gauge("tune_measure_runs")
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    return reg


def test_registry_exposition_matches_reference():
    ref, got = _drive_registry(ref_metrics), _drive_registry(metrics)
    assert got.to_prometheus() == ref.to_prometheus()
    assert got.snapshot() == ref.snapshot()
    assert got.snapshot_json(sort_keys=True) == ref.snapshot_json(
        sort_keys=True)
    assert got.names() == ref.names()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert (got.histogram("latency_s").quantile(q)
                == ref.histogram("latency_s").quantile(q))


def test_default_registry_slot():
    reg = metrics.MetricsRegistry()
    prev = metrics.get_registry()
    try:
        metrics.set_registry(reg)
        assert metrics.get_registry() is reg
    finally:
        metrics.set_registry(prev)


def _drive_tracer(mod):
    with mod.tracing() as tr:
        with mod.tag_scope(traffic="tuning"):
            with mod.get_tracer().span("tune:measure", "plan", key="k",
                                       n_pool=3) as sp:
                with mod.get_tracer().span("measure:candidate", "plan",
                                           plan="slab[p]/k1", batch=1):
                    pass
                sp.set(winner="slab[p]/k1")
            mod.get_tracer().instant("wisdom:hit", "plan", {"key": "k"})
        try:
            with mod.get_tracer().span("measure:candidate", "plan"):
                raise RuntimeError("x")
        except RuntimeError:
            pass
        tr.complete("queue", "queue", tr.t0, tr.t0 + 1e-3, {"n": 2})
        tr.add_meta("plan", "pencil")
    assert mod.get_tracer() is mod.NOOP
    return tr


def _records(tr):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                        "tid")}
            for ev in tr.events()]


def test_tracer_records_match_reference():
    ref, got = _drive_tracer(ref_tracer), _drive_tracer(tracer)
    assert _records(got) == _records(ref)
    assert got.meta() == ref.meta()
    doc = got.to_chrome()
    assert doc["metadata"]["dropped_events"] == 0
    assert tracer.CATEGORIES == ref_tracer.CATEGORIES
    # the default tracer records nothing
    with tracer.get_tracer().span("x"):
        pass
    assert tracer.NOOP.events() == []


def test_tracer_ring_buffer_drops_like_reference():
    for mod in (ref_tracer, tracer):
        tr = mod.Tracer(capacity=3)
        for i in range(5):
            tr.instant(f"e{i}")
        assert [e["name"] for e in tr.events()] == ["e2", "e3", "e4"]
        assert tr.dropped == 2


def _drive_inject(mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    prev = reg_mod.get_registry()
    reg_mod.set_registry(reg)
    raised = []
    try:
        specs = [mod.FaultSpec("tune.measure", times=(0, 2)),
                 mod.FaultSpec("wisdom.write.crash", kind="crash",
                               match="w.json"),
                 mod.FaultSpec("exec.output", times=(1,), kind="nan")]
        with mod.injection(specs, seed=7) as plan:
            for i in range(4):
                try:
                    mod.fire("tune.measure", f"cand{i}")
                except mod.InjectedFault as e:
                    raised.append((type(e).__name__, e.site, e.key, e.index))
            for path in ("a.json", "w.json"):
                try:
                    mod.fire("wisdom.write.crash", path)
                except mod.InjectedFault as e:
                    raised.append((type(e).__name__, e.site, e.key, e.index))
            poisoned = [mod.corrupt("exec.output", "s") for _ in range(3)]
            fired = list(plan.fired)
            counts = (plan.fired_counts(), plan.predicted_counts())
        assert mod.get_plan() is None
        mod.fire("tune.measure", "after")           # disarmed: no-op
        return raised, poisoned, fired, counts, reg.snapshot()
    finally:
        reg_mod.set_registry(prev)


def test_inject_fires_like_reference():
    assert inject.SITES == ref_inject.SITES
    assert inject.KINDS == ref_inject.KINDS
    assert (_drive_inject(inject, metrics)
            == _drive_inject(ref_inject, ref_metrics))


def test_seeded_times_match_reference():
    for seed in (0, 1, 42):
        for site in ("tune.measure", "plan.build"):
            assert (inject.seeded_times(seed, site, 20, 5)
                    == ref_inject.seeded_times(seed, site, 20, 5))
    with pytest.raises(ValueError):
        inject.FaultSpec("tune.measure", kind="boom")
