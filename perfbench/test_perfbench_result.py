"""A whole run of each one-rank cell on the CPU at a small size: the
last line's keys, and ``correct`` from the comparison with the plain
reference."""

import json
import time

import pytest
import torch

from perfbench.harness import cell

CPU = torch.device("cpu")
ONE_RANK = ["croft1024-c2c-roundtrip", "croft1024-r2c-poisson"]


def run(bench, workload, trace, seed=2 ** 31 + 11):
    mine = cell.run_rank(bench, workload, seed, 0.05, trace, CPU, time.time())
    return cell.combine(bench, workload, trace, [mine], CPU)


@pytest.mark.parametrize("workload", ONE_RANK)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(bench, workload, trace):
    res = run(bench, workload, trace)
    json.dumps(res)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 4
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run reads no device metric: only the host clock's
        assert set(res["metrics"]) == {"plan_s"}
    else:
        assert set(res["metrics"]) == {"step_ms", "latency_p95_ms",
                                       "peak_gib", "setup_s"}
        assert all(m["value"] >= 0 for m in res["metrics"].values())
        # set-up's parts, the kernels' build apart, add up to setup_s
        parts = dict(res["setup_parts"])
        assert parts.pop("rank") == 0 and parts["kernels_build"] == 0
        assert sum(parts.values()) == pytest.approx(
            res["metrics"]["setup_s"]["value"], rel=1e-6)
    for name, c in res["checks"].items():
        assert name.endswith("_err") and 0 <= c["value"] <= c["limit"]


def test_same_seed_same_answers(bench):
    a = run(bench, "croft1024-c2c-roundtrip", False, seed=7)
    b = run(bench, "croft1024-c2c-roundtrip", False, seed=7)
    c = run(bench, "croft1024-c2c-roundtrip", False, seed=8)
    assert a["checks"] == b["checks"] != c["checks"]
