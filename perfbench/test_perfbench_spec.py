"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from perfbench.harness.spec import HERE, ROOT, Bench

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_names():
    assert set(DOC) == KEYS["top"]
    assert len(json.dumps(DOC)) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[group]]
        assert len(names) == len(set(names)), group
        for e in DOC[group]:
            assert set(e) == KEYS[group], (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            texts = [e[k] for k in ("why", "layer") if k in e]
            if group == "configs":
                texts.append(e["source"])
            for text in texts:
                assert 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_paths_and_command():
    assert DOC["command"][1].startswith("perfbench/")
    assert all(not w.startswith("/") and ".." not in w for w in DOC["command"])
    assert DOC["paths"] == ["perfbench"]
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    cells = 24
    assert (2 + 14 * cells) * (DOC["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_metrics():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert {"step_ms", "latency_p95_ms", "peak_gib", "setup_s"} == set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells, m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells():
    configs = {c["name"] for c in DOC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in DOC["workloads"]}
    assert used == configs
    four = [w for w in DOC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in DOC["workloads"])
    assert len(four) <= max(1, len(DOC["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files_found_by_name(cell):
    bench = Bench()
    w = bench.cell(cell)
    config = bench.config(w["config"])
    entry = next(c for c in DOC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("perfbench/configs/")
    assert Path(ROOT / entry["file"]).stem == w["config"]
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    traffic = bench.traffic(w["traffic"])
    ref = bench.reference(config["reference"])
    assert callable(ref.spectrum) and callable(ref.layout_block)
    limits = bench.limits(cell)
    assert set(limits) == {f"{n}_err" for n, _ in traffic.answers()}
    assert all(0 < v < 1e-3 for v in limits.values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    assert "setup_s" in {m["name"] for m in bench.end_to_end(cell)}
    assert len(bench.end_to_end(cell)) >= 2 and bench.per_layer(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["per_layer"]])
def test_reader_found_by_name(metric):
    mod = Bench().reader(metric)
    assert mod.COMBINE in ("min", "max", "mean") and callable(mod.read)
    assert (HERE / "metrics" / f"{metric}.py").exists()


def test_layers_named_in_perf_md():
    text = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in DOC["per_layer"]}:
        assert f"| {layer} |" in text, layer


def test_run_seconds_gives_a_tail():
    # the slowest cell's step, about 0.2 s, leaves ten steps beyond its
    # p95 in a window of run_seconds
    assert math.floor(DOC["run_seconds"] / 0.2 * 0.05) >= 10
