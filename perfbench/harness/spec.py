"""What ``BENCHMARK.json`` names, found by name under ``perfbench/``.

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``;
- a per-layer metric: the reader ``metrics/<name>.py``;
- a plain reference: ``reference/<name>.py``, named by the configuration;
- a cell's limits for ``correct``: ``limits/<cell>.json``.

Modules are loaded from their files, so a name needs to be no Python
identifier, and a later cell, mix or metric is a new file and a new
entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

from perfbench.harness.traffic import Traffic

HERE = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = HERE.parent


def load_module(path: Path, prefix: str):
    name = f"perfbench_{prefix}_{path.stem}".replace("-", "_").replace(".", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Traffic:
        return Traffic.load(HERE / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return json.loads((HERE / "limits" / f"{cell}.json").read_text())

    def reference(self, name: str):
        return load_module(HERE / "reference" / f"{name}.py", "reference")

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py", "metric")

    def end_to_end(self, cell: str) -> list:
        """Every cell reports every end-to-end metric."""
        return self.doc["end_to_end"]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics whose ``workloads`` list this cell."""
        return [m for m in self.doc["per_layer"] if cell in m["workloads"]]
