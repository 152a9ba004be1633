"""Nothing the benchmark loads is JAX or the JAX package ``repro``
(compared by whole top-level names: ``repro_torch`` is another name), and
nothing under ``perfbench/`` reads the JAX package's ``benchmarks/``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

LOAD_ALL = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import perfbench.run as run
from perfbench import control
from perfbench.harness import cell, check, fields, spec, timeline, traffic, work
from repro_torch.core import Croft3D, Decomposition, FFTOptions, poisson_solve
from repro_torch.core.mesh import make_mesh
from repro_torch.launch.mesh import join_world
from repro_torch.kernels import _build
bench = spec.Bench()
for c in bench.doc["configs"]:
    bench.reference(bench.config(c["name"])["reference"])
for m in bench.doc["per_layer"]:
    bench.reader(m["name"])
print(json.dumps({"top": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": run.forbidden_modules()}))
"""


def test_nothing_loaded_is_jax_or_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", LOAD_ALL, str(ROOT)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in got["top"] and "perfbench" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])
    assert got["forbidden"] == []


def test_forbidden_compares_whole_top_level_names():
    import perfbench.run as run
    assert run.forbidden_modules(["repro_torch.core", "reprox", "jax_like",
                                  "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]


def test_no_file_reads_the_jax_benchmarks():
    pat = re.compile(r"^\s*(from|import)\s+(benchmarks|repro|jax)\b|"
                     r"['\"]benchmarks/", re.M)
    for path in HERE.rglob("*.py"):
        if path.name != Path(__file__).name:
            assert not pat.search(path.read_text()), path
