"""The port's import boundary: ``repro_torch``, ``chip_smoke.py`` and the
port's examples import neither ``jax`` nor the reference package
``repro`` (only the tests import both)."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

from conftest import REPO, SRC

FORBIDDEN = ("jax", "repro")

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "modules")
assert not bad, bad
"""


def _port_modules() -> list:
    return sorted(m.name for m in pkgutil.walk_packages(
        [os.path.join(SRC, "repro_torch")], "repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", CHECK], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert f"{len(_port_modules()) + 1} modules" in proc.stdout
    assert "repro_torch.tuning.planner" in _port_modules()
    assert {"repro_torch.serve.service", "repro_torch.serve.plan_cache",
            "repro_torch.serve.batcher", "repro_torch.serve.request",
            "repro_torch.resil.degrade",
            "repro_torch.train.fault"} <= set(_port_modules())
    assert {"repro_torch.models.moe", "repro_torch.models.moe_sharded",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.configs.mixtral_8x22b"} <= set(_port_modules())
    assert {"repro_torch.models.recurrent", "repro_torch.parallel.seqscan",
            "repro_torch.configs.gemma3_4b", "repro_torch.configs.yi_9b",
            "repro_torch.configs.yi_34b",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.configs.rwkv6_3b"} <= set(_port_modules())
    assert {"repro_torch.train.optimizer", "repro_torch.train.checkpoint",
            "repro_torch.train.data", "repro_torch.train.train_step",
            "repro_torch.parallel.loss",
            "repro_torch.launch.train"} <= set(_port_modules())
    assert {"repro_torch.parallel.compression",
            "repro_torch.parallel.pipeline",
            "repro_torch.launch.dryrun"} <= set(_port_modules())


def _imported_roots(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [
    "chip_smoke.py",
    "examples/quickstart_torch.py",
    "examples/spectral_solver_torch.py",
    "examples/serve_transforms_torch.py",
    "examples/serve_lm_torch.py",
    "examples/train_lm_torch.py",
])
def test_script_imports_nothing_of_jax_or_repro(path):
    roots = _imported_roots(os.path.join(REPO, path))
    assert "repro_torch" in roots or path == "chip_smoke.py"
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


@pytest.mark.parametrize("module", _port_modules())
def test_port_module_source_names_no_forbidden_import(module):
    rel = module.split(".")
    path = os.path.join(SRC, *rel) + ".py"
    if not os.path.exists(path):
        path = os.path.join(SRC, *rel, "__init__.py")
    assert not _imported_roots(path) & set(FORBIDDEN), module
