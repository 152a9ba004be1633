"""The check has to fail a broken timed path: each fault a cell can have
is planted underneath a whole run (the look for a card skipped, on the
CPU at a small size), and ``correct`` has to come out false.

Faults: a step that hands back its state unchanged; half of the field
left out; one answer altered where it is produced; one step other than
the last altered (seen only by the per-step samples); and, on the
four-rank cell, the exchange between ranks left out.  And a rank other
than the first that loads a module of the JAX package during its window
exits non-zero, so the launcher prints no result.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench.harness import cell

CPU = torch.device("cpu")
HERE = Path(__file__).resolve().parent


def run(bench, workload, seed=2 ** 31 + 3):
    mine = cell.run_rank(bench, workload, seed, 0.05, False, CPU, time.time())
    return cell.combine(bench, workload, False, [mine], CPU)


def unchanged(out, inp):
    return inp.clone()


def half_left_out(out, inp):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def one_altered(out, inp):
    out = out.clone()
    out.view(-1)[37] += 0.01 * out.abs().max()
    return out


def altered_in_one_step(step: int):
    calls = {"n": 0}

    def fault(out, inp):
        calls["n"] += 1
        return out * 1.001 if calls["n"] == step else out
    return fault


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "one_altered": one_altered}


def plant(monkeypatch, where: str, fault) -> None:
    from repro_torch import core
    from repro_torch.core.api import Croft3D
    if where == "poisson_solve":
        real = core.poisson_solve
        monkeypatch.setattr(core, "poisson_solve",
                            lambda f, plan, **kw: fault(real(f, plan, **kw), f))
        return
    real = getattr(Croft3D, where)
    monkeypatch.setattr(Croft3D, where,
                        lambda self, x: fault(real(self, x), x))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload, where", [
    ("croft1024-c2c-roundtrip", "forward"),
    ("croft1024-c2c-roundtrip", "inverse"),
    ("croft1024-r2c-poisson", "poisson_solve")])
def test_fault_is_not_correct(bench, monkeypatch, workload, where, fault):
    plant(monkeypatch, where, FAULTS[fault])
    assert run(bench, workload)["correct"] is False


@pytest.mark.parametrize("workload, where", [
    ("croft1024-c2c-roundtrip", "forward"),
    ("croft1024-r2c-poisson", "poisson_solve")])
def test_one_step_altered_is_seen(bench, monkeypatch, workload, where):
    # the warm-up takes 2 calls; the 4th is the window's second step of 4
    # or more, so the last step's answers are sound
    plant(monkeypatch, where, altered_in_one_step(4))
    res = run(bench, workload)
    assert res["attempted"] > 2 and res["correct"] is False


def _worker(rank: int, port: int, out: str) -> int:
    import torch.distributed as dist
    from perfbench import run as run_lib
    from perfbench.conftest import small_bench
    from perfbench.harness import cell as cell_lib
    from repro_torch.core.api import Croft3D
    from repro_torch.launch.mesh import join_world
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank))
    dev = join_world("cpu")
    bench, wl, results = small_bench(), "croft2048-pencil4-roundtrip", {}
    real = dist.all_to_all_single
    for fault in ("none", "exchange_left_out"):
        if fault == "exchange_left_out":
            def kept(output, input, *a, **kw):
                output.copy_(input)          # every rank keeps what it had
                return real(output.clone(), input, *a, **kw)
            dist.all_to_all_single = kept
        mine = cell_lib.run_rank(bench, wl, 2 ** 31 + 5, 0.05, False, dev,
                                 time.time())
        ranks = [None] * 4
        dist.all_gather_object(ranks, mine)
        results[fault] = cell_lib.combine(bench, wl, False, ranks, dev)
    dist.all_to_all_single = real
    if rank == 1:                   # a lazy import on one rank alone
        forward = Croft3D.forward

        def loads_repro(self, x):
            sys.modules.setdefault("repro.planted",
                                   types.ModuleType("repro.planted"))
            return forward(self, x)
        Croft3D.forward = loads_repro
    args = run_lib.parse(["--workload", wl, "--seed", str(2 ** 31 + 6),
                          "--seconds", "0.05", "--trace", "0"])
    rc, res = run_lib.run_rank(args, bench, rank, 4, port, time.time(),
                               device="cpu")
    if rank == 0:
        results["run_rank"] = {"rc": rc, "correct": res["correct"]}
        Path(out).write_text(json.dumps(results))
    return rc


def test_four_ranks_exchange_left_out(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "results.json"
    root = HERE.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-m",
                               "perfbench.test_perfbench_faults", str(r),
                               str(port), str(out)], cwd=root, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # rank 1 alone loaded the JAX package's name, and alone exits 1
    assert [p.returncode for p in procs] == [0, 1, 0, 0], "\n".join(
        log[-3000:] for log in logs)
    assert "rank 1: modules of JAX or of the JAX package were loaded: " \
        "['repro']" in logs[1]
    results = json.loads(out.read_text())
    assert results["none"]["correct"] is True
    assert results["none"]["device"]["count"] == 4
    assert results["exchange_left_out"]["correct"] is False
    assert results["run_rank"] == {"rc": 0, "correct": True}


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
