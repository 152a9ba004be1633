"""Spawning the port's multi-rank test workers (not a test module).

``spawn`` starts N worker processes joined by one gloo process group and
waits for them.  The rendezvous store lives in the spawning (pytest)
process: it binds port 0, so no other process can take the port between
choosing it and binding it, and it outlives every rank, so no rank's
exit tears down a store another rank still talks to.  A worker joins
with ``join`` and, once its records are written, leaves with ``leave``:
a barrier (every rank is done with every collective), then the groups
its meshes made, then the default group, destroyed in one order on every
rank while all ranks are alive — nothing is left for interpreter exit
to tear down.

When a rank fails, the report names every failed rank: its exit code
(or signal), whether it wrote its ``rank{r}.json`` first, and the tail
of its log.
"""

import datetime
import gc
import os
import signal
import subprocess
import sys

import torch.distributed as dist

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")


def join(rank: int, port, world: int) -> None:
    """Join the spawning process's store as ``rank`` of ``world``."""
    store = dist.TCPStore("127.0.0.1", int(port), world, is_master=False,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def leave(*meshes) -> None:
    """Tear every group down in one order, on every rank."""
    dist.barrier()
    for mesh in meshes:
        mesh.close()
    dist.destroy_process_group()
    gc.collect()


def _status(code: int) -> str:
    if code < 0:
        return f"killed by {signal.Signals(-code).name}"
    return f"exit code {code}"


def spawn(script: str, ranks: int, args, out, timeout: int = 300,
          env: dict = None) -> list:
    """Run ``script`` (source text) as ``ranks`` processes, each called
    ``worker.py RANK PORT *args``; returns their logs.  Raises naming
    every failed rank."""
    path = os.path.join(str(out), "worker.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    try:
        procs = [subprocess.Popen(
            [sys.executable, path, str(r), str(store.port)]
            + [str(a) for a in args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        del store
    failed = [
        f"rank {r}: {_status(p.returncode)}, "
        + ("wrote" if os.path.exists(os.path.join(str(out), f"rank{r}.json"))
           else "did not write") + f" rank{r}.json; log tail:\n{log[-3000:]}"
        for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if failed:
        raise AssertionError(f"{len(failed)} of {ranks} ranks failed:\n"
                             + "\n".join(failed))
    return logs
