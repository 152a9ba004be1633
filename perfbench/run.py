#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells are the ``workloads`` of
``BENCHMARK.json``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: every number compared
with its limit); the last lines of standard error are those numbers.

A cell on several chips is run by this process as rank 0, which starts
the other ranks (this script with ``--rank``), one card each; they join
over NCCL through ``repro_torch.launch.mesh.join_world`` on a free
localhost port.  The kernels are built once per checkout into
``build/`` before any rank starts, and that time is part of
``setup_s``.  Exits non-zero, printing no result, without as many CUDA
cards as the cell asks for, when any rank fails, or when a module of JAX
or of the JAX package ``repro`` has been loaded: every rank looks at its
own ``sys.modules`` once its window has closed, and one that finds such
a module exits non-zero, which the launcher refuses.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DEADLINE_S = 330.0      # every rank ends within this, once the kernels exist


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's (``repro_torch`` is another top-level name and passes)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--build-s", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def watch(procs: list, parent: int, done: threading.Event) -> None:
    """End this process when a rank fails, the launcher is gone, or the
    deadline passes; a rank left waiting on a lost peer would hang."""
    start = time.time()
    while not done.wait(1.0):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed or os.getppid() != parent or \
                time.time() - start > DEADLINE_S:
            log(f"stopping: ranks failed "
                f"{[p.args[p.args.index('--rank') + 1] for p in failed]}, "
                f"launcher alive {os.getppid() == parent}, "
                f"{time.time() - start:.0f} s gone")
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            os._exit(1)


def run_rank(args, bench, rank: int, chips: int, port, t0: float,
             build_s: float = 0.0, device=None):
    """One rank's run: (exit code, the result on rank 0, else None).  The
    code is 1 when this rank's process holds a module of JAX or of the
    JAX package once the window has closed.  ``device`` is the card, or
    "cpu" to run the ranks over gloo."""
    import torch
    import torch.distributed as dist
    from perfbench.harness import cell
    join_s = 0.0
    if chips > 1:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(chips), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        from repro_torch.launch.mesh import join_world
        t = time.perf_counter()
        device = join_world(device)
        join_s = time.perf_counter() - t
    else:
        device = torch.device(device or "cuda:0")
        if device.type == "cuda":
            torch.cuda.set_device(device)
    try:
        mine = cell.run_rank(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), device, t0, join_s, build_s)
        ranks = [mine]
        if chips > 1:
            ranks = [None] * chips
            dist.all_gather_object(ranks, mine)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result = None
    if rank == 0:
        result = cell.combine(bench, args.workload, bool(args.trace), ranks,
                              device)
    bad = forbidden_modules()
    if bad:
        log(f"rank {rank}: modules of JAX or of the JAX package were "
            f"loaded: {bad}")
        return 1, None
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    # every cache of the program at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from perfbench.harness.spec import Bench
    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    done = threading.Event()
    if args.rank is not None:          # a rank the launcher started
        threading.Thread(target=watch, args=([], os.getppid(), done),
                         daemon=True).start()
        rc, _ = run_rank(args, bench, args.rank, chips, args.port, args.t0,
                         args.build_s)
        done.set()
        return rc
    from repro_torch.kernels import _build
    t = time.perf_counter()
    build_s = 0.0
    if any(_build.build_all().values()):
        build_s = time.perf_counter() - t
        log(f"kernels built into build/ in {build_s:.1f} s")
    procs, port = [], free_port() if chips > 1 else None
    for r in range(1, chips):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--rank", str(r),
             "--t0", repr(T0), "--port", str(port), "--build-s",
             repr(build_s)], stdout=sys.stderr))
    threading.Thread(target=watch, args=(procs, os.getppid(), done),
                     daemon=True).start()
    try:
        rc, result = run_rank(args, bench, 0, chips, port, T0, build_s)
        for p in procs:
            p.wait(timeout=120)
    finally:
        done.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc or any(p.returncode for p in procs):
        log(f"ranks exited {[rc] + [p.returncode for p in procs]}")
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
