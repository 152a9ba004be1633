"""Pseudo-spectral PDE driver on the PyTorch port: periodic Poisson solve
+ a few steps of 3-D viscous Burgers, with an autotuned plan.

    PYTHONPATH=src python examples/spectral_solver_torch.py          # the card
    PYTHONPATH=src python examples/spectral_solver_torch.py --device cpu \\
        --tune model

The port of ``examples/spectral_solver.py``.  Starts ``--ranks``
processes (4 by default) joined by a gloo process group on
``localhost``, each holding its block of the (2 x R/2) pencil mesh; with
``--ranks 1`` the plan is meshless and nothing is tuned, as in the
reference's single-device run.

The fields are real, so the driver runs the real transform
(``Croft3D(problem="r2c")``): the forward returns the (N, N, N//2 + 1)
Hermitian half spectrum and the inverse is the exact c2r.  The plan
comes from the autotuner (``repro_torch.tuning``): ``--tune measure``
(default) races the model-ranked top candidates on the mesh — the
packed/embed strategy axis included — each timed as the slowest rank's
wall; ``--tune model`` picks analytically with zero execution, and
``--tune wisdom`` reuses a plan stored by a previous run (``--wisdom
PATH``; only rank 0 writes it).  ``--strategy`` forces the r2c strategy
on the default pencil plan instead.

The Poisson solve is one forward, one k-space multiply that computes
-1/k^2 from the three wavenumber vectors in the pass, and one inverse.  The
Burgers steps check that viscosity dissipates energy.
"""

import argparse
import math
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import Croft3D, Decomposition, FFTOptions, poisson_solve


def _global_sum(value: float, mesh) -> float:
    if mesh is None:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t)


def _global_max(value: float, mesh) -> float:
    if mesh is None:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def run(rank: int, port: int, args) -> None:
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    n = args.n
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.ranks > 1:
        from repro_torch.core import make_mesh
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=args.ranks)
        mesh = make_mesh((2, args.ranks // 2), ("y", "z"), device=dev)
        if args.strategy is None:
            t0 = time.perf_counter()
            plan = Croft3D.tuned((n, n, n), mesh, mode=args.tune,
                                 problem="r2c", wisdom_path=args.wisdom)
            say(f"tuned plan: {plan.tune_result.summary()} "
                f"({(time.perf_counter() - t0) * 1e3:.0f} ms to tune)")
        else:
            # forcing a strategy bypasses the planner: hand-picked
            # default pencil plan (say so — --tune/--wisdom are ignored)
            say(f"--strategy {args.strategy}: bypassing the autotuner "
                "(--tune/--wisdom ignored), using the default pencil plan")
            plan = Croft3D((n, n, n), mesh,
                           Decomposition("pencil", ("y", "z")), FFTOptions(),
                           problem="r2c", strategy=args.strategy)
    else:
        mesh = None
        plan = Croft3D((n, n, n), None, None, FFTOptions(), problem="r2c",
                       strategy=args.strategy, device=dev)
    say(f"r2c strategy: {plan.strategy} "
        f"(spectrum {plan.spectrum_shape}, input {plan.input_dtype})")
    inp = plan.input_sharding or (slice(None),) * 3
    out = plan.output_sharding or (slice(None),) * 3

    # --- Poisson: manufactured solution ------------------------------------
    g = 2 * math.pi * np.arange(n) / n
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    u_true = np.sin(X) * np.cos(2 * Y) * np.sin(3 * Z)
    f = -(1 + 4 + 9) * u_true
    fd = torch.as_tensor(f[inp], dtype=torch.float32, device=dev)
    u = poisson_solve(fd, plan)
    err = _global_max(float((u.cpu() - torch.as_tensor(u_true[inp])).abs()
                            .max()), mesh)
    say(f"Poisson {n}^3: max error {err:.2e}")

    # --- viscous Burgers (scalar, semi-implicit spectral stepping) ---------
    # the r2c spectrum halves kz: rfftfreq bins, each rank's block of them
    freq = torch.fft.fftfreq(n, d=1.0 / n, device=dev)
    kx = freq[:, None, None]
    ky = freq[None, :, None]
    kz = torch.fft.rfftfreq(n, d=1.0 / n, device=dev)[None, None, :]
    nh = n // 2 + 1
    k2 = (kx ** 2 + ky ** 2 + kz ** 2)[out]
    ikx = (1j * torch.broadcast_to(kx, (n, n, nh)))[out].to(plan.dtype)

    u = torch.as_tensor((np.sin(X) * np.cos(Y) * np.cos(Z))[inp],
                        dtype=torch.float32, device=dev)
    dt = 0.01

    def step(u):
        u_hat = plan.forward(u)                  # real -> half spectrum
        ux = plan.inverse(ikx * u_hat)
        rhs = -u * ux                            # nonlinear term, real space
        rhs_hat = plan.forward(rhs)
        u_hat_new = (u_hat + dt * rhs_hat) / (1 + dt * args.nu * k2)
        return plan.inverse(u_hat_new)           # exact c2r: real output

    e0 = _global_sum(float((u.double() ** 2).sum()), mesh) / n ** 3
    t0 = time.perf_counter()
    for _ in range(args.steps):
        u = step(u)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_wall = (time.perf_counter() - t0) / args.steps
    e1 = _global_sum(float((u.double() ** 2).sum()), mesh) / n ** 3
    say(f"Burgers {args.steps} steps: energy {e0:.4f} -> {e1:.4f} "
        f"(viscous decay expected), {dt_wall * 1e3:.1f} ms/step")
    if not e1 < e0:
        raise SystemExit("viscosity must dissipate energy")
    say("OK", flush=True)
    if mesh is not None:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=4,
                    help="processes: 1 (meshless) or an even count")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--nu", type=float, default=0.05)
    ap.add_argument("--tune", default="measure",
                    choices=["model", "measure", "wisdom"],
                    help="autotuner mode (repro_torch.tuning)")
    ap.add_argument("--wisdom", default=None,
                    help="wisdom JSON path for --tune wisdom / persistence")
    ap.add_argument("--strategy", default=None,
                    choices=["packed", "embed"],
                    help="force the r2c strategy (default: planner/auto)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (default)")
    args = ap.parse_args()
    if args.ranks > 1 and args.ranks % 2:
        ap.error("--ranks must be 1 or even (the mesh is 2 x R/2)")
    if args.device != "cpu" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if args.ranks == 1:
        run(0, port, args)
    else:
        mp.spawn(run, args=(port, args), nprocs=args.ranks)


if __name__ == "__main__":
    main()
