"""CROFT quickstart on PyTorch: plan, transform, verify, differentiate.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Starts ``--ranks`` processes (8 by default) joined by a gloo process
group on ``localhost``, and runs the pencil (2 x R/2), slab (R) and cell
(2 x 2 x R/4) decompositions of an N^3 complex field, each rank holding
its block: forward against ``torch.fft.fftn``'s slice and the round
trip, then one gradient of ``loss = sum |y|^2`` through the pencil plan
against Parseval's ``2 N x``.  Every rank calls ``backward()``: the
backward runs the transposes of the forward's collectives.  Rank 0
prints the worst error over the ranks.
"""

import argparse
import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh


def _worst(value: float) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def run(rank: int, port: int, args) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.ranks)
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    n, r = args.n, args.ranks
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, n, n, dtype=torch.complex64, device=dev, generator=gen)
    ref = torch.fft.fftn(x)
    scale = ref.abs().max().item()
    opts = FFTOptions(overlap_k=args.k, local_impl=args.impl)
    layouts = {"pencil": ((2, r // 2), ("y", "z"), ("y", "z")),
               "slab": ((r,), ("p",), ("p",)),
               "cell": ((2, 2, r // 4), ("a", "b", "c"), ("a", "b", "c"))}
    meshes = {}
    for kind, (sizes, names, axes) in layouts.items():
        mesh = make_mesh(sizes, names, device=dev)
        meshes[kind] = mesh
        plan = Croft3D((n, n, n), mesh, Decomposition(kind, axes), opts)
        xl = x[plan.input_sharding].contiguous()
        y = plan.forward(xl)
        err = _worst((y - ref[plan.output_sharding]).abs().max().item()
                     / scale)
        rt = _worst((plan.inverse(y) - xl).abs().max().item())
        if rank == 0:
            print(f"{kind:6s} {sizes}: local block {tuple(xl.shape)}, "
                  f"forward vs torch.fft.fftn rel err {err:.2e}, "
                  f"round trip {rt:.2e}", flush=True)

    plan = Croft3D((n, n, n), meshes["pencil"],
                   Decomposition("pencil", ("y", "z")), opts)
    xl = x[plan.input_sharding].contiguous().requires_grad_()
    loss = plan.forward(xl).abs().pow(2).sum()
    loss.backward()                  # every rank: the backward is collective
    want = 2 * n ** 3 * xl.detach()
    gerr = _worst((xl.grad - want).abs().max().item()
                  / want.abs().max().item())
    if rank == 0:
        print(f"grad of sum |y|^2 (pencil) vs 2 N x: rel err {gerr:.2e}",
              flush=True)
        print("OK", flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=8,
                    help="processes; a multiple of 4")
    ap.add_argument("--k", type=int, default=2, help="CROFT overlap chunks")
    ap.add_argument("--impl", default="pallas",
                    help="local FFT: pallas (the Hopper kernel; its plain "
                         "version on the CPU) | matmul | stockham | xla")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (default)")
    args = ap.parse_args()
    if args.ranks % 4:
        ap.error("--ranks must be a multiple of 4 (cell is 2 x 2 x R/4)")
    if args.device != "cpu" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(run, args=(port, args), nprocs=args.ranks)


if __name__ == "__main__":
    main()
