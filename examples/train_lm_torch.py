"""Training examples on the PyTorch port: the differentiable distributed
transform, end to end.

The port of ``examples/train_lm.py``.  Default workload (``--workload
spectral``): a learned spectral filter (real-space gate + k-space filter
around the r2c transform, ``repro_torch.models.spectral``) trained with
SGD.  Gradients replay the plan's adjoint schedule
(``repro_torch.grad``).  With ``--ranks 1`` (the default) the plan is a
meshless ``Croft3D(problem="r2c")``; with more ranks (gloo, a (R/2 x 2)
``("y", "x")`` mesh, as the reference lays out its devices) it comes from
``Croft3D.tuned(..., grad=True, mode="model")``, whose cost model prices
forward + adjoint, so the plan is the best training step.

    PYTHONPATH=src python examples/train_lm_torch.py            # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --ranks 4

``--workload lm`` drives the production path (``repro_torch.launch.train``:
chunked loss, AdamW, checkpointing, straggler monitor) on a dense
transformer: ``--preset 100m`` (~100M parameters) or ``--preset tiny``
for a CPU smoke run.

    PYTHONPATH=src python examples/train_lm_torch.py --workload lm \\
        --preset tiny --device cpu

Each workload prints "OK" when its loss fell.
"""

import argparse
import os
import socket
import sys
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       simple_stack)

PRESETS = {
    # ~101M params: 12L d=768 12H swiglu, 32k vocab (GPT-2-small-ish)
    "100m": dict(layers=12, d=768, heads=12, kv=12, ff=3072, vocab=32768,
                 seq=512, batch=8, steps=300),
    "tiny": dict(layers=2, d=64, heads=4, kv=2, ff=128, vocab=256,
                 seq=64, batch=4, steps=30),
}


def build_config(p) -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=p["heads"],
                           n_kv_heads=p["kv"], head_dim=p["d"] // p["heads"]),
        ffn="swiglu",
    )
    return ModelConfig(
        name="example-lm", family="dense", d_model=p["d"], d_ff=p["ff"],
        vocab=p["vocab"], stages=simple_stack(p["layers"], spec),
    )


def run_spectral(rank: int, port: int, args) -> None:
    """Train the learned spectral filter (on every rank of the mesh)."""
    from repro_torch.core import Croft3D, make_mesh
    from repro_torch.models.spectral import (init_spectral_filter_params,
                                             place_spectral_filter_params,
                                             spectral_filter_apply)
    from repro_torch.train import make_spectral_train_step

    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    n = args.size
    shape = (n, n, n)
    if args.ranks == 1:
        plan = Croft3D(shape, problem="r2c", device=dev)
        say(f"spectral workload: {shape} single-device")
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=args.ranks)
        mesh = make_mesh((args.ranks // 2, 2), ("y", "x"), device=dev)
        plan = Croft3D.tuned(shape, mesh, mode="model", problem="r2c",
                             grad=True)
        say(f"spectral workload: {shape} on {mesh.shape} — "
            f"{plan.tune_result.summary()}")

    rng = np.random.RandomState(0)
    inp = plan.input_sharding or (slice(None),) * 3
    x = torch.as_tensor(rng.randn(*shape)[inp], dtype=plan.input_dtype,
                        device=dev)
    true = place_spectral_filter_params(plan, {
        "gate": torch.as_tensor(1.0 + 0.3 * rng.randn(*shape),
                                dtype=torch.float32),
        "filter": torch.as_tensor(
            1.0 + 0.3 * rng.randn(*plan.spectrum_shape),
            dtype=torch.float32)})
    with torch.no_grad():
        target = spectral_filter_apply(plan, true, x)
    step, _ = make_spectral_train_step(plan, lr=args.lr)
    params = place_spectral_filter_params(
        plan, init_spectral_filter_params(None, plan))
    steps = args.steps or 20
    losses = []
    for i in range(steps):
        params, loss = step(params, x, target)
        losses.append(float(loss))
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            say(f"step {i:4d}  loss {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses}")
    say("OK", flush=True)
    if args.ranks > 1:
        dist.barrier()
        mesh.close()
        dist.destroy_process_group()


def run_lm(args) -> None:
    from repro_torch import configs
    from repro_torch.launch import train as train_cli

    p = PRESETS[args.preset]
    cfg = build_config(p)
    print(f"example LM: {cfg.param_count():,} params")
    # register it so the production CLI path drives it unchanged
    mod = types.ModuleType("examples._example_lm_torch")
    mod.full = lambda: cfg
    mod.smoke = lambda: cfg
    sys.modules["examples._example_lm_torch"] = mod
    configs.ARCHS["example-lm"] = "examples._example_lm_torch"
    argv = ["--arch", "example-lm",
            "--steps", str(args.steps or p["steps"]),
            "--global-batch", str(p["batch"]),
            "--seq-len", str(p["seq"]),
            "--log-every", "10"]
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    if args.device:
        argv += ["--device", args.device]
    history = train_cli.main(argv)
    if not history[-1]["loss"] < history[0]["loss"]:
        raise SystemExit("the loss did not fall")
    print("OK", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="spectral",
                    choices=("spectral", "lm"))
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--size", type=int, default=32,
                    help="spectral: grid size N (N^3 field)")
    ap.add_argument("--lr", type=float, default=0.05,
                    help="spectral: SGD learning rate")
    ap.add_argument("--ranks", type=int, default=1,
                    help="spectral: processes, 1 (meshless) or even")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (default)")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    if args.workload == "lm":
        run_lm(args)
        return
    if args.ranks > 1 and args.ranks % 2:
        ap.error("--ranks must be 1 or even (the mesh is R/2 x 2)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if args.ranks == 1:
        run_spectral(0, port, args)
    else:
        mp.spawn(run_spectral, args=(port, args), nprocs=args.ranks)


if __name__ == "__main__":
    main()
