"""The training entry point: ``python -m repro_torch.launch.train --arch yi-9b
--smoke --device cpu``.

Port of ``repro/launch/train.py``: auto-resume from the latest
checkpoint under ``--ckpt-dir``, a save every ``--ckpt-every`` steps,
SIGTERM-triggered save-and-exit (on a mesh, at the step every rank
agrees on), straggler monitoring, deterministic data replay.  Weights are drawn from ``--seed`` on the device; batches
are the reference's ``SyntheticDataset`` batches, token for token.  The
loss and the other metrics stay on the device and are read to the host
only at log steps (and once, for the history, at the end), so the host
runs ahead of the card between them; a step's time is then the host's
loop time, which the card's queue paces.

A single process trains meshless on one device (the CUDA card unless
``--device`` names another).  Started as one of several ranks
(``torchrun``), every rank joins the reference's ``make_local_mesh``
over the world (``--model-axis`` ranks on ``model``; gloo when the ranks
share a card, NCCL with a card each), keeps its blocks of the state,
reads its batch block of every step's global batch, and checkpoints with
logical shapes (rank 0 writes; any mesh restores).  Rank 0 prints.

On the H100, at full size with bf16 moments::

    python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --moment-dtype bfloat16 --global-batch 2 --seq-len 2048

and sharded, 4 ranks sharing the card on a (data 2, model 2) mesh::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch yi-9b --smoke --model-axis 2 --global-batch 4
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main(argv=None) -> list:
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import Prefetcher, SyntheticDataset
    from repro_torch.train.fault import PreemptionHandler, StragglerMonitor
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.data import batch_sharding
    from repro_torch.train.train_step import make_shard_ctx

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--kv-block", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model-axis", type=int, default=0,
                    help="ranks on the mesh's model axis (0: "
                         "make_local_mesh's rule); under torchrun only")
    args = ap.parse_args(argv)

    mesh = world_mesh(args.model_axis, args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.coords == {a: 0 for a in mesh.axis_names}
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    say(f"arch={cfg.name} params={cfg.param_count():,} device={dev}"
        + (f" mesh={mesh.shape}" if mesh is not None else ""))

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                        decay_steps=args.steps,
                        moment_dtype=args.moment_dtype)
    state = init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, opt_cfg,
        mesh=mesh, device=dev)
    step_fn = make_train_step(cfg, opt_cfg, mesh, args.global_batch,
                              kv_block=args.kv_block)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        shardings = None
        if mesh is not None:
            blocks = sh.param_shardings(state["params"], mesh, sh.MeshAxes())
            shardings = {"params": blocks,
                         "opt": {"m": blocks, "v": blocks, "step": None}}
        state = ckpt.restore(state, shardings=shardings)
        start_step = int(state["opt"]["step"])
        say(f"resumed from checkpoint at step {start_step}")

    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = ((cfg.n_frontend_tokens, cfg.d_model), np.float32)
    elif cfg.frontend == "vision":
        extra["prefix_embeds"] = ((cfg.n_frontend_tokens, cfg.d_model),
                                  np.float32)
    sharding = None
    if mesh is not None:
        sharding = batch_sharding(make_shard_ctx(mesh, args.global_batch),
                                  args.global_batch, ["tokens", *extra])
    ds = SyntheticDataset(cfg.vocab, args.seq_len, args.global_batch,
                          seed=args.seed, device=dev, start_step=start_step,
                          extra=extra, sharding=sharding)
    data = Prefetcher(iter(ds), depth=2)

    preempt = PreemptionHandler()
    preempt.install()
    monitor = StragglerMonitor(on_straggler=lambda s: say(
        f"  [straggler] step {s.step}: {s.seconds:.2f}s (z={s.z_score:.1f})"))

    history, losses = [], []
    preempted = False
    for step in range(start_step, args.steps):
        monitor.start_step()
        batch = next(data)
        state, metrics = step_fn(state, batch)
        stats = monitor.end_step(step)
        losses.append(metrics["loss"])
        history.append({"step": step, "sec": round(stats.seconds, 3)})
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"({stats.seconds:.2f}s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
        if preempt.agreed():    # every rank stops at the same step
            say("preemption requested: checkpointing and exiting")
            if ckpt:
                ckpt.save(step + 1, state, block=True)
            preempted = True
            break
    for rec, loss in zip(history, torch.stack(losses).tolist()
                         if losses else []):
        rec["loss"] = loss
    if ckpt and not preempted:   # a preempted run's state is not step N's
        ckpt.save(args.steps, state, block=True)
    if args.metrics_out and lead:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    if history:
        say(f"final loss {history[-1]['loss']:.4f} "
            f"(first {history[0]['loss']:.4f})")
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
        mesh.close()
        dist.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
