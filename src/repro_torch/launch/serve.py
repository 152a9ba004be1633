"""Serving entry point: the transform service (default) and the LM loop.

Port of ``repro/launch/serve.py``.  The default mode drives
:class:`repro_torch.serve.TransformService` with a synthetic open-loop
request stream and prints latency / occupancy / plan-cache stats:

``python -m repro_torch.launch.serve --shape 512,512,512 --problem mix``

on the CUDA card; ``--device cpu`` serves on the CPU.  Started as one of
several ranks (``torchrun --nproc-per-node 4 -m repro_torch.launch.serve
...``), every rank joins a pencil ``("y", "z")`` mesh over the world and
the service runs SPMD: rank 0 takes the requests, every rank runs the
dispatches (over NCCL where every rank has a card of its own, else
gloo: ranks that share a card, and on the CPU).

``--arch`` selects the LM prefill + decode loop instead, meshless in a
single process:

``python -m repro_torch.launch.serve --arch h2o-danube-3-4b --smoke
--prompt-len 32 --gen-len 32 --batch 2``

and, started as several ranks (``torchrun --nproc-per-node 4 -m
repro_torch.launch.serve --arch ... --model-axis 2``), on the
reference's ``make_local_mesh``: every rank holds the whole model, its
batch block and its slots of the caches; the prompt's sequence splits
over ``model`` in the prefill, and each decode step combines the ranks'
partial softmaxes.  Rank 0 prints the whole batch's tokens.

Weights are drawn from ``--seed`` on the device and cast once to the
config's compute dtype; prompts come from the reference's
``synth_tokens``, and whisper's stub frames and paligemma's stub patch
embeddings from ``numpy.random.default_rng(seed)``, as in the reference,
so both packages serve the same inputs.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.distributed as dist


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- transform-service mode (default) ---------------------------------------

def _mesh_for_transforms(device=None):
    """A pencil ``("y", "z")`` mesh over the world when this process was
    started as one of several ranks (``torchrun``: ``WORLD_SIZE`` >= 2);
    None otherwise (the service then runs meshless on ``device``).  The
    group is NCCL's where every rank has a card of its own, else gloo's
    (NCCL needs one card a rank)."""
    from repro_torch.core import make_mesh
    from repro_torch.launch.mesh import join_world
    device = join_world(device)
    if device is None:
        return None
    n = dist.get_world_size()
    py = int(math.sqrt(n))
    while n % py:
        py -= 1
    return make_mesh((py, n // py), ("y", "z"), device=device)


def transforms_main(args) -> dict:
    """Serve ``args.requests`` synthetic transforms; returns the service's
    ``stats()`` (on rank 0 of a mesh; the other ranks return theirs)."""
    from repro_torch.serve import TransformService

    mesh = _mesh_for_transforms(args.device)
    shape = tuple(int(s) for s in args.shape.split(","))
    if len(shape) != 3:
        raise SystemExit(f"--shape must be 3-D, got {shape}")
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    svc = TransformService(
        mesh, device=args.device, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, wisdom_path=args.wisdom,
        measure_after=args.measure_after)
    say(f"device: {svc.device}  mesh: "
        f"{mesh.shape if mesh else 'single-device'}  shape: {shape}  "
        f"problem: {args.problem}")
    try:
        with svc:
            if lead:
                _offer_load(svc, args, shape)
        stats = svc.stats()
    finally:
        if mesh is not None:
            svc.close()
            mesh.close()
            dist.destroy_process_group()
    if not lead:
        return stats
    lat = stats["latency_ms"]
    say(f"served {stats['requests']} requests in "
        f"{stats['batches']} batches "
        f"(mean batch {stats['mean_batch']:.2f}, "
        f"occupancy {stats['occupancy']:.0%})")
    say(f"latency ms: p50={lat['p50']:.2f} p90={lat['p90']:.2f} "
        f"p99={lat['p99']:.2f}")
    cache = stats["plan_cache"]
    states = {k.split("|")[0] + "|" + k.split("|")[-1]: v["state"]
              for k, v in cache["plans"].items()}
    say(f"plan cache: {cache['stats']}  states: {states}")
    return stats


def _offer_load(svc, args, shape) -> None:
    """The open-loop request stream of ``transforms_main`` (rank 0)."""
    rng = np.random.RandomState(args.seed)
    cplx = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    real = rng.randn(*shape).astype(np.float32)
    filt = rng.randn(*shape).astype(np.complex64)
    workload = {
        "c2c": [(cplx, {})],
        "r2c": [(real, {"problem": "r2c"})],
        "filtered": [(cplx, {"problem": "filtered", "h": filt})],
    }
    reqs = (workload["c2c"] * 3 + workload["r2c"] * 2
            + workload["filtered"]) if args.problem == "mix" \
        else workload[args.problem]
    t0 = time.monotonic()
    futs = []
    for i in range(args.requests):
        if args.qps > 0:
            delay = t0 + i / args.qps - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        x, kw = reqs[i % len(reqs)]
        futs.append(svc.submit(x, **kw))
    results = [f.result(timeout=600) for f in futs]
    bad = [r for r in results if not r.ok]
    if bad:
        raise SystemExit(f"{len(bad)} requests failed; first error: "
                         f"{bad[0].error}")


# -- LM prefill/decode loop (``--arch``) ------------------------------------


def lm_main(args) -> np.ndarray:
    """Serve ``args.batch`` synthetic prompts; returns the generated ids
    (batch, gen_len)."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import init_caches, init_params
    from repro_torch.train import (cast_to_compute, make_serve_steps,
                                   temperature_sample)
    from repro_torch.train.data import synth_tokens

    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    mesh = world_mesh(getattr(args, "model_axis", 0), args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or dist.get_rank() == 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = cast_to_compute(init_params(cfg, gen, dev), cfg.dtype)

    prefix = cfg.n_frontend_tokens if cfg.prefix_lm else 0
    max_len = prefix + args.prompt_len + args.gen_len
    prefill_fn, decode_fn = make_serve_steps(cfg, args.batch, max_len,
                                             kv_block=args.kv_block,
                                             device=dev, mesh=mesh)
    prompts = synth_tokens(args.seed, 0, args.batch, args.prompt_len,
                           cfg.vocab)
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    caches = init_caches(cfg, args.batch, max_len, enc_len=enc_len,
                         dtype=getattr(torch, cfg.dtype), device=dev,
                         mesh=mesh)
    kwargs = {}
    rng = np.random.default_rng(args.seed)
    stub = (args.batch, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.encoder is not None:
        kwargs["frames"] = rng.standard_normal(stub, np.float32)
    elif cfg.frontend == "vision":
        kwargs["prefix_embeds"] = rng.standard_normal(stub, np.float32)
    sampler = torch.Generator(device=dev).manual_seed(args.seed)

    _sync(dev)
    t0 = time.monotonic()
    logits, caches = prefill_fn(model, prompts, caches, **kwargs)
    _sync(dev)
    t_prefill = time.monotonic() - t0
    tok = temperature_sample(sampler, logits, args.temperature)[:, None]
    out = [tok]
    t0 = time.monotonic()
    for i in range(args.gen_len - 1):
        logits, caches = decode_fn(model, tok, caches,
                                   prefix + args.prompt_len + i)
        tok = temperature_sample(sampler, logits, args.temperature)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.monotonic() - t0

    gen = torch.cat(out, dim=1)
    if mesh is not None:      # every rank's batch block, in batch order
        from repro_torch.train.train_step import make_shard_ctx
        dp = make_shard_ctx(mesh, args.batch).dp
        if dp is not None:
            gen = mesh.gather(gen.contiguous(), (args.batch, gen.shape[1]),
                              (dp, None))
    gen = gen.cpu().numpy()
    tps = args.batch * (args.gen_len - 1) / max(t_decode, 1e-9)
    if lead:
        print(f"device: {dev}  model: {cfg.name} ({cfg.dtype})"
              + (f"  mesh: {mesh.shape}" if mesh is not None else ""))
        print(f"prefill: {t_prefill:.3f}s for {args.batch}x"
              f"{args.prompt_len} tok")
        print(f"decode : {t_decode:.3f}s for {args.gen_len-1} steps "
              f"({tps:.1f} tok/s)")
        print(f"sample generations (first 16 ids):\n{gen[:, :16]}")
    if mesh is not None:
        dist.barrier()
        mesh.close()
        dist.destroy_process_group()
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    # transform-service mode
    ap.add_argument("--shape", default="32,32,32",
                    help="3-D transform shape, e.g. 64,64,64")
    ap.add_argument("--problem", default="mix",
                    choices=("c2c", "r2c", "filtered", "mix"))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered request rate; 0 = as fast as possible")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--wisdom", default=None,
                    help="wisdom file: cold starts read it, measured "
                         "upgrades merge into it")
    ap.add_argument("--measure-after", type=int, default=None,
                    help="dispatches of a key before the measure-mode "
                         "upgrade")
    # LM mode
    ap.add_argument("--arch", default=None,
                    help="run the LM prefill/decode loop instead")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-block", type=int, default=512)
    ap.add_argument("--model-axis", type=int, default=0,
                    help="LM mode under torchrun: ranks on the mesh's "
                         "model axis (0: make_local_mesh's rule)")
    args = ap.parse_args(argv)
    if args.arch:
        return lm_main(args)
    return transforms_main(args)


if __name__ == "__main__":
    main()
