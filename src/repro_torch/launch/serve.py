"""Serving entry point: the LM prefill + decode loop.

Port of ``repro/launch/serve.py``'s ``lm_main`` (``--arch``), meshless, on
the CUDA card unless ``--device cpu``:

``python -m repro_torch.launch.serve --arch h2o-danube-3-4b --smoke
--prompt-len 32 --gen-len 32 --batch 2``

Weights are drawn from ``--seed`` on the device and cast once to the
config's compute dtype; prompts come from the reference's
``synth_tokens``, so both packages serve the same tokens.
The reference's default mode, the transform service (no ``--arch``),
waits for ``ROADMAP.md`` queue 1 item 7.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SERVICE_ITEM = "ROADMAP.md queue 1 item 7 (serving: the transform service)"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_main(args) -> np.ndarray:
    """Serve ``args.batch`` synthetic prompts; returns the generated ids
    (batch, gen_len)."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_caches, init_params
    from repro_torch.train import (cast_to_compute, make_serve_steps,
                                   temperature_sample)
    from repro_torch.train.data import synth_tokens

    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = cast_to_compute(init_params(cfg, gen, dev), cfg.dtype)

    max_len = args.prompt_len + args.gen_len
    prefill_fn, decode_fn = make_serve_steps(cfg, args.batch, max_len,
                                             kv_block=args.kv_block,
                                             device=dev)
    prompts = synth_tokens(args.seed, 0, args.batch, args.prompt_len,
                           cfg.vocab)
    caches = init_caches(cfg, args.batch, max_len,
                         dtype=getattr(torch, cfg.dtype), device=dev)
    sampler = torch.Generator(device=dev).manual_seed(args.seed)

    _sync(dev)
    t0 = time.monotonic()
    logits, caches = prefill_fn(model, prompts, caches)
    _sync(dev)
    t_prefill = time.monotonic() - t0
    tok = temperature_sample(sampler, logits, args.temperature)[:, None]
    out = [tok]
    t0 = time.monotonic()
    for i in range(args.gen_len - 1):
        logits, caches = decode_fn(model, tok, caches, args.prompt_len + i)
        tok = temperature_sample(sampler, logits, args.temperature)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.monotonic() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    tps = args.batch * (args.gen_len - 1) / max(t_decode, 1e-9)
    print(f"device: {dev}  model: {cfg.name} ({cfg.dtype})")
    print(f"prefill: {t_prefill:.3f}s for {args.batch}x{args.prompt_len} tok")
    print(f"decode : {t_decode:.3f}s for {args.gen_len-1} steps "
          f"({tps:.1f} tok/s)")
    print(f"sample generations (first 16 ids):\n{gen[:, :16]}")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=None,
                    help="the LM to serve (the transform service, without "
                         "--arch, is not ported yet)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-block", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    if not args.arch:
        raise NotImplementedError(f"transform-service mode: {SERVICE_ITEM}")
    return lm_main(args)


if __name__ == "__main__":
    main()
