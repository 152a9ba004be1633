"""Serve steps: the prefill/decode pair and sampling.

Port of the serving part of ``repro/train/train_step.py``
(``cast_to_compute``, ``make_serve_steps``, ``greedy_sample``,
``temperature_sample``), meshless.  The train step, its loss and the
spectral-layer training wait for the training slice (``ROADMAP.md``
queue 1 item 8): ``flash_attention`` has no backward kernel in the
reference.

The reference casts the fp32 masters to the compute dtype inside every
jitted call; here :func:`cast_to_compute` casts the model once, in place,
at load (the same values, and no second copy of the weights on the card),
and the steps run the model as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def cast_to_compute(model: nn.Module, dtype) -> nn.Module:
    """Cast the float32 parameters with ``ndim >= 2`` to ``dtype``, in
    place; norm scales and biases stay float32, as in the reference."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            p.data = p.data.to(dt)
    return model


def make_serve_steps(cfg: ModelConfig, batch: int, max_len: int,
                     kv_block: int = 1024, device=None):
    """(prefill_fn, decode_fn) on ``device`` (default: the CUDA card).

    prefill(model, tokens, caches, prefix_embeds=None, frames=None)
                                    -> (last_logits (B, vocab), caches)
    decode(model, token, caches, t) -> (logits (B, vocab), caches)

    An encoder-decoder's prefill runs :func:`encode` over ``frames`` (B,
    T, d_model) and writes the cross caches; ``prefix_embeds`` (B, P,
    d_model) go ahead of the prompt.  ``t`` is the global position of
    ``token`` (a Python int, the prefix included); both write ``caches``
    in place.
    """
    dev = resolve_device(device)

    def _tokens(tokens, what: str) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=dev)
        if tokens.ndim != 2 or tokens.shape[0] != batch:
            raise ValueError(f"{what}: expected ({batch}, S) tokens, got "
                             f"{tuple(tokens.shape)}")
        return tokens

    def _embeds(x, what: str) -> torch.Tensor:
        x = torch.as_tensor(x, device=dev)
        if x.ndim != 3 or x.shape[0] != batch or x.shape[2] != cfg.d_model:
            raise ValueError(f"{what}: expected ({batch}, T, {cfg.d_model}), "
                             f"got {tuple(x.shape)}")
        return x

    def prefill(model, tokens, caches, prefix_embeds=None, frames=None):
        tokens = _tokens(tokens, "prefill")
        kwargs = {}
        if cfg.encoder is not None:
            if frames is None:
                raise ValueError(f"{cfg.name} prefill needs frames")
            kwargs["enc_out"] = model_lib.encode(
                model, cfg, _embeds(frames, "frames"), kv_block)
        n_prefix = 0
        if prefix_embeds is not None:
            kwargs["prefix_embeds"] = _embeds(prefix_embeds, "prefix_embeds")
            n_prefix = prefix_embeds.shape[1]
        if tokens.shape[1] + n_prefix > max_len:
            raise ValueError(f"a {tokens.shape[1]}-token prompt after "
                             f"{n_prefix} prefix positions exceeds max_len "
                             f"{max_len}")
        logits, caches = model_lib.forward(model, cfg, tokens, mode="prefill",
                                           caches=caches, kv_block=kv_block,
                                           **kwargs)
        return logits[:, -1], caches

    def decode(model, token, caches, t: int):
        """token (B, 1); t = global position (prefix included)."""
        token = _tokens(token, "decode")
        logits, caches = model_lib.forward(model, cfg, token, mode="decode",
                                           caches=caches, start=t,
                                           kv_block=kv_block)
        return logits[:, 0], caches

    return prefill, decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(generator, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """A draw from softmax(logits / temperature) per row, from
    ``generator`` (the reference draws from a JAX key: the same
    distribution, not the same tokens)."""
    if temperature == 0.0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
