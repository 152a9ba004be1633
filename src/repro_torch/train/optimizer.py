"""AdamW with warmup-cosine schedule, global-norm clipping, decoupled weight
decay (masked off 1-D params), and low-precision moment options.

Port of ``repro/train/optimizer.py``.  Parameters, gradients and moments
are dicts of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``); :func:`adamw_update` writes the
new fp32 masters and the new moments into the tensors it was given, in
place, where the reference returns new trees from a donated state.
Moment dtype ``bfloat16`` halves optimizer memory; moments are stored in
the chosen dtype and upcast inside the update.  Every scalar (the
learning rate, the norm, the clip scale, the step) stays a tensor on the
parameters' device, so a step never waits for the host.

On a mesh the parameters, gradients and moments are this rank's blocks
(``parallel.sharding.shard_model``), and AdamW runs on them unchanged;
only the global-norm clip needs the whole: :func:`global_norm` with the
model's ``layout`` all-reduces the squared norm over the mesh, each
block counted once however many ranks hold it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # "float32" | "bfloat16"


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _decay_mask(params: dict, stacked=frozenset()) -> dict:
    """True where weight decay applies: >=2-D tensors (norms/biases spared)
    in the reference's layout.  ``stacked`` names the parameters that the
    reference keeps stacked on a leading repeat axis (a model's layers,
    ``models.model.stacked_names``): they count that axis, so a layer's
    norm scale, (R, D) in the reference, decays as it does there."""
    return {k: p.ndim + (k in stacked) >= 2 for k, p in params.items()}


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and the
    step count (an int32 scalar on the parameters' device)."""
    mdt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device if params else None
    return {
        "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors, layout=None, names=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32.  With a
    ``layout`` (``parallel.sharding.Layout``) the tensors are this rank's
    blocks of the parameters ``names``: each block's sum is divided by
    the number of ranks that hold it, and one all-reduce over the mesh
    sums them."""
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    if layout is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    from repro_torch.parallel.sharding import replicas
    mesh = layout.mesh
    parts = torch.stack([x / replicas(layout.specs[n], mesh)
                         for x, n in zip(leaves, names)])
    total = mesh.all_reduce(parts.sum().reshape(1),
                            tuple(mesh.axis_names)).wait()
    return torch.sqrt(total[0])


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig,
                 stacked=frozenset(), layout=None) -> dict:
    """One AdamW step, in place: ``params`` (the masters), ``state["m"]``,
    ``state["v"]`` and ``state["step"]`` take their new values.  Returns
    the metrics ``lr``, ``grad_norm`` and ``clip_scale`` (tensors).
    ``stacked``: as in :func:`_decay_mask`.  ``layout``: the blocks'
    layout on a mesh (:func:`global_norm`); every rank calls it."""
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm([grads[k] for k in params], layout, list(params))
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    mask = _decay_mask(params, stacked)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), stepf)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        # .float() of a float32 moment is the moment itself: updated in place
        m32 = m.float().mul_(b1).add_(g, alpha=1 - b1)
        v32 = v.float().mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and mask[k]:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - delta.mul_(lr))
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
    return {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
