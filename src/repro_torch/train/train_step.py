"""Train and serve steps: the LM train step, the spectral-filter train
step, the prefill/decode pair and sampling.

Port of ``repro/train/train_step.py``, meshless: ``make_shard_ctx`` with
a mesh raises, naming ``ROADMAP.md`` queue 1 item 8e (sharding), as
``models.forward`` does.

Training keeps the fp32 masters in the :class:`~repro_torch.models.Model`
and differentiates, each step, with respect to compute-dtype copies of
them (the reference's ``precast=True``): every float32 parameter with
``ndim >= 2`` in the reference's layout becomes a leaf in ``cfg.dtype``
(a layer's parameters count the repeat axis that the reference stacks
them on, :func:`~repro_torch.models.model.stacked_names`, so its norm
scales and biases are cast too), every other parameter a detached leaf
of its own, the loss runs through
``torch.func.functional_call`` over those leaves, and their gradients go
to :func:`~repro_torch.train.optimizer.adamw_update`, which writes the
masters and moments in place (where the reference donates its state).

Serving: the reference casts the fp32 masters to the compute dtype
inside every jitted call; here :func:`cast_to_compute` casts the model
once, in place, at load (the same values, and no second copy of the
weights on the card), and the steps run the model as it is, under
``torch.no_grad()``.  A model that trains is never cast: its masters
stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.loss import chunked_cross_entropy
from repro_torch.train import optimizer as opt_lib

AUX_WEIGHT = 0.01   # Switch-style load-balance weight (zero for dense stacks)


def make_shard_ctx(mesh, global_batch: int, multi_pod: bool = False):
    """None meshless; the sharded context is ``ROADMAP.md`` item 8e."""
    if mesh is None:
        return None
    raise NotImplementedError(
        f"sharded training (ShardCtx): {model_lib.LM_ITEM}e")


def cast_to_compute(model: nn.Module, dtype) -> nn.Module:
    """Cast the float32 parameters with ``ndim >= 2`` to ``dtype``, in
    place; norm scales and biases stay float32, as in the reference.  For
    serving only: a training model keeps its fp32 masters."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            p.data = p.data.to(dt)
    return model


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def loss_fn(model: nn.Module, cfg: ModelConfig, batch: dict,
            shard: Any = None, kv_block: int = 1024, n_loss_chunks: int = 8,
            remat_policy: str = "nothing"):
    """batch: {"tokens" (B, S+1) int, optional "prefix_embeds",
    "frames"}, on the model's device.  Next-token prediction on
    tokens[:-1] -> tokens[1:]; returns (loss, metrics), the loss plus
    0.01 times the MoE load-balance loss.

    The reference's ``precast`` flag has no counterpart: the port's
    layers cast each weight to the activations' dtype where they use it.
    The train step runs this on the compute-dtype leaves
    (:func:`compute_leaves`), the reference's cast tree.  On the fp32
    masters a layer's norm scales and biases stay float32, where the
    reference's cast rounds them to ``cfg.dtype`` (as in serving,
    ``ROADMAP.md`` §3); in float32 the two are the same."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    kwargs = {}
    if cfg.encoder is not None:
        kwargs["enc_out"] = model_lib.encode(model, cfg, batch["frames"],
                                             kv_block)
    elif cfg.frontend == "vision":
        kwargs["prefix_embeds"] = batch["prefix_embeds"]
    hidden, _, aux = model_lib.forward(
        model, cfg, inputs, mode="train", kv_block=kv_block, shard=shard,
        return_hidden=True, remat_policy=remat_policy, **kwargs)
    head_w = model.embed.head
    if head_w is None:
        head_w = model.embed.tok.T
    loss, metrics = chunked_cross_entropy(
        hidden, labels, head_w.to(hidden.dtype), n_chunks=n_loss_chunks,
        softcap=cfg.logit_softcap)
    metrics["aux_loss"] = aux.detach()
    return loss + AUX_WEIGHT * aux, metrics


@dataclasses.dataclass
class TrainState:
    """The reference's name for the train state, kept for its export
    list; as there, nothing builds one: the steps and the checkpoint
    manager take the dict ``{"params", "opt"}`` (:meth:`tree`)."""
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


def init_train_state(generator, cfg: ModelConfig,
                     opt_cfg: opt_lib.OptConfig, mesh=None,
                     device=None) -> dict:
    """{"params": the Model (fp32 masters drawn from ``generator``),
    "opt": its AdamW state} on ``device`` (default: the CUDA card)."""
    if mesh is not None:
        raise NotImplementedError(
            f"sharded train state: {model_lib.LM_ITEM}e")
    model = model_lib.init_params(cfg, generator, device)
    return {"params": model,
            "opt": opt_lib.init_opt_state(dict(model.named_parameters()),
                                          opt_cfg)}


class _ValueAndGrad(nn.Module):
    """:func:`loss_fn` and its gradients as one module call, for
    ``torch.func.functional_call``.  The gradient is taken inside the
    call: the layers' checkpoints recompute in the backward, and must
    find the leaves, not the masters, in the model while they do."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, leaves: list, cfg, batch, loss_kw: dict):
        loss, metrics = loss_fn(self.model, cfg, batch, **loss_kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), metrics, grads


def compute_leaves(model: nn.Module, dtype) -> dict:
    """The leaves a step differentiates, keyed by parameter name, all
    requiring grad: each float32 parameter that is at least 2-D in the
    reference's layout (``model_lib.stacked_names``) cast to ``dtype``,
    as the reference's ``cast_to_compute`` casts its stacked tree, every
    other one detached."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    stacked = model_lib.stacked_names(model)
    leaves = {}
    for name, p in model.named_parameters():
        leaf = p.detach()
        if p.dtype == torch.float32 and p.ndim + (name in stacked) >= 2:
            leaf = leaf.to(dt)
        leaves[name] = leaf.requires_grad_()
    return leaves


def value_and_grad(model: nn.Module, cfg: ModelConfig, batch: dict,
                   **loss_kw):
    """(loss, metrics, grads) of :func:`loss_fn` with respect to the
    compute-dtype leaves (:func:`compute_leaves`); grads keyed by
    parameter name, in the leaves' dtypes."""
    leaves = compute_leaves(model, cfg.dtype)
    with torch.enable_grad():
        loss, metrics, grads = torch.func.functional_call(
            _ValueAndGrad(model),
            {f"model.{k}": v for k, v in leaves.items()},
            (list(leaves.values()), cfg, batch, loss_kw))
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return loss, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig,
                    mesh=None, global_batch: Optional[int] = None,
                    multi_pod: bool = False, kv_block: int = 1024,
                    n_loss_chunks: int = 8, remat_policy: str = "nothing"):
    """Returns a (state, batch) -> (state, metrics) step.  The state's
    masters and moments are updated in place (the reference donates its
    state's buffers); ``batch``'s arrays are moved to the model's device.
    Metrics stay tensors on the device: reading one waits for the
    step."""
    shard = make_shard_ctx(mesh, global_batch, multi_pod)

    def step(state, batch):
        model = state["params"]
        batch = _on_device(batch, model.embed.tok.device)
        loss, metrics, grads = value_and_grad(
            model, cfg, batch, shard=shard, kv_block=kv_block,
            n_loss_chunks=n_loss_chunks, remat_policy=remat_policy)
        opt_metrics = opt_lib.adamw_update(
            dict(model.named_parameters()), grads, state["opt"], opt_cfg,
            model_lib.stacked_names(model))
        return state, {**metrics, **opt_metrics, "loss": loss}

    return step


# --------------------------------------------------------------------------
# spectral-layer training (the CROFT gradient workload)
# --------------------------------------------------------------------------


def spectral_loss_fn(plan, params: dict, x: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """Normalized spectral MSE of the learned filter layer
    (``repro_torch.models.spectral``) against a target half/full
    spectrum.

    Normalizing by N^3 undoes the unnormalized forward transform's
    energy blow-up (Parseval), so per-mode curvature w.r.t. the filter
    is O(1) and plain SGD converges with an O(0.1) learning rate.  With a
    mesh this is this rank's share, over its block of the spectrum: the
    reference's loss is the sum over ranks, and a backward on every rank
    gives each rank its block of the total's gradient (the transform's
    backward is collective).
    """
    from repro_torch.models import spectral as spectral_lib
    pred = spectral_lib.spectral_filter_apply(plan, params, x)
    d = pred - target
    n3 = float(math.prod(plan.shape))
    return torch.sum(torch.real(d * torch.conj(d))) / n3


def make_spectral_train_step(plan, lr: float = 0.05):
    """SGD step for the learned spectral filter over a planned transform.

    Returns ``(step, loss_fn)``: ``step(params, x, target) -> (params,
    loss)`` updates ``params``' tensors in place and returns the total
    loss (summed over the mesh's ranks; every rank calls it);
    ``loss_fn(params, x, target)`` is the raw scalar loss (this rank's
    share on a mesh).  Gradients flow through the plan's autograd
    function: the backward replays the plan's adjoint schedule
    (``repro_torch.grad``), which is what ``Croft3D.tuned(grad=True)``
    optimizes for.  The port's complex gradients are conjugates of the
    reference's (``ROADMAP.md`` §3), but the gate and the filter are
    real, so their gradients, and the update, are the reference's.
    """

    def loss_fn(params, x, target):
        return spectral_loss_fn(plan, params, x, target)

    def step(params, x, target):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, x, target)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(lr * g)
        loss = loss.detach()
        if plan.mesh is not None:
            loss = plan.mesh.all_reduce(loss.clone(),
                                        tuple(plan.mesh.axis_names)).wait()
        return params, loss

    return step, loss_fn


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

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
    in place, and neither records a graph.
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

    @torch.no_grad()
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

    @torch.no_grad()
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
