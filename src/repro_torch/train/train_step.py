"""Train and serve steps: the LM train step, the spectral-filter train
step, the prefill/decode pair and sampling.

Port of ``repro/train/train_step.py``.

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
weights on the card), by the same stacked-layout rule as the train
step's leaves, and the steps run the model as it is, under
``torch.no_grad()``.  A model that trains is never cast: its masters
stay float32.

On a mesh (:func:`make_shard_ctx`, the reference's: batch over the data
axes when it divides, sequence and weights over ``model``) every rank
runs the same step on its blocks.  The train state's Model holds this
rank's blocks of the masters (``parallel.sharding.shard_model``, by
``param_specs``) and the moments match them; each layer gathers its
full weights just before it runs and the gradients come back summed
over the ranks that computed with them, as this rank's blocks; AdamW
updates the blocks, its clip all-reducing the squared norm.  The loss
is the global mean (one all-reduce) with this rank's share as its
gradient.  Serving keeps the caches slot-sharded
(``models.init_caches(mesh=)``); its Model is either whole on every
rank (a decode step then moves only the partial-softmax combine) or
this rank's blocks (each layer gathers its weights every step).  Batch
arrays may come whole or as the rank's block; logits come back as the
rank's batch block.
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
from repro_torch.models.model import ShardCtx
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.loss import chunked_cross_entropy
from repro_torch.train import optimizer as opt_lib

AUX_WEIGHT = 0.01   # Switch-style load-balance weight (zero for dense stacks)


def make_shard_ctx(mesh, global_batch: int) -> Optional[ShardCtx]:
    """The reference's context: batch over the data axes (the pod axis
    too, multi-pod) when ``global_batch`` divides over them, else
    replicated (``dp`` None); sequence and weights over ``model``.  The
    reference's ``multi_pod`` argument is the mesh's own: the pod axis is
    in use when the mesh has one (``parallel.sharding.mesh_axes``, which
    the caches and the loss read too)."""
    if mesh is None:
        return None
    if global_batch is None:
        raise ValueError("a mesh needs the global batch")
    dp_axes = sh.mesh_axes(mesh).dp_axes
    dp_size = math.prod(mesh.shape[a] for a in dp_axes)
    dp = dp_axes if global_batch % dp_size == 0 else None
    if dp is not None and len(dp) == 1:
        dp = dp[0]
    return ShardCtx(mesh=mesh, dp=dp, cp_axis="model", tp="model")


def cast_to_compute(model: nn.Module, dtype) -> nn.Module:
    """Cast the float32 parameters that are at least 2-D in the
    reference's layout to ``dtype``, in place: a Model's layer parameters
    count the repeat axis the reference stacks them on
    (``model_lib.stacked_names``), so a layer's norm scales, biases,
    RG-LRU ``lam``/``b_rg``/``b_ig`` and RWKV ``decay_base`` are cast as
    the reference's ``cast_to_compute`` casts them, and the final norm
    stays float32 (:func:`compute_leaves`' rule).  For serving only: a
    training model keeps its fp32 masters."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    stacked = model_lib.stacked_names(model)
    for name, p in model.named_parameters():
        if p.dtype == torch.float32 and p.ndim + (name in stacked) >= 2:
            p.data = p.data.to(dt)
    return model


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _rank_rows(x, shard: Optional[ShardCtx], batch: int):
    """This rank's batch block of ``x``: ``x`` itself when it already is
    one (or meshless), its rows when it is the whole ``batch``."""
    if shard is None:
        return x
    rows = model_lib.batch_rows(shard, batch)
    n = rows.stop - rows.start
    if x.shape[0] == n:
        return x
    if x.shape[0] != batch:
        raise ValueError(f"expected {batch} rows or this rank's {n}, got "
                         f"{x.shape[0]}")
    return x[rows]


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
    (:func:`compute_leaves`), the reference's cast tree.  Called on the
    fp32 masters directly, a layer's norm scales and biases stay
    float32, where the reference's cast rounds them to ``cfg.dtype``;
    in float32 the two are the same.

    On a mesh (``shard``) the batch's arrays are this rank's batch block;
    the rank's hidden states are its block of the emitted positions, and
    it takes the matching slice of the labels (under prefix-LM the
    blocks of the P + S positions do not line up with the S labels'):
    the loss's value is the global mean, its gradient this rank's
    share."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    kwargs = {}
    n_prefix = 0
    if cfg.frontend == "vision" and cfg.encoder is None:
        kwargs["prefix_embeds"] = batch["prefix_embeds"]
        n_prefix = kwargs["prefix_embeds"].shape[1]
    total = inputs.shape[1] + n_prefix
    shard = model_lib.for_seq(shard, cfg, total, "train")
    if cfg.encoder is not None:
        kwargs["enc_out"] = model_lib.encode(model, cfg, batch["frames"],
                                             kv_block, shard=shard)
    hidden, _, aux = model_lib.forward(
        model, cfg, inputs, mode="train", kv_block=kv_block, shard=shard,
        return_hidden=True, remat_policy=remat_policy, **kwargs)
    if model.embed.head is None:
        head_w = model_lib.weight(model, "embed.tok", shard).T
    else:
        head_w = model_lib.weight(model, "embed.head", shard)
    extra = {}
    if shard is not None:
        lo, hi = model_lib.emitted_block(shard, total, n_prefix)
        labels = labels[:, lo:hi]
        extra = dict(axes=sh.mesh_axes(shard.mesh), mesh=shard.mesh,
                     over=model_lib.grad_axes(shard))
    loss, metrics = chunked_cross_entropy(
        hidden, labels, head_w.to(hidden.dtype), n_chunks=n_loss_chunks,
        softcap=cfg.logit_softcap, **extra)
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
                     device=None, axes: Optional[sh.MeshAxes] = None) -> dict:
    """{"params": the Model (fp32 masters drawn from ``generator``),
    "opt": its AdamW state} on ``device`` (default: the CUDA card; the
    mesh's device on a mesh).  On a ``mesh`` the whole model is drawn
    (the meshless values), then each rank keeps its blocks by
    ``param_specs`` (``axes``, default ``MeshAxes()``), and both moments
    are blocks of the same shapes."""
    if mesh is not None:
        device = mesh.device
    model = model_lib.init_params(cfg, generator, device)
    if mesh is not None:
        sh.shard_model(model, mesh, axes or sh.MeshAxes())
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
                    kv_block: int = 1024, n_loss_chunks: int = 8,
                    remat_policy: str = "nothing"):
    """Returns a (state, batch) -> (state, metrics) step.  The state's
    masters and moments are updated in place (the reference donates its
    state's buffers); ``batch``'s arrays are moved to the model's device.
    Metrics stay tensors on the device: reading one waits for the
    step.

    On a ``mesh`` every rank calls the step with its state (the Model's
    blocks, ``init_train_state(mesh=)``, or a whole Model on every rank)
    and its batch block of the ``global_batch`` rows (or the whole
    batch, of which it takes its rows); the metrics are the global
    ones on every rank."""
    shard = make_shard_ctx(mesh, global_batch)

    def step(state, batch):
        model = state["params"]
        batch = _on_device({k: _rank_rows(v, shard, global_batch)
                            for k, v in batch.items()},
                           model.embed.tok.device)
        loss, metrics, grads = value_and_grad(
            model, cfg, batch, shard=shard, kv_block=kv_block,
            n_loss_chunks=n_loss_chunks, remat_policy=remat_policy)
        opt_metrics = opt_lib.adamw_update(
            dict(model.named_parameters()), grads, state["opt"], opt_cfg,
            model_lib.stacked_names(model), getattr(model, "layout", None))
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
                     kv_block: int = 1024, device=None, *, mesh=None):
    """(prefill_fn, decode_fn) on ``device`` (default: the CUDA card).

    prefill(model, tokens, caches, prefix_embeds=None, frames=None)
                                    -> (last_logits (B, vocab), caches)
    decode(model, token, caches, t) -> (logits (B, vocab), caches)

    An encoder-decoder's prefill runs :func:`encode` over ``frames`` (B,
    T, d_model) and writes the cross caches; ``prefix_embeds`` (B, P,
    d_model) go ahead of the prompt.  ``t`` is the global position of
    ``token`` (a Python int, the prefix included); both write ``caches``
    in place, and neither records a graph.

    ``mesh`` (the reference's ``mesh``, ``global_batch`` = ``batch``; its
    ``multi_pod`` is the mesh's, :func:`make_shard_ctx`): every rank
    calls both steps.  Their array arguments are the whole batch or this
    rank's batch block (:func:`make_shard_ctx`'s ``dp``), ``caches`` this rank's blocks (``models.init_caches(mesh=)``),
    and the logits come back as the rank's batch block.  The prefill
    runs on the rank's block of the sequence and writes the rank's slots
    from the gathered K/V; its last logits come from the last rank of the
    sequence axis.  A decode step attends over the rank's slots and
    combines the partial softmaxes; with a whole Model on every rank
    that combine is all it moves.
    """
    shard = make_shard_ctx(mesh, batch)
    dev = mesh.device if mesh is not None else resolve_device(device)
    rows = model_lib.batch_rows(shard, batch)
    local = rows.stop - rows.start

    def _rows(x, what: str, form: str, width=None) -> torch.Tensor:
        """The rank's rows of ``x`` (B, *form), checked."""
        x = torch.as_tensor(x, device=dev)
        if shard is not None and x.ndim and x.shape[0] == batch:
            x = x[rows]
        if x.ndim != 1 + len(form.split(",")) or x.shape[0] != local \
                or (width is not None and x.shape[-1] != width):
            mine = f" or ({local}, {form}) on this rank" if shard else ""
            raise ValueError(f"{what}: expected ({batch}, {form}){mine}, "
                             f"got {tuple(x.shape)}")
        return x

    def _tokens(tokens, what: str) -> torch.Tensor:
        return _rows(tokens, what, "S")

    def _embeds(x, what: str) -> torch.Tensor:
        return _rows(x, what, f"T, {cfg.d_model}", cfg.d_model)

    @torch.no_grad()
    def prefill(model, tokens, caches, prefix_embeds=None, frames=None):
        tokens = _tokens(tokens, "prefill")
        kwargs = {}
        n_prefix = 0
        if prefix_embeds is not None:
            kwargs["prefix_embeds"] = _embeds(prefix_embeds, "prefix_embeds")
            n_prefix = prefix_embeds.shape[1]
        total = tokens.shape[1] + n_prefix
        if total > max_len:
            raise ValueError(f"a {tokens.shape[1]}-token prompt after "
                             f"{n_prefix} prefix positions exceeds max_len "
                             f"{max_len}")
        eff = model_lib.for_seq(shard, cfg, total, "prefill")
        if cfg.encoder is not None:
            if frames is None:
                raise ValueError(f"{cfg.name} prefill needs frames")
            kwargs["enc_out"] = model_lib.encode(
                model, cfg, _embeds(frames, "frames"), kv_block, shard=eff)
        if shard is None:
            logits, caches = model_lib.forward(
                model, cfg, tokens, mode="prefill", caches=caches,
                kv_block=kv_block, **kwargs)
            return logits[:, -1], caches
        hidden, caches = model_lib.forward(
            model, cfg, tokens, mode="prefill", caches=caches,
            kv_block=kv_block, shard=eff, return_hidden=True, **kwargs)
        if hidden.shape[1]:
            last = hidden[:, -1]
        else:   # a block of prefix positions only
            last = hidden.new_zeros(hidden.shape[0], hidden.shape[2])
        if eff.cp_axis is not None:
            from repro_torch.parallel.seqscan import from_last_rank
            last = from_last_rank(last, mesh, eff.cp_axis)
        return model_lib.logits(model, cfg, last[:, None], eff)[:, 0], caches

    @torch.no_grad()
    def decode(model, token, caches, t: int):
        """token (B, 1); t = global position (prefix included)."""
        token = _tokens(token, "decode")
        logits, caches = model_lib.forward(model, cfg, token, mode="decode",
                                           caches=caches, start=t,
                                           kv_block=kv_block, shard=shard)
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
