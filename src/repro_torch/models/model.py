"""Model assembly: embedding -> stages of layer patterns -> logits.

Port of ``repro/models/model.py`` for attention stacks (GQA and MLA)
with dense or MoE FFNs (``models/moe.py``), the parameter-free spectral
(FNet) mixer (``models/spectral.py``), the linear-recurrence mixers
(RG-LRU and RWKV-6 with its channel mix, ``models/recurrent.py``), the
encoder stack with decoder cross-attention (whisper: :func:`encode`, then
``forward(enc_out=)``) and prefix embeddings with prefix-LM attention
(paligemma: ``forward(prefix_embeds=)``).  The
reference scans each stage's ``repeat`` groups over parameters stacked on
a leading repeat axis; here a stage is an ``nn.ModuleList`` of its layers,
group by group (layer ``t * len(pattern) + pi`` is pattern entry ``pi`` of
group ``t``), and the caches follow the same per-layer layout
(:func:`init_caches`).  :func:`repro_torch.models.convert.params_from_numpy`
carries a reference parameter tree across.

Three modes share one layer implementation:
  train    full-sequence teacher forcing, no cache I/O; under autograd
           each layer runs in ``torch.utils.checkpoint`` (remat) and
           the MoE layers' load-balance loss is summed
  prefill  full sequence + writes the KV, latent or recurrent caches
           (serving cold start)
  decode   single token against the caches (serving steady state)

Every cache is written in place (``copy_`` into the tensors that
:func:`init_caches` made; the prefill writes the encoder memory's k/v
into the cross-attention cache the same way), so ``forward`` returns the
caches it was given.  The sharded context (``ShardCtx``, ``ROADMAP.md``
queue 1 item 8e, which would route MoE layers through
``models/moe_sharded.py`` and recurrent layers through
``parallel/seqscan.py``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import kvcache as kc
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import AttentionSpec, LayerSpec, ModelConfig

LM_ITEM = "ROADMAP.md queue 1 item 8"
CROSS_ATTN_SPEC_OVERRIDES = dict(use_rope=False, causal=False, window=None)


class Ctx(NamedTuple):
    """Per-call context threaded through the layer stack."""
    mode: str                      # "train" | "prefill" | "decode"
    q_pos: torch.Tensor            # (S,) global positions of this segment
    start: int                     # global position of q_pos[0]
    prefix_len: int                # prefix-LM bidirectional span
    kv_block: int
    scan_chunk: Optional[int] = None   # recurrent chunk override
    enc_out: Optional[torch.Tensor] = None  # cross-attention source


def _cross_spec(a: AttentionSpec) -> AttentionSpec:
    return dataclasses.replace(a, **CROSS_ATTN_SPEC_OVERRIDES)


# --------------------------------------------------------------------------
# per-layer modules and forward
# --------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer: ``ln1``, the token mixer (GQA, MLA, RG-LRU or RWKV-6),
    for a decoder layer of an encoder-decoder ``ln_cross`` and ``cross``
    (GQA over the encoder memory), ``ln2``, the channel mixer (a dense
    FFN, the RWKV channel mix or MoE).  The spectral mixer has no
    parameters (``mixer`` is None)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = L.init_norm(cfg.norm, d, device)
        self.ln2 = L.init_norm(cfg.norm, d, device)
        if spec.mixer == "spectral":
            self.mixer = None
        elif spec.mixer == "rglru":
            self.mixer = rec_lib.init_rglru(d, spec.recurrent, generator,
                                            device)
        elif spec.mixer == "rwkv6":
            self.mixer = rec_lib.init_rwkv6(d, spec.recurrent, generator,
                                            device)
        elif spec.mixer == "attn":
            self.mixer = attn_lib.init_attention(d, spec.attn, generator,
                                                 device)
        else:
            raise ValueError(spec.mixer)
        if spec.cross_attn:
            self.ln_cross = L.init_norm(cfg.norm, d, device)
            self.cross = attn_lib.init_attention(d, _cross_spec(spec.attn),
                                                 generator, device)
        self.ffn = (moe_lib.init_moe(d, spec.moe, generator, device)
                    if spec.ffn == "moe" else
                    L.init_ffn(d, cfg.d_ff, spec.ffn, generator, device))


def _self_attention(p: Layer, h, spec: LayerSpec, cfg: ModelConfig,
                    ctx: Ctx, cache):
    a = spec.attn
    ms = MaskSpec(causal=a.causal, window=a.window,
                  prefix_len=ctx.prefix_len if cfg.prefix_lm else 0)
    if ctx.mode == "train":
        y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                      start=ctx.start, kv_block=ctx.kv_block)
        return y, cache
    if ctx.mode == "prefill":
        y, kv = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                       start=ctx.start, kv_block=ctx.kv_block)
        if a.kind == "mla":
            kc.write_latent_cache(cache["self"], kv, ctx.start)
        else:
            kc.write_attn_cache(cache["self"], kv[0], kv[1], ctx.start)
        return y, cache
    # decode: project this token, write, attend over the whole cache in one
    # blockwise step
    c = cache["self"]
    if a.kind == "mla":
        latent_new = attn_lib.mla_project_latent(p.mixer, h, a)
        kc.write_latent_cache(c, latent_new, ctx.start)
        y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                      kv=c["latent"], k_pos=c["pos"],
                                      kv_block=c["latent"].shape[1])
        return y, cache
    k_new, v_new = attn_lib.gqa_project_kv(p.mixer, h, a, ctx.q_pos)
    kc.write_attn_cache(c, k_new, v_new, ctx.start)
    y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                  kv=(c["k"], c["v"]), k_pos=c["pos"],
                                  kv_block=c["k"].shape[1])
    return y, cache


def _cross_attention(p: Layer, h, spec: LayerSpec, cfg: ModelConfig,
                     ctx: Ctx, cache):
    """Attention over the encoder memory: in train and prefill its k/v
    are projected from ``ctx.enc_out`` (the prefill writes them into the
    cross cache in place), in decode they are read from the cache.  Never
    on the flash-attention kernel: the keys come as ``kv``."""
    a = _cross_spec(spec.attn)
    ms = MaskSpec(causal=False)
    if ctx.mode == "decode":
        c = cache["cross"]
        y, _ = attn_lib.attention_fwd(p.cross, h, a, ms, ctx.q_pos,
                                      kv=(c["k"], c["v"]), k_pos=c["pos"],
                                      kv_block=ctx.kv_block)
        return y, cache
    if ctx.enc_out is None:
        raise ValueError(f"cross-attention in {ctx.mode} mode needs enc_out "
                         "(the output of encode)")
    enc = ctx.enc_out.to(h.dtype)
    enc_pos = torch.arange(enc.shape[1], dtype=torch.int32, device=h.device)
    k_enc, v_enc = attn_lib.gqa_project_kv(p.cross, enc, a, enc_pos)
    y, _ = attn_lib.attention_fwd(p.cross, h, a, ms, ctx.q_pos,
                                  kv=(k_enc, v_enc), k_pos=enc_pos,
                                  kv_block=ctx.kv_block)
    if ctx.mode == "prefill":
        c = cache["cross"]
        if c["k"].shape != k_enc.shape:
            raise ValueError(f"the cross cache holds {tuple(c['k'].shape)}, "
                             f"the encoder memory projects to "
                             f"{tuple(k_enc.shape)} (init_caches' enc_len)")
        c["k"].copy_(k_enc)
        c["v"].copy_(v_enc)
    return y, cache


def _recurrent(p: Layer, h, spec: LayerSpec, cfg: ModelConfig, ctx: Ctx,
               cache):
    """The RG-LRU or RWKV-6 mixer; outside train mode it starts from the
    cache's state and writes the new state into it in place."""
    r = spec.recurrent
    rc = None if ctx.mode == "train" else cache["rec"]
    if r.kind == "rglru":
        state = None if rc is None else rec_lib.RGLRUState(h=rc["h"],
                                                           conv=rc["conv"])
        y, new = rec_lib.rglru_fwd(p.mixer, h, r, state, ctx.scan_chunk)
        if rc is not None:
            rc["h"].copy_(new.h)
            rc["conv"].copy_(new.conv)
    else:
        state = None if rc is None else rec_lib.RWKVState(
            s=rc["s"], x_prev=rc["x_prev"])
        y, new = rec_lib.rwkv6_fwd(p.mixer, h, r, state, ctx.scan_chunk)
        if rc is not None:
            rc["s"].copy_(new.s)
            rc["x_prev"].copy_(new.x_prev)
    return y, cache


def layer_fwd(p: Layer, x, spec: LayerSpec, cfg: ModelConfig, ctx: Ctx,
              cache):
    """-> (x, cache, aux).  ``aux``, the MoE layer's load-balance loss
    (``moe.aux_load_balance_loss``), is computed in train mode only; it
    is 0.0 for every other layer and mode."""
    h = L.norm_fwd(p.ln1, x, cfg.norm, cfg.norm_eps)
    if spec.mixer == "spectral":
        from repro_torch.models.spectral import spectral_mixer
        y = spectral_mixer(h)
    elif spec.mixer == "attn":
        y, cache = _self_attention(p, h, spec, cfg, ctx, cache)
    else:
        y, cache = _recurrent(p, h, spec, cfg, ctx, cache)
    x = x + y
    if spec.cross_attn:
        hc = L.norm_fwd(p.ln_cross, x, cfg.norm, cfg.norm_eps)
        y, cache = _cross_attention(p, hc, spec, cfg, ctx, cache)
        x = x + y
    h2 = L.norm_fwd(p.ln2, x, cfg.norm, cfg.norm_eps)
    aux = 0.0
    if spec.ffn == "moe":
        if ctx.mode == "train":
            aux = moe_lib.aux_load_balance_loss(p.ffn, h2, spec.moe)
        return x + moe_lib.moe_fwd(p.ffn, h2, spec.moe), cache, aux
    if spec.ffn == "rwkv_cm":
        rc = None if ctx.mode == "train" else cache["rec"]
        prev = None if rc is None else rc["x_prev_ffn"]
        y = L.ffn_fwd(p.ffn, h2, "rwkv_cm", x_prev=L.token_shift(h2, prev))
        if rc is not None:
            rc["x_prev_ffn"].copy_(h2[:, -1])
        return x + y, cache, aux
    return x + L.ffn_fwd(p.ffn, h2, spec.ffn), cache, aux


# --------------------------------------------------------------------------
# whole-model init
# --------------------------------------------------------------------------

class Encoder(nn.Module):
    """The encoder stack of an encoder-decoder (whisper): ``layers``, an
    ``nn.ModuleList`` of ``n_layers`` encoder layers, and ``final_norm``.
    Like the reference's, it holds no positional table (the config's
    ``param_count`` counts one)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        e = cfg.encoder
        self.layers = nn.ModuleList(Layer(cfg, e.layer, generator, device)
                                    for _ in range(e.n_layers))
        self.final_norm = L.init_norm(cfg.norm, cfg.d_model, device)


class Model(nn.Module):
    """The embedding, the stages (``nn.ModuleList`` of layers each), the
    final norm and, for an encoder-decoder, ``encoder``; parameters are
    fp32 masters drawn from ``generator`` on ``device`` (default: the
    current CUDA card; ``"cpu"`` or ``"meta"`` when asked).  The masters
    do not require grad: a training step differentiates with respect to
    compute-dtype copies of them that it makes itself
    (``train.train_step.make_train_step``).  The modality
    frontends are stubs, as in the reference: frames and patch embeddings
    come in as (B, n_frontend_tokens, d_model) arrays."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed = L.init_embedding(cfg.vocab, cfg.d_model,
                                      cfg.tie_embeddings, generator, device)
        self.stages = nn.ModuleList(
            nn.ModuleList(Layer(cfg, spec, generator, device)
                          for _ in range(stage.repeat)
                          for spec in stage.pattern)
            for stage in cfg.stages)
        self.final_norm = L.init_norm(cfg.norm, cfg.d_model, device)
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, generator, device)


def init_params(cfg: ModelConfig, generator=None, device=None) -> Model:
    return Model(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: int = 0, dtype=torch.bfloat16, device=None) -> list:
    """Per-layer caches mirroring ``Model.stages``: ``caches[si][li]``, on
    ``device`` (default: the current CUDA card).  ``enc_len``: the encoder
    memory's length, for the cross-attention caches."""
    device = resolve_device(device)
    return [[kc.init_layer_cache(spec, batch, max_len, dtype, device,
                                 d_model=cfg.d_model, enc_len=enc_len)
             for _ in range(stage.repeat) for spec in stage.pattern]
            for stage in cfg.stages]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def encode(model: Model, cfg: ModelConfig, frames: torch.Tensor,
           kv_block: int = 1024) -> torch.Tensor:
    """Encoder stack (whisper): stub frame embeddings (B, T, d_model) ->
    memory (B, T, d_model) in the compute dtype.  Its self-attention is a
    non-causal segment at position 0 (``start`` the int 0), the
    flash-attention kernel's case when no gradient is taken through it
    (else the blockwise core, as in the reference's training pass)."""
    e = cfg.encoder
    if e is None:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames.to(getattr(torch, cfg.dtype))
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ctx = Ctx(mode="train", q_pos=pos, start=0, prefix_len=0,
              kv_block=kv_block)
    for layer in model.encoder.layers:
        x, _, _ = layer_fwd(layer, x, e.layer, cfg, ctx, None)
    return L.norm_fwd(model.encoder.final_norm, x, cfg.norm, cfg.norm_eps)


def stacked_names(model: nn.Module) -> frozenset:
    """The parameters that the reference stacks on a leading repeat axis
    (``init_params``: the leaves of every stage layer and encoder layer).
    Each has one more dimension there than here, and the reference's ndim
    rules, weight decay (``train.optimizer._decay_mask``) and the cast to
    the compute dtype that its train step differentiates
    (``train.train_step.compute_leaves``), read that layout: a layer's
    norm scales and biases are 2-D there."""
    return frozenset(n for n, _ in model.named_parameters()
                     if n.startswith(("stages.", "encoder.layers.")))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the matmuls without batch dims, recompute the
    rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(policy: str) -> dict:
    """``torch.utils.checkpoint`` keywords for a remat policy name."""
    if policy == "nothing":
        return {}
    if policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    raise ValueError(f"remat_policy {policy!r}: 'nothing' or 'dots'")


def forward(model: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "train", caches=None, start: int = 0,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, kv_block: int = 1024,
            scan_chunk: Optional[int] = None, remat: Optional[bool] = None,
            return_hidden: bool = False, shard: Any = None,
            remat_policy: str = "nothing"):
    """Token ids (B, S) -> (logits (B, S, vocab), caches).

    ``prefix_embeds`` (B, P, D): modality-stub embeddings (paligemma's
    patches) put ahead of the token embeddings; a prefix-LM config attends
    bidirectionally over them, and the logits cover only the token
    positions.  ``enc_out`` (B, T, D): the encoder memory (:func:`encode`)
    that the cross-attention layers attend to in train and prefill mode.
    ``start``: global position of the first position (the decode step
    index, prefix included), a Python int.  Prefill and decode write
    ``caches`` in place and return them; caches is None in train mode.
    ``scan_chunk`` overrides the recurrent layers' chunk.

    ``remat`` (default: on in train mode): a layer through which autograd
    records runs in ``torch.utils.checkpoint`` (``use_reentrant=False``),
    keeping only its input; ``remat_policy="dots"`` also keeps its
    matmul outputs.  ``return_hidden``: return the final-normed hidden
    states in place of the logits, and in train mode also the summed MoE
    load-balance loss: ``(hidden, None, aux)``.  No gradient is taken
    here; a caller that wants one runs the call under autograd (the
    serving steps run theirs under ``torch.no_grad()``).
    """
    if shard is not None:
        raise NotImplementedError(f"sharded forward (ShardCtx): {LM_ITEM}e")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    remat = (mode == "train") if remat is None else remat
    remat_kw = _remat_kwargs(remat_policy)
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_fwd(model.embed, tokens, dtype, cfg.emb_scale_by_dim)
    n_prefix = 0
    if prefix_embeds is not None:
        n_prefix = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    q_pos = start + torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    ctx = Ctx(mode=mode, q_pos=q_pos, start=start,
              prefix_len=n_prefix if cfg.prefix_lm else 0,
              kv_block=kv_block, scan_chunk=scan_chunk, enc_out=enc_out)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        for li, layer in enumerate(model.stages[si]):
            spec = stage.pattern[li % len(stage.pattern)]
            if caches is None and remat \
                    and L.takes_grad(x, *layer.parameters()):
                x, _, aux = checkpoint(layer_fwd, layer, x, spec, cfg, ctx,
                                       None, use_reentrant=False, **remat_kw)
            else:
                cache = caches[si][li] if caches is not None else None
                x, _, aux = layer_fwd(layer, x, spec, cfg, ctx, cache)
            aux_total = aux_total + aux
    x = L.norm_fwd(model.final_norm, x, cfg.norm, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    if return_hidden:
        if mode == "train":
            return x, caches, aux_total
        return x, caches
    return L.logits_fwd(model.embed, x, cfg.logit_softcap), caches
