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
caches it was given.

On a mesh (``shard=ShardCtx``) every rank runs the same program on its
block: its batch block over ``dp`` and, outside decode, its block of the
sequence over ``cp_axis``.  The reference's ``constrain`` pins GSPMD's
layout at stage boundaries; here every activation *is* this rank's block.
The layers route as the reference's do: attention projects K/V (or MLA's
latent) from the local block and gathers them along ``cp_axis``; the
recurrent layers run ``parallel/seqscan.py``'s scans, with the halo of
the previous rank's last inputs for RWKV's token shift and RG-LRU's
conv; the FNet mixer runs its sequence FFT over ``cp_axis``; MoE layers
run ``models/moe_sharded.py`` outside decode.  A Model that holds blocks
(``parallel.sharding.shard_model``) gathers a layer's weights just
before the layer runs, so under remat the gather is recomputed; every
gather's gradient is summed over the ranks that computed with it
(``core.mesh.Mesh.gather_sum``).  Where the sequence does not split over
``cp_axis`` the rank keeps it whole (:func:`for_seq`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.decomposition import spec_names, spec_slices
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import kvcache as kc
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import AttentionSpec, LayerSpec, ModelConfig

CROSS_ATTN_SPEC_OVERRIDES = dict(use_rope=False, causal=False, window=None)


class ShardCtx(NamedTuple):
    """Distribution context (DESIGN.md §4): batch over ``dp`` axes, sequence
    over ``cp_axis`` (context parallelism), weights' TP axis ``tp``.
    Specs are tuples, as everywhere in the port."""
    mesh: Any
    dp: Any                        # batch spec entry (axis, tuple, or None)
    cp_axis: Optional[str]         # sequence axis (None = unsharded seq)
    tp: Optional[str]              # model/tensor axis

    def act_spec(self) -> tuple:
        return (self.dp, self.cp_axis, None)

    def kv_spec(self, rank: int = 4) -> tuple:
        return (self.dp, *([None] * (rank - 1)))


class Ctx(NamedTuple):
    """Per-call context threaded through the layer stack."""
    mode: str                      # "train" | "prefill" | "decode"
    q_pos: torch.Tensor            # (S,) global positions of this block
    start: int                     # global position of the segment's start
    prefix_len: int                # prefix-LM bidirectional span
    kv_block: int
    scan_chunk: Optional[int] = None   # recurrent chunk override
    enc_out: Optional[torch.Tensor] = None  # cross-attention source
    shard: Optional[ShardCtx] = None   # the mesh (None = one device)
    seq_pos: Optional[torch.Tensor] = None  # whole segment's positions
    layout: Any = None             # the Model's block layout, if any

    @property
    def seq_split(self) -> bool:
        """Whether this pass's activations are split over ``cp_axis``."""
        return self.seq_pos is not None


# --------------------------------------------------------------------------
# the rank's blocks
# --------------------------------------------------------------------------

def dp_axes(shard: Optional[ShardCtx]) -> tuple:
    """The mesh axes the batch is split over."""
    return () if shard is None else spec_names(shard.dp)


def grad_axes(shard: Optional[ShardCtx]) -> tuple:
    """The axes whose ranks compute disjoint shares of a pass (batch and
    sequence blocks): a weight's gradient, and the loss, are summed over
    them.  Ranks that differ along any other axis compute the same
    thing."""
    if shard is None:
        return ()
    return dp_axes(shard) + ((shard.cp_axis,) if shard.cp_axis else ())


def batch_rows(shard: Optional[ShardCtx], batch: int) -> slice:
    """This rank's rows of a ``batch``-row global batch."""
    axes = dp_axes(shard)
    if not axes:
        return slice(0, batch)
    n = shard.mesh.axis_size(axes)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} ranks")
    i = shard.mesh.axis_index(axes if len(axes) > 1 else axes[0])
    return slice(i * batch // n, (i + 1) * batch // n)


def for_seq(shard: Optional[ShardCtx], cfg: ModelConfig, seq: int,
            mode: str) -> Optional[ShardCtx]:
    """The context a pass over ``seq`` positions runs under: ``shard``
    itself, or with ``cp_axis`` None (the rank keeps the sequence whole)
    in decode, where ``seq`` does not divide over ``cp_axis``, where a
    block would be shorter than an RG-LRU conv's halo, or where the FNet
    mixer's hidden dim does not divide over it."""
    if shard is None or shard.cp_axis is None:
        return shard
    n = shard.mesh.axis_size(shard.cp_axis)
    specs = [sp for st in cfg.stages for sp in st.pattern]
    halo = max([sp.recurrent.conv_width - 1 for sp in specs
                if sp.mixer == "rglru"] + [1])
    fnet = any(sp.mixer == "spectral" for sp in specs)
    if mode == "decode" or seq % n or seq // n < halo \
            or (fnet and cfg.d_model % n):
        return shard._replace(cp_axis=None)
    return shard


def seq_block(shard: Optional[ShardCtx], seq: int) -> tuple:
    """[lo, hi): this rank's positions of a ``seq``-position pass."""
    if shard is None or shard.cp_axis is None:
        return 0, seq
    n = shard.mesh.axis_size(shard.cp_axis)
    i = shard.mesh.axis_index(shard.cp_axis)
    return i * seq // n, (i + 1) * seq // n


def emitted_block(shard: Optional[ShardCtx], seq: int,
                  n_prefix: int) -> tuple:
    """[lo, hi) in token coordinates: the positions at or past
    ``n_prefix`` of this rank's block of the ``seq`` positions (prefix
    included), whose logits it emits."""
    lo, hi = seq_block(shard, seq)
    return max(lo, n_prefix) - n_prefix, max(hi, n_prefix) - n_prefix


def _gather(t: torch.Tensor, name: str, ctx: Ctx, want=None):
    """Parameter ``name`` (this rank's block ``t``) as this rank's layer
    computes with it: the whole tensor, or where ``want`` names an axis
    for a dim, this rank's slice of that dim over it (the MoE experts'
    blocks).  Gathered over the axes its spec uses and ``want`` does not
    keep; the gradient is summed over :func:`grad_axes` less the kept
    ones."""
    sh, layout = ctx.shard, ctx.layout
    spec = layout.specs[name] if layout is not None else (None,) * t.ndim
    shape = layout.shapes[name] if layout is not None else tuple(t.shape)
    want = want or (None,) * len(spec)
    view = tuple(e if e is not None and e == w else None
                 for e, w in zip(spec, want))
    kept = {a for e in view for a in spec_names(e)}
    reduce = tuple(a for a in grad_axes(sh) if a not in kept)
    out = sh.mesh.gather_sum(t, shape, spec, view, reduce)
    for d, (w, e) in enumerate(zip(want, view)):
        if w is not None and e is None:         # slice locally
            ext = shape[d] // sh.mesh.axis_size(w)
            out = out.narrow(d, sh.mesh.axis_index(w) * ext, ext)
    return out


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module call, for
    ``torch.func.functional_call`` over ``module``'s parameters."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.m, *args)


def _apply(module: nn.Module, prefix: str, ctx: Ctx, fn, *args, want=None):
    """``fn(module, *args)`` with ``module``'s parameters (full names
    ``prefix + name``) as this rank computes with them (:func:`_gather`;
    ``want`` maps a parameter name to its wanted spec)."""
    if ctx.shard is None:
        return fn(module, *args)
    weights, same = {}, True
    for n, t in module.named_parameters():
        w = _gather(t, prefix + n, ctx, (want or {}).get(n))
        weights[f"m.{n}"] = w
        same = same and w is t
    if same:
        return fn(module, *args)
    return torch.func.functional_call(_Bound(module, fn), weights, args)


def _weights_ctx(model: nn.Module, shard: Optional[ShardCtx]) -> Ctx:
    """A context that carries only what :func:`_gather` reads."""
    return Ctx(mode="train", q_pos=None, start=0, prefix_len=0, kv_block=0,
               shard=shard, layout=getattr(model, "layout", None))


def weight(model: nn.Module, name: str, shard: Optional[ShardCtx]):
    """Parameter ``name`` of ``model`` whole, as a layer computes with it
    under ``shard`` (gathered from its blocks when the model holds
    blocks; the gradient summed over :func:`grad_axes`)."""
    t = functools.reduce(getattr, name.split("."), model)
    if shard is None:
        return t
    return _gather(t, name, _weights_ctx(model, shard))


def _gather_seq(t: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """(B_loc, S_loc, ...) blocks -> (B_loc, S, ...): the whole segment
    along ``cp_axis``, with the sum adjoint (every rank's queries send
    gradient to every key)."""
    sh = ctx.shard
    n = sh.mesh.axis_size(sh.cp_axis)
    nb = sh.mesh.axis_size(dp_axes(sh)) if sh.dp is not None else 1
    shape = (t.shape[0] * nb, t.shape[1] * n) + tuple(t.shape[2:])
    rest = (None,) * (t.ndim - 2)
    return sh.mesh.gather_sum(t, shape, (sh.dp, sh.cp_axis) + rest,
                              (sh.dp, None) + rest, sh.cp_axis)


def _slot_block(c: torch.Tensor, pos: torch.Tensor, ctx: Ctx) -> tuple:
    """(first slot, combine) of a cache tensor's rank block: a cache
    whose slot dim (1) is shorter than ``pos`` is slot-sharded over the
    ``tp`` axis, and attention over it combines the ranks' partial
    softmaxes over that axis."""
    local, n = c.shape[1], pos.shape[0]
    if local == n:
        return 0, None
    sh = ctx.shard
    return sh.mesh.axis_index(sh.tp) * local, (sh.mesh, sh.tp)


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
    """On a mesh, train and prefill project K/V (MLA: the latent) from
    the rank's block and gather them along ``cp_axis`` (queries stay
    split); the prefill writes the rank's slots from the gathered ones.
    Decode attends over the rank's slots of a slot-sharded cache and
    combines the partial softmaxes over the ``tp`` axis."""
    a = spec.attn
    ms = MaskSpec(causal=a.causal, window=a.window,
                  prefix_len=ctx.prefix_len if cfg.prefix_lm else 0)
    seq = {}
    if ctx.seq_split:
        seq = dict(k_pos=ctx.seq_pos,
                   kv_gather=lambda t: _gather_seq(t, ctx))
    if ctx.mode == "train":
        y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                      start=ctx.start, kv_block=ctx.kv_block,
                                      **seq)
        return y, cache
    c = cache["self"]
    buf = c["latent"] if a.kind == "mla" else c["k"]
    first, combine = _slot_block(buf, c["pos"], ctx)
    if ctx.mode == "prefill":
        y, kv = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                       start=ctx.start, kv_block=ctx.kv_block,
                                       **seq)
        if a.kind == "mla":
            kc.write_latent_cache(c, kv, ctx.start, first)
        else:
            kc.write_attn_cache(c, kv[0], kv[1], ctx.start, first)
        return y, cache
    # decode: project this token, write, attend over the whole cache (the
    # rank's slots of it) in one blockwise step
    k_pos = c["pos"][first:first + buf.shape[1]]
    if a.kind == "mla":
        latent_new = attn_lib.mla_project_latent(p.mixer, h, a)
        kc.write_latent_cache(c, latent_new, ctx.start, first)
        y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                      kv=c["latent"], k_pos=k_pos,
                                      kv_block=buf.shape[1], combine=combine)
        return y, cache
    k_new, v_new = attn_lib.gqa_project_kv(p.mixer, h, a, ctx.q_pos)
    kc.write_attn_cache(c, k_new, v_new, ctx.start, first)
    y, _ = attn_lib.attention_fwd(p.mixer, h, a, ms, ctx.q_pos,
                                  kv=(c["k"], c["v"]), k_pos=k_pos,
                                  kv_block=buf.shape[1], combine=combine)
    return y, cache


def _cross_attention(p: Layer, h, spec: LayerSpec, cfg: ModelConfig,
                     ctx: Ctx, cache):
    """Attention over the encoder memory: in train and prefill its k/v
    are projected from ``ctx.enc_out`` (the prefill writes them into the
    cross cache in place, on a mesh the rank's slots of them), in decode
    they are read from the cache.  Never on the flash-attention kernel:
    the keys come as ``kv``.  On a mesh the memory is whole on every
    rank of its batch block, so split queries need no gather."""
    a = _cross_spec(spec.attn)
    ms = MaskSpec(causal=False)
    if ctx.mode == "decode":
        c = cache["cross"]
        first, combine = _slot_block(c["k"], c["pos"], ctx)
        y, _ = attn_lib.attention_fwd(
            p.cross, h, a, ms, ctx.q_pos, kv=(c["k"], c["v"]),
            k_pos=c["pos"][first:first + c["k"].shape[1]],
            kv_block=ctx.kv_block, combine=combine)
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
        if c["pos"].shape[0] != k_enc.shape[1] or (
                c["k"].shape[:1] + c["k"].shape[2:]
                != k_enc.shape[:1] + k_enc.shape[2:]):
            raise ValueError(f"the cross cache holds {tuple(c['k'].shape)} "
                             f"of {c['pos'].shape[0]} frames, the encoder "
                             f"memory projects to {tuple(k_enc.shape)} "
                             f"(init_caches' enc_len)")
        first, _ = _slot_block(c["k"], c["pos"], ctx)
        n = c["k"].shape[1]
        c["k"].copy_(k_enc[:, first:first + n])
        c["v"].copy_(v_enc[:, first:first + n])
    return y, cache


def _recurrent(p: Layer, h, spec: LayerSpec, cfg: ModelConfig, ctx: Ctx,
               cache):
    """The RG-LRU or RWKV-6 mixer; outside train mode it starts from the
    cache's state and writes the new state into it in place.  With the
    sequence split over ``cp_axis`` it runs the sequence-parallel scan
    (the new state comes from the last rank of the axis)."""
    r = spec.recurrent
    rc = None if ctx.mode == "train" else cache["rec"]
    cp = None
    if ctx.seq_split:
        cp = (ctx.shard.mesh, ctx.shard.cp_axis, ctx.shard.dp)
    if r.kind == "rglru":
        state = None if rc is None else rec_lib.RGLRUState(h=rc["h"],
                                                           conv=rc["conv"])
        y, new = rec_lib.rglru_fwd(p.mixer, h, r, state, ctx.scan_chunk,
                                   cp=cp)
        if rc is not None:
            rc["h"].copy_(new.h)
            rc["conv"].copy_(new.conv)
    else:
        state = None if rc is None else rec_lib.RWKVState(
            s=rc["s"], x_prev=rc["x_prev"])
        y, new = rec_lib.rwkv6_fwd(p.mixer, h, r, state, ctx.scan_chunk,
                                   cp=cp)
        if rc is not None:
            rc["s"].copy_(new.s)
            rc["x_prev"].copy_(new.x_prev)
    return y, cache


def _moe_sharded(ctx: Ctx) -> bool:
    """The reference's route to ``moe_fwd_sharded``: a mesh with a tensor
    axis, outside decode."""
    return (ctx.shard is not None and ctx.shard.tp is not None
            and ctx.mode != "decode")


def _moe_views(spec: LayerSpec, ctx: Ctx) -> Optional[dict]:
    """The expert weights' wanted layout for ``moe_fwd_sharded``: this
    rank's experts ("ep") or ffn columns ("tp") over the ``tp`` axis."""
    if spec.ffn != "moe" or not _moe_sharded(ctx):
        return None
    from repro_torch.models.moe_sharded import moe_mode
    sh = ctx.shard
    tp = sh.tp
    if moe_mode(spec.moe, sh.mesh, sh.cp_axis, tp) == "ep":
        return {f"ffn.{n}": (tp, None, None)
                for n in ("w_gate", "w_up", "w_down")}
    return {"ffn.w_gate": (None, None, tp), "ffn.w_up": (None, None, tp),
            "ffn.w_down": (None, tp, None)}


def _moe(p, h2, spec: LayerSpec, ctx: Ctx):
    """``moe_fwd_sharded`` on this rank's block: "ep" takes the (dp, cp)
    block; "tp" takes every position of the rank's batch block, so a
    split sequence is gathered along ``cp_axis`` first (sum adjoint) and
    the rank keeps its rows of the output."""
    from repro_torch.models.moe_sharded import moe_fwd_sharded, moe_mode
    sh = ctx.shard
    mode = moe_mode(spec.moe, sh.mesh, sh.cp_axis, sh.tp)
    x = h2
    if mode == "tp" and ctx.seq_split:
        x = _gather_seq(h2, ctx)
    y = moe_fwd_sharded(p, x, spec.moe, mesh=sh.mesh,
                        cp_axis=sh.cp_axis if mode == "ep" else None,
                        tp_axis=sh.tp)
    if y.shape[1] != h2.shape[1]:
        i = sh.mesh.axis_index(sh.cp_axis)
        y = y[:, i * h2.shape[1]:(i + 1) * h2.shape[1]]
    return y


def layer_fwd(p: Layer, x, spec: LayerSpec, cfg: ModelConfig, ctx: Ctx,
              cache):
    """-> (x, cache, aux).  ``aux``, the MoE layer's load-balance loss
    (``moe.aux_load_balance_loss``), is computed in train mode only; it
    is 0.0 for every other layer and mode.  On a mesh its value is the
    whole pass's and its gradient this rank's share."""
    h = L.norm_fwd(p.ln1, x, cfg.norm, cfg.norm_eps)
    if spec.mixer == "spectral":
        from repro_torch.models.spectral import spectral_mixer
        if ctx.seq_split:
            y = spectral_mixer(h, seq_axis_name=ctx.shard.cp_axis,
                               mesh=ctx.shard.mesh, batch_spec=ctx.shard.dp)
        else:
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
            aux = moe_lib.aux_load_balance_loss(
                p.ffn, h2, spec.moe, mesh=ctx.shard and ctx.shard.mesh,
                axes=grad_axes(ctx.shard))
        if _moe_sharded(ctx):
            return x + _moe(p.ffn, h2, spec, ctx), cache, aux
        return x + moe_lib.moe_fwd(p.ffn, h2, spec.moe), cache, aux
    if spec.ffn == "rwkv_cm":
        rc = None if ctx.mode == "train" else cache["rec"]
        prev = None if rc is None else rc["x_prev_ffn"]
        if ctx.seq_split:
            from repro_torch.parallel.seqscan import cp_halo
            prev = cp_halo(h2, ctx.shard.mesh, ctx.shard.cp_axis, 1,
                           None if prev is None else prev[:, None])[:, 0]
        y = L.ffn_fwd(p.ffn, h2, "rwkv_cm", x_prev=L.token_shift(h2, prev))
        if rc is not None:
            last = h2[:, -1]
            if ctx.seq_split:
                from repro_torch.parallel.seqscan import from_last_rank
                last = from_last_rank(last, ctx.shard.mesh, ctx.shard.cp_axis)
            rc["x_prev_ffn"].copy_(last)
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
                enc_len: int = 0, dtype=torch.bfloat16, device=None,
                mesh=None) -> list:
    """Per-layer caches mirroring ``Model.stages``: ``caches[si][li]``, on
    ``device`` (default: the current CUDA card).  ``enc_len``: the encoder
    memory's length, for the cross-attention caches.

    On a ``mesh`` each tensor is this rank's block of the global cache
    by ``parallel.sharding.cache_specs`` on the mesh's own axes
    (``parallel.sharding.mesh_axes``, as the steps' batch split): batch
    over the dp axes, the slots of k/v, the MLA latent and the
    cross cache over the ``tp`` axis, the recurrent state batch-only and
    ``pos`` whole.  A slot-sharded cache is recognised by its slot dim
    being shorter than its ``pos``."""
    device = resolve_device(device)
    if mesh is None:
        return [[kc.init_layer_cache(spec, batch, max_len, dtype, device,
                                     d_model=cfg.d_model, enc_len=enc_len)
                 for _ in range(stage.repeat) for spec in stage.pattern]
                for stage in cfg.stages]
    from repro_torch.parallel import sharding as sh
    full = init_caches(cfg, batch, max_len, enc_len, dtype, "meta")
    specs = sh.cache_specs(full, mesh, sh.mesh_axes(mesh))

    def build(node, spec, parent=""):
        if isinstance(node, dict):     # a leaf's parent names its cache
            return {k: build(v, spec[k], k if isinstance(v, dict) else parent)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, s, parent) for v, s in zip(node, spec)]
        if node.dtype == torch.int32:           # pos: whole on every rank
            n = node.shape[0]
            if parent == "cross":
                return torch.arange(n, dtype=torch.int32, device=device)
            return torch.full((n,), -1, dtype=torch.int32, device=device)
        box = spec_slices(spec, node.shape, mesh.shape, mesh.coords)
        return torch.zeros([b.stop - b.start for b in box], dtype=node.dtype,
                           device=device)

    return build(full, specs)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def encode(model: Model, cfg: ModelConfig, frames: torch.Tensor,
           kv_block: int = 1024, shard: Optional[ShardCtx] = None
           ) -> torch.Tensor:
    """Encoder stack (whisper): stub frame embeddings (B, T, d_model) ->
    memory (B, T, d_model) in the compute dtype.  Its self-attention is a
    non-causal segment at position 0 (``start`` the int 0), the
    flash-attention kernel's case when no gradient is taken through it
    (else the blockwise core, as in the reference's training pass).

    ``shard`` (the port's: the reference's ``encode`` takes none): the
    decoder pass's context.  The rank runs its batch block of ``frames``
    over the whole frame sequence; a Model that holds blocks gathers each
    layer's weights, and their gradient is summed over the decoder's
    :func:`grad_axes` (its split queries each send part of the memory's
    gradient)."""
    e = cfg.encoder
    if e is None:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames.to(getattr(torch, cfg.dtype))
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ctx = Ctx(mode="train", q_pos=pos, start=0, prefix_len=0,
              kv_block=kv_block, shard=shard,
              layout=getattr(model, "layout", None))
    for t, layer in enumerate(model.encoder.layers):
        x, _, _ = _apply(layer, f"encoder.layers.{t}.", ctx, layer_fwd, x,
                         e.layer, cfg, ctx, None)
    return _apply(model.encoder.final_norm, "encoder.final_norm.", ctx,
                  _norm, x, cfg)


def _norm(p, x, cfg: ModelConfig):
    return L.norm_fwd(p, x, cfg.norm, cfg.norm_eps)


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


def _embed(p, tokens, cfg: ModelConfig):
    return L.embed_fwd(p, tokens, getattr(torch, cfg.dtype),
                       cfg.emb_scale_by_dim)


def _logits(p, x, cfg: ModelConfig):
    return L.logits_fwd(p, x, cfg.logit_softcap)


def logits(model: Model, cfg: ModelConfig, x: torch.Tensor,
           shard: Optional[ShardCtx] = None) -> torch.Tensor:
    """Final-normed hidden states -> logits, with the embedding's weights
    as this rank computes with them under ``shard``."""
    return _apply(model.embed, "embed.", _weights_ctx(model, shard),
                  _logits, x, cfg)


def _layer(layer, prefix, ctx: Ctx, x, spec, cfg, cache):
    return _apply(layer, prefix, ctx, layer_fwd, x, spec, cfg, ctx, cache,
                  want=_moe_views(spec, ctx))


def forward(model: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "train", caches=None, start: int = 0,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, kv_block: int = 1024,
            scan_chunk: Optional[int] = None, remat: Optional[bool] = None,
            return_hidden: bool = False, shard: Optional[ShardCtx] = None,
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

    ``shard``: the mesh (:class:`ShardCtx`).  ``tokens``,
    ``prefix_embeds`` and ``enc_out`` are then this rank's batch block
    (B/dp rows) over the whole sequence, and ``caches`` its block of the
    caches (``init_caches(mesh=)``).  Every layer runs on the rank's
    (B/dp, S/cp) block of the P + S positions (:func:`seq_block`; the
    whole sequence in decode and where it does not split,
    :func:`for_seq`), with global positions ``start + lo + arange``; the
    logits (or hidden states) are the rank's block of the emitted
    positions (:func:`emitted_block`).  Every rank of the mesh calls it.
    """
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if shard is not None and not isinstance(shard, ShardCtx):
        raise TypeError(f"shard must be a ShardCtx, got {type(shard)}")
    remat = (mode == "train") if remat is None else remat
    remat_kw = _remat_kwargs(remat_policy)
    dtype = getattr(torch, cfg.dtype)
    n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    total = tokens.shape[1] + n_prefix
    shard = for_seq(shard, cfg, total, mode)
    lo, hi = seq_block(shard, total)
    ctx = Ctx(mode=mode, q_pos=None, start=start,
              prefix_len=n_prefix if cfg.prefix_lm else 0,
              kv_block=kv_block, scan_chunk=scan_chunk, enc_out=enc_out,
              shard=shard, layout=getattr(model, "layout", None))
    if n_prefix:
        x = _apply(model.embed, "embed.", ctx, _embed, tokens, cfg)
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
        if (lo, hi) != (0, total):
            x = x[:, lo:hi]
    else:
        x = _apply(model.embed, "embed.", ctx, _embed,
                   tokens if (lo, hi) == (0, total) else tokens[:, lo:hi],
                   cfg)
    q_pos = start + torch.arange(lo, hi, dtype=torch.int32, device=x.device)
    seq_pos = None
    if (lo, hi) != (0, total):
        seq_pos = start + torch.arange(total, dtype=torch.int32,
                                       device=x.device)
    ctx = ctx._replace(q_pos=q_pos, seq_pos=seq_pos)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        for li, layer in enumerate(model.stages[si]):
            spec = stage.pattern[li % len(stage.pattern)]
            prefix = f"stages.{si}.{li}."
            if caches is None and remat \
                    and L.takes_grad(x, *layer.parameters()):
                x, _, aux = checkpoint(_layer, layer, prefix, ctx, x, spec,
                                       cfg, None, use_reentrant=False,
                                       **remat_kw)
            else:
                cache = caches[si][li] if caches is not None else None
                x, _, aux = _layer(layer, prefix, ctx, x, spec, cfg, cache)
            aux_total = aux_total + aux
    x = _apply(model.final_norm, "final_norm.", ctx, _norm, x, cfg)
    if n_prefix:
        x = x[:, max(n_prefix - lo, 0):]
    if return_hidden:
        if mode == "train":
            return x, caches, aux_total
        return x, caches
    return _apply(model.embed, "embed.", ctx, _logits, x, cfg), caches
