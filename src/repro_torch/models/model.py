"""Model assembly: embedding -> stages of layer patterns -> logits.

Port of ``repro/models/model.py`` for attention stacks (GQA and MLA)
with dense or MoE FFNs (``models/moe.py``), the parameter-free spectral
(FNet) mixer (``models/spectral.py``) and the linear-recurrence mixers
(RG-LRU and RWKV-6 with its channel mix, ``models/recurrent.py``).  The
reference scans each stage's ``repeat`` groups over parameters stacked on
a leading repeat axis; here a stage is an ``nn.ModuleList`` of its layers,
group by group (layer ``t * len(pattern) + pi`` is pattern entry ``pi`` of
group ``t``), and the caches follow the same per-layer layout
(:func:`init_caches`).  :func:`repro_torch.models.convert.params_from_numpy`
carries a reference parameter tree across.

Three modes share one layer implementation:
  train    full-sequence pass, no cache I/O (inference only in this
           slice: the teacher-forcing oracle; no gradients, no remat)
  prefill  full sequence + writes the KV, latent or recurrent caches
           (serving cold start)
  decode   single token against the caches (serving steady state)

Every cache is written in place (``copy_`` into the tensors that
:func:`init_caches` made), so ``forward`` returns the caches it was
given.  Cross-attention, encoder and prefix-embed paths (``ROADMAP.md``
queue 1 item 8c) and the sharded context (``ShardCtx``, item 8e, which
would route MoE layers through ``models/moe_sharded.py`` and recurrent
layers through ``parallel/seqscan.py``) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import kvcache as kc
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import LayerSpec, ModelConfig

LM_ITEM = "ROADMAP.md queue 1 item 8"


class Ctx(NamedTuple):
    """Per-call context threaded through the layer stack."""
    mode: str                      # "train" | "prefill" | "decode"
    q_pos: torch.Tensor            # (S,) global positions of this segment
    start: int                     # global position of q_pos[0]
    prefix_len: int                # prefix-LM bidirectional span
    kv_block: int
    scan_chunk: Optional[int] = None   # recurrent chunk override


# --------------------------------------------------------------------------
# per-layer modules and forward
# --------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer: ``ln1``, the token mixer (GQA, MLA, RG-LRU or RWKV-6),
    ``ln2``, the channel mixer (a dense FFN, the RWKV channel mix or
    MoE).  The spectral mixer has no parameters (``mixer`` is None)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, generator=None,
                 device=None):
        super().__init__()
        if spec.cross_attn:
            raise NotImplementedError(f"cross-attention: {LM_ITEM}c")
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
    """-> (x, cache).  The reference's third output, the MoE auxiliary
    loss, is computed in train mode only, for the optimizer; this port
    has no training step yet, so it is dropped."""
    h = L.norm_fwd(p.ln1, x, cfg.norm, cfg.norm_eps)
    if spec.mixer == "spectral":
        from repro_torch.models.spectral import spectral_mixer
        y = spectral_mixer(h)
    elif spec.mixer == "attn":
        y, cache = _self_attention(p, h, spec, cfg, ctx, cache)
    else:
        y, cache = _recurrent(p, h, spec, cfg, ctx, cache)
    x = x + y
    h2 = L.norm_fwd(p.ln2, x, cfg.norm, cfg.norm_eps)
    if spec.ffn == "moe":
        return x + moe_lib.moe_fwd(p.ffn, h2, spec.moe), cache
    if spec.ffn == "rwkv_cm":
        rc = None if ctx.mode == "train" else cache["rec"]
        prev = None if rc is None else rc["x_prev_ffn"]
        y = L.ffn_fwd(p.ffn, h2, "rwkv_cm", x_prev=L.token_shift(h2, prev))
        if rc is not None:
            rc["x_prev_ffn"].copy_(h2[:, -1])
        return x + y, cache
    return x + L.ffn_fwd(p.ffn, h2, spec.ffn), cache


# --------------------------------------------------------------------------
# whole-model init
# --------------------------------------------------------------------------

class Model(nn.Module):
    """The embedding, the stages (``nn.ModuleList`` of layers each) and the
    final norm; parameters are fp32 masters drawn from ``generator`` on
    ``device`` (default: the current CUDA card; ``"cpu"`` or ``"meta"``
    when asked)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.encoder is not None or cfg.frontend != "none":
            raise NotImplementedError(f"encoder / modality frontend: "
                                      f"{LM_ITEM}c")
        self.embed = L.init_embedding(cfg.vocab, cfg.d_model,
                                      cfg.tie_embeddings, generator, device)
        self.stages = nn.ModuleList(
            nn.ModuleList(Layer(cfg, spec, generator, device)
                          for _ in range(stage.repeat)
                          for spec in stage.pattern)
            for stage in cfg.stages)
        self.final_norm = L.init_norm(cfg.norm, cfg.d_model, device)


def init_params(cfg: ModelConfig, generator=None, device=None) -> Model:
    return Model(cfg, generator, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> list:
    """Per-layer caches mirroring ``Model.stages``: ``caches[si][li]``, on
    ``device`` (default: the current CUDA card)."""
    device = resolve_device(device)
    return [[kc.init_layer_cache(spec, batch, max_len, dtype, device,
                                 d_model=cfg.d_model)
             for _ in range(stage.repeat) for spec in stage.pattern]
            for stage in cfg.stages]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@torch.no_grad()
def forward(model: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "train", caches=None, start: int = 0,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, kv_block: int = 1024,
            scan_chunk: Optional[int] = None, shard: Any = None):
    """Token ids (B, S) -> (logits (B, S, vocab), caches).

    ``start``: global position of tokens[0] (the decode step index), a
    Python int.  Prefill and decode write ``caches`` in place and return
    them; caches is None in train mode.  ``scan_chunk`` overrides the
    recurrent layers' chunk.
    """
    if shard is not None:
        raise NotImplementedError(f"sharded forward (ShardCtx): {LM_ITEM}e")
    if prefix_embeds is not None or enc_out is not None:
        raise NotImplementedError(f"prefix embeddings / encoder memory: "
                                  f"{LM_ITEM}c")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_fwd(model.embed, tokens, dtype, cfg.emb_scale_by_dim)
    q_pos = start + torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    ctx = Ctx(mode=mode, q_pos=q_pos, start=start, prefix_len=0,
              kv_block=kv_block, scan_chunk=scan_chunk)
    for si, stage in enumerate(cfg.stages):
        for li, layer in enumerate(model.stages[si]):
            cache = caches[si][li] if caches is not None else None
            x, _ = layer_fwd(layer, x, stage.pattern[li % len(stage.pattern)],
                             cfg, ctx, cache)
    x = L.norm_fwd(model.final_norm, x, cfg.norm, cfg.norm_eps)
    return L.logits_fwd(model.embed, x, cfg.logit_softcap), caches
