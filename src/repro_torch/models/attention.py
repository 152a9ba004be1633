"""Attention family: GQA/MQA, sliding-window, prefix-LM masks and
DeepSeek-style MLA over one blockwise online-softmax core.

Port of ``repro/models/attention.py``.  Masks are evaluated from
explicit global position vectors, so full caches, ring (sliding-window)
caches and offset decode queries share one code path: empty cache slots
carry position -1 and mask themselves out.  ``NEG_INF`` is finite so
fully masked rows stay NaN-free.

Self-attention over a whole segment that starts at position 0 (train and
prefill passes, the encoder's non-causal layers, no prefix-LM span) is
exactly the function of the hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), and
:func:`gqa_fwd` sends that case there when its head dims are within the
kernel's ``D_MAX`` and no gradient is taken through it; every other call
(a training pass whose q, k or v requires grad, decode over the cache,
cross-attention over an encoder memory, a segment at an offset,
prefix-LM, head_dim 256 as in gemma3, recurrentgemma and paligemma)
runs :func:`blockwise_attention` in plain torch, as the reference does:
the kernel has no backward, and the reference's training pass
differentiates the blockwise core.  The route depends on the shapes and
the grad state alone, so the CPU takes the route the card takes.  MLA
always runs the blockwise core, as the reference does: its head dims
(576/512 absorbed, 192/128 decompressed) are past the kernel's
``D_MAX``.

Distribution (the reference's ``kv_spec``/``kv_local_spec`` hints): on
a mesh the query sequence is split over the context-parallel axis, and
K/V (MLA: the joint latent) are projected from the rank's block, then
gathered along it (``kv_gather``, with the gradient summed back,
``core.mesh.Mesh.gather_sum``); the split queries at their global
positions never take the kernel (its function is a segment attending to
itself from position 0).  At decode time the cache stays slot-sharded:
each rank attends over its slots and keeps the online softmax's
(max, sum, acc), and the ranks of the ``tp`` axis combine these in
float32 in rank order (``combine``; the reference's GSPMD
flash-decoding).  The cache is never gathered.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import D_MAX, flash_attention
from repro_torch.models.config import AttentionSpec
from repro_torch.models.layers import (apply_rope, master_param, rope_angles,
                                       takes_grad, truncated_normal_)

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


class MaskSpec(NamedTuple):
    causal: bool = True
    window: Optional[int] = None     # sliding window (tokens back)
    prefix_len: int = 0              # prefix-LM: bidirectional first P tokens


def _mask_block(ms: MaskSpec, q_pos: torch.Tensor, k_pos: torch.Tensor):
    """(Sq, Sk) boolean mask from global positions (k_pos < 0 = empty)."""
    qi = q_pos[:, None]
    ki = k_pos[None, :]
    ok = ki >= 0
    if ms.causal:
        allowed = ki <= qi
        if ms.prefix_len:
            allowed = allowed | (ki < ms.prefix_len)
        ok = ok & allowed
    if ms.window is not None:
        ok = ok & (qi - ki < ms.window)
    return ok


class GQA(nn.Module):
    def __init__(self, d: int, a: AttentionSpec, device=None):
        super().__init__()
        self.wq = master_param(d, a.n_heads, a.head_dim, device=device)
        self.wk = master_param(d, a.n_kv_heads, a.head_dim, device=device)
        self.wv = master_param(d, a.n_kv_heads, a.head_dim, device=device)
        self.wo = master_param(a.n_heads, a.head_dim, d, device=device)


def init_gqa(d: int, a: AttentionSpec, generator=None, device=None) -> GQA:
    p = GQA(d, a, device)
    std = d ** -0.5
    for w in (p.wq, p.wk, p.wv):
        truncated_normal_(w.data, std, generator)
    truncated_normal_(p.wo.data, (a.n_heads * a.head_dim) ** -0.5, generator)
    return p


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention: the reference tree's keys,
    with the query either low-rank (``w_dq``, ``w_uq``) or full (``wq``)."""

    def __init__(self, d: int, a: AttentionSpec, device=None):
        super().__init__()
        qd = a.qk_nope_dim + a.qk_rope_dim
        self.w_dkv = master_param(d, a.kv_lora_rank + a.qk_rope_dim,
                                  device=device)
        self.w_uk = master_param(a.kv_lora_rank, a.n_heads, a.qk_nope_dim,
                                 device=device)
        self.w_uv = master_param(a.kv_lora_rank, a.n_heads, a.v_head_dim,
                                 device=device)
        self.wo = master_param(a.n_heads, a.v_head_dim, d, device=device)
        if a.q_lora_rank:
            self.w_dq = master_param(d, a.q_lora_rank, device=device)
            self.w_uq = master_param(a.q_lora_rank, a.n_heads, qd,
                                     device=device)
        else:
            self.wq = master_param(d, a.n_heads, qd, device=device)


def init_mla(d: int, a: AttentionSpec, generator=None, device=None) -> MLA:
    p = MLA(d, a, device)
    std = d ** -0.5
    truncated_normal_(p.w_dkv.data, std, generator)
    truncated_normal_(p.w_uk.data, a.kv_lora_rank ** -0.5, generator)
    truncated_normal_(p.w_uv.data, a.kv_lora_rank ** -0.5, generator)
    truncated_normal_(p.wo.data, (a.n_heads * a.v_head_dim) ** -0.5,
                      generator)
    if a.q_lora_rank:
        truncated_normal_(p.w_dq.data, std, generator)
        truncated_normal_(p.w_uq.data, a.q_lora_rank ** -0.5, generator)
    else:
        truncated_normal_(p.wq.data, std, generator)
    return p


def init_attention(d: int, a: AttentionSpec, generator=None, device=None):
    init = init_mla if a.kind == "mla" else init_gqa
    return init(d, a, generator, device)


# --------------------------------------------------------------------------
# blockwise online-softmax core
# --------------------------------------------------------------------------

def _block_step(qg, kj, vj, mask, m, l, acc):
    """One kv block of the online softmax: (m, l, acc) -> the new carry."""
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kj.float())
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    scale_prev = torch.exp(m - m_new)
    l = l * scale_prev + p.sum(-1)
    acc = acc * scale_prev[..., None] + torch.einsum(
        "bqkgc,bckd->bqkgd", p.to(vj.dtype).float(), vj.float())
    return m_new, l, acc


def combine_partials(m, l, acc, mesh, axis) -> tuple:
    """The online softmax's carry (m, l, acc) over every rank's keys of
    ``axis``: the ranks' float32 partials are exchanged with one counted
    all-reduce (each rank's in its own row of a zeroed buffer) and merged
    in rank order, the same on every rank."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    parts = [m.reshape(-1), l.reshape(-1), acc.reshape(-1)]
    sizes = [t.numel() for t in parts]
    buf = torch.zeros(n, sum(sizes), dtype=torch.float32, device=m.device)
    buf[me] = torch.cat(parts)
    buf = mesh.all_reduce(buf, axis).wait()
    ms_, ls_, accs = buf.split(sizes, dim=1)
    ms_ = ms_.reshape(n, *m.shape)
    ls_ = ls_.reshape(n, *l.shape)
    accs = accs.reshape(n, *acc.shape)
    m_all = ms_.amax(0)
    l_all = torch.zeros_like(l)
    acc_all = torch.zeros_like(acc)
    for r in range(n):
        w = torch.exp(ms_[r] - m_all)
        l_all = l_all + ls_[r] * w
        acc_all = acc_all + accs[r] * w[..., None]
    return m_all, l_all, acc_all


def blockwise_attention(q, k, v, ms: MaskSpec, q_pos, k_pos, *,
                        kv_block: int = 1024, remat_step: bool = True,
                        combine=None) -> torch.Tensor:
    """q (B,Sq,H,hd) · k,v (B,Sk,KV,hd) -> (B,Sq,H,hd_v) in float32.

    Online softmax over kv blocks (peak score memory O(Sq * kv_block)),
    GQA grouping by reshaping q to (…, KV, G, hd).  ``q_pos`` (Sq,) /
    ``k_pos`` (Sk,) are global indices.  Products accumulate in float32;
    p is cast to v's dtype before the second product, as the reference
    does.

    ``remat_step``: when a gradient is taken through more than one kv
    block, each block's step runs in ``torch.utils.checkpoint``, so the
    backward recomputes the (Sq x blk) probabilities instead of keeping
    them as float32 residuals (the reference's ``jax.checkpoint`` of its
    scan step, the flash-backward memory trade).

    ``combine`` = (mesh, axis): k/v are this rank's slots of keys spread
    over ``axis``; the carry is merged over it (:func:`combine_partials`)
    before the normalisation.  No gradient is taken through it.
    """
    b, sq, h, hd = q.shape
    _, sk, kv_heads, hd_v = v.shape
    g = h // kv_heads
    qg = q.reshape(b, sq, kv_heads, g, hd).float()
    blk = min(kv_block, sk)
    while sk % blk:            # largest divisor of sk not exceeding kv_block
        blk -= 1
    remat = remat_step and sk > blk and takes_grad(q, k, v)
    m = torch.full((b, sq, kv_heads, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, sq, kv_heads, g, hd_v, dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, blk):
        args = (qg, k[:, c0:c0 + blk], v[:, c0:c0 + blk],
                _mask_block(ms, q_pos, k_pos[c0:c0 + blk]), m, l, acc)
        if remat:
            m, l, acc = checkpoint(_block_step, *args, use_reentrant=False)
        else:
            m, l, acc = _block_step(*args)
    if combine is not None:
        m, l, acc = combine_partials(m, l, acc, *combine)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd_v)


# --------------------------------------------------------------------------
# layer forwards.  Contract:
#   attention_fwd(p, x, a, ms, q_pos, kv=None, k_pos=None, ...)
#     -> (y, new_kv)
#   kv is None        : self-attention over x (train / prefill);
#                       new_kv = this segment's (k, v) (or MLA latent)
#   kv = (k_buf,v_buf): attend over the provided buffers (decode cache with
#                       the current token already written; MLA: the latent
#                       buffer); new_kv echoes them back
#   kv_gather         : with kv None, the gather of the projected K/V (MLA:
#                       the latent) along the context-parallel axis; k_pos
#                       then gives the gathered keys' positions, and new_kv
#                       is the gathered (k, v)
#   combine           : (mesh, axis) merging the partial softmaxes of a
#                       slot-sharded cache (blockwise_attention)
# --------------------------------------------------------------------------

def gqa_project_kv(p: GQA, x, a: AttentionSpec, positions):
    """Project (and rope) this segment's k/v — used to fill decode caches."""
    dt = x.dtype
    k = torch.einsum("bsd,dgk->bsgk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dgk->bsgk", x, p.wv.to(dt))
    if a.use_rope:
        cos, sin = rope_angles(positions, a.head_dim, a.rope_theta)
        k = apply_rope(k, cos, sin)
    return k, v


def gqa_fwd(p: GQA, x, a: AttentionSpec, ms: MaskSpec, q_pos, kv=None,
            k_pos=None, *, start=None, kv_block: int = 1024,
            kv_gather=None, combine=None):
    """``start``: the Python int position of ``x[:, 0]`` when the caller
    knows it (``Ctx.start``); a segment at 0 attends through the kernel."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    if a.use_rope:
        cos, sin = rope_angles(q_pos, a.head_dim, a.rope_theta)
        q = apply_rope(q, cos, sin)
    if kv is None:
        k, v = gqa_project_kv(p, x, a, q_pos)
        if kv_gather is None:
            k_pos = q_pos
        else:   # one gather for both
            k, v = kv_gather(torch.stack([k, v], dim=2)).unbind(2)
    else:
        k, v = kv
    scale = a.scale or a.head_dim ** -0.5
    if kv is None and kv_gather is None and type(start) is int \
            and start == 0 and ms.prefix_len == 0 and q.shape[-1] <= D_MAX \
            and v.shape[-1] <= D_MAX and not takes_grad(q, k, v):
        # positions 0..S-1 on both sides, head dims the kernel takes, no
        # gradient through it: the flash-attention kernel's case
        o = flash_attention((q * scale).contiguous(), k.contiguous(),
                            v.contiguous(), causal=ms.causal,
                            window=ms.window, scale=1.0)
    else:
        o = blockwise_attention(q * scale, k, v, ms, q_pos, k_pos,
                                kv_block=kv_block, combine=combine)
    y = torch.einsum("bshk,hkd->bsd", o.to(dt), p.wo.to(dt))
    return y, (k, v)


def mla_project_latent(p: MLA, x, a: AttentionSpec):
    """Joint latent [c_kv | k_rope_unrotated], the cached quantity."""
    return x @ p.w_dkv.to(x.dtype)


def mla_fwd(p: MLA, x, a: AttentionSpec, ms: MaskSpec, q_pos, kv=None,
            k_pos=None, *, kv_block: int = 1024, absorbed=None,
            kv_gather=None, combine=None):
    """DeepSeek-V2 MLA.  Cache = joint latent (B, S, kv_lora+rope); k_rope
    is rotated at read time from the absolute k positions, so the cached
    latent is position-free (empty slots at -1 stay finite and are
    masked).

    ``absorbed=True`` (``mla_absorb="always"``, the default): W_uk/W_uv
    are absorbed into the query and output sides, so attention is MQA
    over the latent: K = [c_kv | k_rope] (one kv_lora+rope wide kv head),
    V = c_kv.  ``absorbed=False`` is the paper-literal decompression to
    per-head K/V; ``"decode"`` absorbs for 1-token passes only.  The
    softmax scale is (qk_nope + qk_rope)^-1/2 either way.
    """
    dt = x.dtype
    if absorbed is None:
        absorbed = {"always": True, "never": False,
                    "decode": x.shape[1] == 1}[a.mla_absorb]
    nope, rank = a.qk_nope_dim, a.kv_lora_rank
    if a.q_lora_rank:
        q = torch.einsum("bsr,rhk->bshk", x @ p.w_dq.to(dt), p.w_uq.to(dt))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], *rope_angles(q_pos, a.qk_rope_dim,
                                                    a.rope_theta))
    if kv is None:
        latent = mla_project_latent(p, x, a)
        if kv_gather is None:
            k_pos = q_pos
        else:
            latent = kv_gather(latent)
    else:
        latent = kv
    c_kv = latent[..., :rank]
    # rope at the stored absolute positions: (B, T, 1, rope)
    k_rope = apply_rope(latent[..., None, rank:],
                        *rope_angles(k_pos, a.qk_rope_dim, a.rope_theta))
    scale = a.scale or (nope + a.qk_rope_dim) ** -0.5
    if absorbed:
        # score side: q_lat[h] = q_nope[h] @ W_uk[:, h, :]^T
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p.w_uk.to(dt))
        q_full = torch.cat([q_lat, q_rope], dim=-1)
        k_full = torch.cat([c_kv[..., None, :], k_rope], dim=-1)
        o_lat = blockwise_attention(q_full * scale, k_full,
                                    c_kv[..., None, :], ms, q_pos, k_pos,
                                    kv_block=kv_block, combine=combine)
        # output side: o[h] = o_lat[h] @ W_uv[:, h, :]
        o = torch.einsum("bshr,rhv->bshv", o_lat.to(dt), p.w_uv.to(dt))
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uk.to(dt))
        v = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uv.to(dt))
        k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1],
                                             a.qk_rope_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        o = blockwise_attention(q_full * scale, k, v, ms, q_pos, k_pos,
                                kv_block=kv_block, combine=combine)
    y = torch.einsum("bshk,hkd->bsd", o.to(dt), p.wo.to(dt))
    return y, latent


def attention_fwd(p, x, a: AttentionSpec, ms: MaskSpec, q_pos, kv=None,
                  k_pos=None, *, start=None, kv_block: int = 1024,
                  kv_gather=None, combine=None):
    if a.kind == "mla":
        return mla_fwd(p, x, a, ms, q_pos, kv, k_pos, kv_block=kv_block,
                       kv_gather=kv_gather, combine=combine)
    return gqa_fwd(p, x, a, ms, q_pos, kv, k_pos, start=start,
                   kv_block=kv_block, kv_gather=kv_gather, combine=combine)
