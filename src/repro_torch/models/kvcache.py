"""Cache structures: full, ring (sliding-window), MLA-latent and
cross-attention caches, and the recurrent state.

Port of ``repro/models/kvcache.py``.  Every attention cache carries an
explicit per-slot global-position vector ``pos`` (-1 = empty); attention
masks are evaluated from it, so full and ring caches share the attention
code path.  ``pos`` is batch-agnostic (the serve loop decodes in
lock-step).  The recurrent cache holds the mixer's state and the
token-shift inputs; ``models/model.py`` writes them in place, as the
attention writes below do.  The cross-attention cache holds the encoder
memory's projected k/v (B, enc_len, KV, hd) with ``pos =
arange(enc_len)``; the prefill writes it in place, decode reads it.

The reference returns new arrays; :func:`write_attn_cache` and
:func:`write_latent_cache` write into the cache's tensors in place (the
cache is the largest state of a decode step) and return the same dict.

Layout contract (the reference's DESIGN.md §4): on a mesh the slot axis
is sharded over the ``model`` axis and the batch over ``data``
(``models.init_caches(mesh=)``).  A rank's cache then holds slots
[first, first + k.shape[1]) of ``pos.shape[0]``, and ``pos`` whole; the
writes take ``first`` and touch only the rank's slots (and ``pos``): a
decode token lands on the one rank that holds its slot, and a prefill
writes each rank's slots from the whole segment's K/V.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import (AttentionSpec, LayerSpec,
                                       RecurrentSpec)


def init_attn_cache(spec: AttentionSpec, batch: int, max_len: int, dtype,
                    device=None) -> dict:
    """Allocate an empty attention cache for one layer: ``k``/``v``, or
    for MLA the joint ``latent`` (B, slots, kv_lora + rope)."""
    n_slots = min(max_len, spec.window) if spec.window else max_len
    pos = torch.full((n_slots,), -1, dtype=torch.int32, device=device)
    if spec.kind == "mla":
        width = spec.kv_lora_rank + spec.qk_rope_dim
        return {"latent": torch.zeros(batch, n_slots, width, dtype=dtype,
                                      device=device), "pos": pos}
    shape = (batch, n_slots, spec.n_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def init_recurrent_cache(spec: RecurrentSpec, d_model: int, batch: int,
                         dtype, device=None) -> dict:
    """RG-LRU: the state ``h`` (float32) and the conv's trailing inputs;
    RWKV-6: the matrix state ``s`` (float32) and the last input of the
    time mix.  Both hold ``x_prev_ffn``, the channel mix's last input."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    if spec.kind == "rglru":
        ds = spec.d_state or d_model
        return {"h": zeros(batch, ds, dt=torch.float32),
                "conv": zeros(batch, spec.conv_width - 1, ds),
                "x_prev_ffn": zeros(batch, d_model)}
    n_heads = spec.n_heads or d_model // 64
    dk = d_model // n_heads
    return {"s": zeros(batch, n_heads, dk, dk, dt=torch.float32),
            "x_prev": zeros(batch, d_model),
            "x_prev_ffn": zeros(batch, d_model)}


def init_layer_cache(spec: LayerSpec, batch: int, max_len: int, dtype,
                     device=None, d_model=None, enc_len: int = 0) -> dict:
    """One layer's cache: ``self`` for attention, ``rec`` for a recurrent
    mixer (which needs ``d_model``; it also holds the RWKV channel mix's
    ``x_prev_ffn``), and ``cross`` for a decoder layer that attends to an
    encoder memory of ``enc_len`` frames; the FNet mixer keeps none."""
    cache = {}
    if spec.mixer == "attn":
        cache["self"] = init_attn_cache(spec.attn, batch, max_len, dtype,
                                        device)
    elif spec.mixer in ("rglru", "rwkv6"):
        if d_model is None:
            raise ValueError(f"a {spec.mixer} layer cache needs d_model")
        cache["rec"] = init_recurrent_cache(spec.recurrent, d_model, batch,
                                            dtype, device)
    if spec.cross_attn:
        if enc_len <= 0:
            raise ValueError("a cross-attention layer cache needs enc_len, "
                             "the encoder memory's length")
        a = spec.attn
        shape = (batch, enc_len, a.n_kv_heads, a.head_dim)
        cache["cross"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.arange(enc_len, dtype=torch.int32, device=device),
        }
    return cache


def _write_slots(cache: dict, news: dict, start: int, first: int) -> dict:
    """A segment at global positions [start, start + S) into a
    slot-sharded cache (slot = pos % slots): each tensor of ``news``
    (B, S, ...) into the rank's slots [first, first + local) of the
    cache's tensor of that name, and every slot's position into the
    whole ``pos``.  The indices are made on the host, in numpy (no wait
    on the card, and no value read from a tensor: the dry run's fake
    tensors have none)."""
    n_slots = cache["pos"].shape[0]
    local = next(iter(news.values()))
    s_new = local.shape[1]
    positions = np.arange(start, start + s_new)
    slots = positions % n_slots
    dev = cache["pos"].device
    cache["pos"][torch.from_numpy(slots).to(dev)] = torch.from_numpy(
        positions).to(dev, torch.int32)
    n_local = cache[next(iter(news))].shape[1]
    sel = np.nonzero((slots >= first) & (slots < first + n_local))[0]
    if sel.size:
        dst = torch.from_numpy(slots[sel] - first).to(dev)
        src = torch.from_numpy(sel).to(dev)
        for name, new in news.items():
            cache[name][:, dst] = new[:, src].to(cache[name].dtype)
    return cache


def write_attn_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                     start: int, first: int = 0) -> dict:
    """Insert a segment of S_new tokens at global positions
    [start, start+S_new), in place.

    Full cache: slots == positions.  Ring cache of W slots: slot = pos % W;
    for segments longer than W only the last W entries land (their slots
    form exactly one wrap-around window).  A shorter multi-token segment
    must not wrap (the reference's clamped update would misplace it).
    ``first``: the global index of the rank's first slot when the cache
    is slot-sharded (its slot dim shorter than ``pos``).
    """
    n_slots = cache["pos"].shape[0]
    s_new = k_new.shape[1]
    if s_new > n_slots:  # only the trailing window survives
        k_new = k_new[:, -n_slots:]
        v_new = v_new[:, -n_slots:]
        start = start + (s_new - n_slots)
        s_new = n_slots
    slot0 = start % n_slots
    if 1 < s_new < n_slots and slot0 + s_new > n_slots:
        raise ValueError(f"a {s_new}-token segment at position {start} wraps "
                         f"the {n_slots}-slot cache")
    if cache["k"].shape[1] < n_slots:
        return _write_slots(cache, {"k": k_new, "v": v_new}, start, first)
    positions = start + torch.arange(s_new, dtype=torch.int32,
                                     device=cache["pos"].device)
    if s_new == n_slots:
        # rotate the segment so slot i holds the entry with pos % W == i
        cache["k"].copy_(torch.roll(k_new, slot0, dims=1))
        cache["v"].copy_(torch.roll(v_new, slot0, dims=1))
        cache["pos"].copy_(torch.roll(positions, slot0))
        return cache
    if s_new == 1:  # decode
        cache["k"][:, slot0] = k_new[:, 0]
        cache["v"][:, slot0] = v_new[:, 0]
        cache["pos"][slot0] = start
        return cache
    # non-wrapping multi-token segment (prefill shorter than the window)
    cache["k"][:, slot0:slot0 + s_new] = k_new
    cache["v"][:, slot0:slot0 + s_new] = v_new
    cache["pos"][slot0:slot0 + s_new] = positions
    return cache


def write_latent_cache(cache: dict, latent_new: torch.Tensor,
                       start: int, first: int = 0) -> dict:
    """Insert a segment of MLA latents at global positions
    [start, start+S_new), in place: one slot for a decode token (slot =
    pos % slots), a run of slots for a prefill segment, which must not
    wrap.  ``first``: as in :func:`write_attn_cache`."""
    n_slots = cache["pos"].shape[0]
    s_new = latent_new.shape[1]
    slot0 = start % n_slots
    if s_new > 1 and slot0 + s_new > n_slots:
        raise ValueError(f"a {s_new}-token segment at position {start} wraps "
                         f"the {n_slots}-slot latent cache")
    if cache["latent"].shape[1] < n_slots:
        return _write_slots(cache, {"latent": latent_new}, start, first)
    if s_new == 1:  # decode
        cache["latent"][:, slot0] = latent_new[:, 0]
        cache["pos"][slot0] = start
        return cache
    cache["latent"][:, slot0:slot0 + s_new] = latent_new
    cache["pos"][slot0:slot0 + s_new] = start + torch.arange(
        s_new, dtype=torch.int32, device=cache["pos"].device)
    return cache
