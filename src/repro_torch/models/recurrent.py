"""Linear-recurrence token mixers: Griffin RG-LRU and RWKV-6 (Finch).

Port of ``repro/models/recurrent.py``.  Both are chunked scans built on
numerically safe decay algebra: within a chunk every exponential is of a
**non-positive** quantity (cumulative log-decays are non-increasing), so
nothing overflows whatever the decay's magnitude; across chunks a Python
loop carries the state.

  RG-LRU  vector state  h_t = a_t ⊙ h_{t-1} + √(1-a_t²) i_t ξ_t
  RWKV-6  matrix state  S_t = diag(w_t) S_{t-1} + k_tᵀ v_t,
                        o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

Decode (S=1) degenerates to the plain one-step update.  The mixers are
``nn.Module``s whose parameter names and shapes are the reference's dict
keys (fp32 masters).  Where the reference multiplies a float32
activation by a weight that ``cast_to_compute`` made bf16, JAX promotes
the product to float32; ``torch.matmul`` refuses mixed dtypes, so the
weight is cast up to float32 here (never the activation down).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import RecurrentSpec
from repro_torch.models.layers import (master_param, takes_grad,
                                       token_shift, truncated_normal_)


# --------------------------------------------------------------------------
# generic chunked scans
# --------------------------------------------------------------------------

def _chunk_len(t: int, chunk: int) -> int:
    """The largest divisor of ``t`` not above ``chunk`` (the reference's
    rule)."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def _scan_chunk(la: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps (la, b) under the
    reference's combine ``(l1 + l2, exp(l2)·b1 + b2)``: a Hillis–Steele
    scan, log2(C) rounds, every exponent a sum of log-decays (≤ 0)."""
    c = la.shape[1]
    d = 1
    while d < c:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], torch.exp(la[:, d:]),
                                               b[:, :-d])], dim=1)
        la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return la, b


def vector_recurrence(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int = 256):
    """h_t = exp(log_a_t) ⊙ h_{t-1} + b_t over (B, T, D); h0 (B, D).

    Returns (h (B, T, D), h_last (B, D)).  Within a chunk a log-depth
    scan, across chunks a loop carrying h.
    """
    t = b.shape[1]
    c = _chunk_len(t, chunk)
    h, outs = h0, []
    for c0 in range(0, t, c):
        l_in, b_in = _scan_chunk(log_a[:, c0:c0 + c], b[:, c0:c0 + c])
        h_t = torch.addcmul(b_in, torch.exp(l_in), h[:, None, :])
        h = h_t[:, -1]
        outs.append(h_t)
    return torch.cat(outs, dim=1), h


def matrix_recurrence(log_w, k, v, r, u, s0, chunk: int = 64):
    """RWKV-style matrix-state scan.

    log_w, k, r : (B, T, H, K)   v : (B, T, H, V)   u : (H, K)
    s0          : (B, H, K, V)
    Returns (o (B, T, H, V), s_last).  All decay exponentials are ≤ 0:
    the pairs s ≥ t of a chunk, whose exponents are positive and could
    overflow, are masked in the exponent (to -inf) before ``exp``, so no
    ``inf`` (and no ``inf · 0``) is ever formed.
    """
    t = k.shape[1]
    c = _chunk_len(t, chunk)
    strict = torch.ones(c, c, dtype=torch.bool, device=k.device).tril(-1)
    masked = ~strict[None, :, :, None, None]          # s >= t
    grad = takes_grad(log_w, k, v, r, u, s0)
    s, outs = s0, []
    for c0 in range(0, t, c):
        lw, kk, vv, rr = (x[:, c0:c0 + c] for x in (log_w, k, v, r))
        dcum = torch.cumsum(lw, dim=1)           # non-increasing in t
        d_prev = dcum - lw                       # cum through t-1
        # state readout: o_state[t] = (r_t ⊙ exp(d_prev[t])) · S_entry
        o_state = torch.einsum("bthk,bhkv->bthv", rr * torch.exp(d_prev), s)
        # intra-chunk: scores[t,s] = Σ_K r_t exp(d_prev[t]-dcum[s]) k_s, s<t
        diff = d_prev[:, :, None] - dcum[:, None]    # (B, C, C, H, K)
        if grad:
            # out of place: exp's backward reads its own output
            expdiff = diff.masked_fill(masked, float("-inf")).exp() \
                * rr[:, :, None]
        else:
            expdiff = diff.masked_fill_(masked, float("-inf")).exp_().mul_(
                rr[:, :, None])
        scores = torch.einsum("btshk,bshk->bths", expdiff, kk)
        o_intra = torch.einsum("bths,bshv->bthv", scores, vv)
        # current-token bonus u:  o += Σ_K (r_t ⊙ u ⊙ k_t) v_t
        o_bonus = (rr * u[None, None] * kk).sum(-1, keepdim=True) * vv
        outs.append(o_state + o_intra + o_bonus)
        # S_exit = diag(exp(dcum[-1])) S + Σ_t exp(dcum[-1]-dcum[t]) k v
        d_last = dcum[:, -1]                     # (B, H, K)
        k_dec = kk * torch.exp(d_last[:, None] - dcum)
        s = torch.exp(d_last)[..., None] * s \
            + torch.einsum("bthk,bthv->bhkv", k_dec, vv)
    return torch.cat(outs, dim=1), s


# --------------------------------------------------------------------------
# Griffin RG-LRU block (recurrentgemma)
# --------------------------------------------------------------------------

RGLRU_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, d: int, r: RecurrentSpec, device=None):
        super().__init__()
        ds = r.d_state or d
        self.w_in = master_param(d, ds, device=device)
        self.w_gate = master_param(d, ds, device=device)
        self.w_out = master_param(ds, d, device=device)
        self.conv_w = master_param(r.conv_width, ds, device=device)
        self.w_rg = master_param(ds, ds, device=device)
        self.w_ig = master_param(ds, ds, device=device)
        self.lam = master_param(ds, device=device)
        self.b_rg = master_param(ds, device=device)
        self.b_ig = master_param(ds, device=device)


def init_rglru(d: int, r: RecurrentSpec, generator=None,
               device=None) -> RGLRU:
    p = RGLRU(d, r, device)
    ds = p.w_in.shape[1]
    truncated_normal_(p.w_in.data, d ** -0.5, generator)
    truncated_normal_(p.w_gate.data, d ** -0.5, generator)
    truncated_normal_(p.w_out.data, ds ** -0.5, generator)
    truncated_normal_(p.conv_w.data, 0.1, generator)
    truncated_normal_(p.w_rg.data, ds ** -0.5, generator)
    truncated_normal_(p.w_ig.data, ds ** -0.5, generator)
    p.lam.data.uniform_(2.0, 6.0, generator=generator)
    p.b_rg.data.zero_()
    p.b_ig.data.zero_()
    return p


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, Ds) float32
    conv: torch.Tensor       # (B, W-1, Ds) trailing inputs


def rglru_init_state(batch: int, d_state: int, conv_width: int, dtype,
                     device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros(batch, d_state, dtype=torch.float32, device=device),
        conv=torch.zeros(batch, conv_width - 1, d_state, dtype=dtype,
                         device=device))


def _causal_conv(x, w, prev):
    """Depthwise causal conv along T: x (B,T,Ds), w (W,Ds), prev (B,W-1,Ds)."""
    width = w.shape[0]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    t = x.shape[1]
    for i in range(width):
        out = out + xp[:, i:i + t] * w[width - 1 - i].to(x.dtype)
    return out


def rglru_fwd(p: RGLRU, x, r: RecurrentSpec, state: Optional[RGLRUState],
              chunk: Optional[int] = None, cp=None):
    """Griffin recurrent block: x (B,T,D) -> (B,T,D), new state.

    ``cp`` = (mesh, cp_axis, batch_spec): run the scan sequence-parallel
    (:mod:`repro_torch.parallel.seqscan`) on this rank's block of T (at
    least ``conv_width - 1`` long); the conv reads the previous rank's
    last ``conv_width - 1`` inputs (rank 0: the state's), and the new
    state is the last rank's, on every rank."""
    dt = x.dtype
    ds = p.w_in.shape[1]
    bsz = x.shape[0]
    fresh = state is None
    if fresh:
        state = rglru_init_state(bsz, ds, r.conv_width, dt, x.device)
    gate = F.gelu(x @ p.w_gate.to(dt), approximate="tanh")
    xi = x @ p.w_in.to(dt)
    prev = state.conv
    if cp is not None:
        from repro_torch.parallel.seqscan import cp_halo
        prev = cp_halo(xi, cp[0], cp[1], r.conv_width - 1,
                       None if fresh else state.conv)
    xc = _causal_conv(xi, p.conv_w, prev)
    # RG-LRU gates (fp32 for the decay math)
    xf = xc.float()
    rg = torch.sigmoid(xf @ p.w_rg.float() + p.b_rg)
    ig = torch.sigmoid(xf @ p.w_ig.float() + p.b_ig)
    # F.softplus switches to the identity past 20; lam is drawn in [2, 6]
    log_a = -RGLRU_C * F.softplus(p.lam) * rg              # ≤ 0
    gated_x = ig * xf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    step = chunk or r.chunk or 256
    if cp is not None:
        from repro_torch.parallel.seqscan import cp_vector_recurrence
        mesh, cp_axis, batch_spec = cp
        h, h_last = cp_vector_recurrence(log_a, b, state.h, mesh=mesh,
                                         cp_axis=cp_axis,
                                         batch_spec=batch_spec, chunk=step)
    else:
        h, h_last = vector_recurrence(log_a, b, state.h, step)
    new_conv = torch.cat([prev.to(dt), xi], dim=1)[:, -(r.conv_width - 1):]
    if cp is not None:
        from repro_torch.parallel.seqscan import from_last_rank
        new_conv = from_last_rank(new_conv, cp[0], cp[1])
    y = (h.to(dt) * gate) @ p.w_out.to(dt)
    return y, RGLRUState(h=h_last, conv=new_conv)


# --------------------------------------------------------------------------
# RWKV-6 time-mix block (Finch)
# --------------------------------------------------------------------------

RWKV_LORA = 32


def _rwkv_heads(d: int, r: RecurrentSpec) -> int:
    return r.n_heads or d // 64


class RWKV6(nn.Module):
    def __init__(self, d: int, r: RecurrentSpec, device=None):
        super().__init__()
        n_heads = _rwkv_heads(d, r)
        dk = d // n_heads
        self.mu_base = master_param(d, device=device)
        self.mu_rkvwg = master_param(5, d, device=device)
        self.lora_a = master_param(d, 5 * RWKV_LORA, device=device)
        self.lora_b = master_param(5, RWKV_LORA, d, device=device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, master_param(d, d, device=device))
        self.decay_base = master_param(d, device=device)
        self.decay_a = master_param(d, RWKV_LORA * 2, device=device)
        self.decay_b = master_param(RWKV_LORA * 2, d, device=device)
        self.bonus_u = master_param(n_heads, dk, device=device)
        self.ln_scale = master_param(n_heads, dk, device=device)


def init_rwkv6(d: int, r: RecurrentSpec, generator=None,
               device=None) -> RWKV6:
    p = RWKV6(d, r, device)
    std = d ** -0.5
    p.mu_base.data.fill_(0.5)
    p.mu_rkvwg.data.fill_(0.5)
    truncated_normal_(p.lora_a.data, std, generator)
    truncated_normal_(p.lora_b.data, RWKV_LORA ** -0.5, generator)
    for w in (p.w_r, p.w_k, p.w_v, p.w_g, p.w_o):
        truncated_normal_(w.data, std, generator)
    p.decay_base.data.fill_(-1.5)
    truncated_normal_(p.decay_a.data, std, generator)
    truncated_normal_(p.decay_b.data, (RWKV_LORA * 2) ** -0.5, generator)
    truncated_normal_(p.bonus_u.data, 0.3, generator)
    p.ln_scale.data.fill_(1.0)
    return p


class RWKVState(NamedTuple):
    s: torch.Tensor          # (B, H, K, V) float32
    x_prev: torch.Tensor     # (B, D) last input (token shift)


def rwkv6_init_state(batch: int, d: int, n_heads: int, dtype,
                     device=None) -> RWKVState:
    dk = d // n_heads
    return RWKVState(
        s=torch.zeros(batch, n_heads, dk, dk, dtype=torch.float32,
                      device=device),
        x_prev=torch.zeros(batch, d, dtype=dtype, device=device))


def rwkv6_fwd(p: RWKV6, x, r: RecurrentSpec, state: Optional[RWKVState],
              chunk: Optional[int] = None, cp=None):
    """RWKV-6 time mix: x (B,T,D) -> (B,T,D), new state.

    ``cp`` = (mesh, cp_axis, batch_spec) runs the sequence-parallel scan
    on this rank's block of T; the token shift reads the previous rank's
    last input (rank 0: the state's), and the new state is the last
    rank's, on every rank."""
    dt = x.dtype
    bsz, t, d = x.shape
    n_heads = _rwkv_heads(d, r)
    dk = d // n_heads
    fresh = state is None
    if fresh:
        state = rwkv6_init_state(bsz, d, n_heads, dt, x.device)
    prev = state.x_prev
    if cp is not None:
        from repro_torch.parallel.seqscan import cp_halo
        prev = cp_halo(x, cp[0], cp[1], 1,
                       None if fresh else state.x_prev[:, None])[:, 0]

    xx = token_shift(x, prev)
    # data-dependent token-shift mixing (5-way LoRA)
    base = x + (xx - x) * p.mu_base.to(dt)
    z = torch.tanh(base @ p.lora_a.to(dt)).reshape(bsz, t, 5, RWKV_LORA)
    mix = p.mu_rkvwg.to(dt)[None, None] \
        + torch.einsum("btfl,fld->btfd", z, p.lora_b.to(dt))
    xr, xk, xv, xw, xg = [x + (xx - x) * mix[:, :, i] for i in range(5)]

    rr = (xr @ p.w_r.to(dt)).reshape(bsz, t, n_heads, dk)
    kk = (xk @ p.w_k.to(dt)).reshape(bsz, t, n_heads, dk)
    vv = (xv @ p.w_v.to(dt)).reshape(bsz, t, n_heads, dk)
    g = F.silu(xg @ p.w_g.to(dt))

    # data-dependent decay (fp32, log-space): log w = -exp(...)  ≤ 0
    dec = p.decay_base + torch.tanh(xw.float() @ p.decay_a.float()) \
        @ p.decay_b.float()
    log_w = -torch.exp(dec).reshape(bsz, t, n_heads, dk)

    args = (log_w, kk.float(), vv.float(), rr.float(), p.bonus_u, state.s)
    step = chunk or r.chunk or 64
    if cp is not None:
        from repro_torch.parallel.seqscan import cp_matrix_recurrence
        mesh, cp_axis, batch_spec = cp
        o, s_last = cp_matrix_recurrence(*args, mesh=mesh, cp_axis=cp_axis,
                                         batch_spec=batch_spec, chunk=step)
    else:
        o, s_last = matrix_recurrence(*args, step)

    # per-head RMS norm (GroupNorm analogue) + gate + out proj
    var = o.square().mean(-1, keepdim=True)
    o = o * torch.rsqrt(var + 1e-6) * p.ln_scale[None, None]
    y = (o.reshape(bsz, t, d).to(dt) * g) @ p.w_o.to(dt)
    x_last = x[:, -1].to(dt)
    if cp is not None:
        from repro_torch.parallel.seqscan import from_last_rank
        x_last = from_last_rank(x_last, cp[0], cp[1])
    return y, RWKVState(s=s_last, x_prev=x_last)
