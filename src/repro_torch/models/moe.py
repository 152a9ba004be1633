"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Port of ``repro/models/moe.py``.  Covers Mixtral (8e top-2) and
DeepSeek-V2 (2 shared + 160 routed top-6).  Dispatch is the sort/scatter
formulation (no O(T·E·C) dense dispatch tensors): flatten (token, choice)
pairs, order them by expert (a stable sort, as ``jnp.argsort``), rank
them within their expert, drop those beyond capacity, gather the rest
into an (E, C, D) buffer, run the experts as batched GEMMs, and weight
and sum the results back per token.

The reference's sharding hint (``expert_axis``) has no counterpart: this
module is meshless, and ``models/moe_sharded.py`` runs the dispatch over
a mesh.  Two choices of the port, each keeping the reference's result:

* dropped pairs are written to one trash row past the E·C live rows
  (the reference's ``mode="drop"`` index), never clamped into a live slot;
* the combine does not scatter-add (``index_add_`` on the card is atomic
  and unordered, and bf16 atomics round badly): each pair's weighted
  output goes back to its (token, choice) row, and the k choices are
  summed in float32, in choice order, then cast to the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import MoESpec
from repro_torch.models.layers import (FFN, ffn_fwd, init_ffn,
                                       master_param, truncated_normal_)


class MoE(nn.Module):
    """``router`` (D, E), ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D) and, with shared experts, ``shared`` (a swiglu FFN of width
    ``n_shared · F``)."""

    def __init__(self, d: int, m: MoESpec, device=None):
        super().__init__()
        e, f = m.n_experts, m.d_ff_expert
        self.router = master_param(d, e, device=device)
        self.w_gate = master_param(e, d, f, device=device)
        self.w_up = master_param(e, d, f, device=device)
        self.w_down = master_param(e, f, d, device=device)
        if m.n_shared:
            self.shared = FFN(d, m.n_shared * m.d_ff_expert, "swiglu",
                              device)


def init_moe(d: int, m: MoESpec, generator=None, device=None) -> MoE:
    p = MoE(d, m, device)
    std_in, std_out = d ** -0.5, m.d_ff_expert ** -0.5
    truncated_normal_(p.router.data, std_in, generator)
    truncated_normal_(p.w_gate.data, std_in, generator)
    truncated_normal_(p.w_up.data, std_in, generator)
    truncated_normal_(p.w_down.data, std_out, generator)
    if m.n_shared:
        p.shared = init_ffn(d, m.n_shared * m.d_ff_expert, "swiglu",
                            generator, device)
    return p


def _capacity(n_tokens: int, m: MoESpec) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for clean tiling


def _expert_counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """How many (token, choice) pairs each of the ``e`` experts got: an
    (e,) count of a static shape (``bincount``'s length depends on the
    values, which the dry run's fake tensors do not have)."""
    return flat_e.new_zeros(e).index_add_(0, flat_e,
                                          torch.ones_like(flat_e))


def _dispatch(xt: torch.Tensor, router: torch.Tensor, m: MoESpec, cap: int):
    """Tokens (T, D) -> the (E, C, D) buffer and the combine's metadata
    (keep, slot, token_of, gate_vals, order)."""
    t, d = xt.shape
    e, k = m.n_experts, m.top_k
    # routing in float32 (the reference's router_dtype) for a stable softmax
    probs = torch.softmax(xt.float() @ router.float(), -1)
    gate_vals, topk_idx = torch.topk(probs, k, dim=-1)          # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # order (token, choice) pairs by expert; rank each within its expert
    flat_e = topk_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _expert_counts(flat_e, e)
    starts = counts.cumsum(0) - counts
    pos_in_e = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = sorted_e * cap + pos_in_e.clamp(0, cap - 1)
    token_of = order // k
    buf = xt.new_zeros(e * cap + 1, d)      # row e*cap: the dropped pairs
    buf[torch.where(keep, slot, e * cap)] = xt[token_of]
    return (buf[:e * cap].view(e, cap, d),
            (keep, slot, token_of, gate_vals, order))


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Batched SwiGLU over the experts: (E, C, D) -> (E, C, D)."""
    dt = buf.dtype
    g = F.silu(torch.bmm(buf, w_gate.to(dt)))
    u = torch.bmm(buf, w_up.to(dt))
    return torch.bmm(g * u, w_down.to(dt))


def _combine(y: torch.Tensor, meta, t: int, d: int, dtype) -> torch.Tensor:
    """Gather each kept pair's expert output, weight it by its gate, and
    sum each token's k choices (float32, choice order): (T, D)."""
    keep, slot, _, gate_vals, order = meta
    k = gate_vals.shape[-1]
    y = y.reshape(-1, d)
    w = gate_vals.reshape(-1)[order].to(dtype)
    pairs = torch.where(keep[:, None], y[slot], 0.0) * w[:, None]
    out = torch.empty_like(pairs)
    out[order] = pairs                      # back to (token, choice) rows
    return out.view(t, k, d).float().sum(1).to(dtype)


def moe_fwd(p: MoE, x: torch.Tensor, m: MoESpec) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    buf, meta = _dispatch(xt, p.router, m, _capacity(t, m))
    y = _experts(buf, p.w_gate, p.w_up, p.w_down)
    out = _combine(y, meta, t, d, x.dtype)
    if m.n_shared:
        out = out + ffn_fwd(p.shared, xt, "swiglu")
    return out.reshape(b, s, d)


def aux_load_balance_loss(p: MoE, x: torch.Tensor, m: MoESpec, mesh=None,
                          axes=()):
    """Switch-style load-balance auxiliary loss (fraction * probability).

    On a ``mesh``, x is this rank's block of tokens and ``axes`` the axes
    whose ranks hold the other blocks: the hits and the probability sums
    are all-reduced over them (one counted all-reduce), so the value is
    the whole pass's; its gradient is this rank's share (through its own
    tokens' probabilities), and the shares sum to the whole's."""
    xt = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xt @ p.router.float(), -1)
    _, topk_idx = torch.topk(probs, m.top_k, dim=-1)
    hits = _expert_counts(topk_idx.reshape(-1), m.n_experts).float()
    psum = probs.sum(0)
    n_tok = torch.tensor([float(xt.shape[0])], device=x.device)
    if mesh is not None and axes:
        from repro_torch.core.mesh import axis_arg
        tot = mesh.all_reduce(torch.cat([hits, psum.detach(), n_tok]),
                              axis_arg(axes)).wait()
        e = m.n_experts
        hits, n_tok = tot[:e], tot[-1:]
        frac_tokens = hits / hits.sum()
        local = m.n_experts * (frac_tokens * psum / n_tok).sum()
        whole = m.n_experts * (frac_tokens * tot[e:2 * e] / n_tok).sum()
        return local + (whole - local).detach()
    frac_tokens = hits / hits.sum()
    frac_prob = probs.mean(0)
    return m.n_experts * (frac_tokens * frac_prob).sum()
