"""Shared layer primitives: norms, RoPE, dense FFNs (and the RWKV-6
channel mix), token shift, embeddings.

Port of ``repro/models/layers.py``.  The reference's parameter pytrees
become ``nn.Module``s whose parameters carry the reference's names and
shapes (fp32 masters); ``init_*`` builds one from a ``torch.Generator``
and ``*_fwd`` consumes activations in the compute dtype, casting each
weight to it as the reference does (a no-op once the weights were cast
at load, :func:`repro_torch.train.train_step.cast_to_compute`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import has_values


def master_param(*shape, device=None) -> nn.Parameter:
    """An fp32 master.  It does not require grad: the training step
    (``train.train_step.make_train_step``) differentiates with respect to
    compute-dtype leaves it makes from the masters, and updates the
    masters in place; serving never records a graph through them."""
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def takes_grad(*xs: torch.Tensor) -> bool:
    """Whether autograd records through any of ``xs``: grad mode is on and
    one of them requires grad.  The one rule wherever a forward-only path
    stands beside a differentiable one (the attention route, the per-layer
    and per-kv-block checkpoints, the RWKV scan's in-place ops)."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def truncated_normal_(t: torch.Tensor, std: float, generator=None):
    """``std`` times a standard normal truncated to [-2, 2], in place.  A
    tensor without values (:func:`has_values`) keeps its shape only, as
    the reference's initializers do under ``jax.eval_shape``: the draw
    rejects samples by reading them."""
    if not has_values(t):
        return t
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

class Norm(nn.Module):
    def __init__(self, kind: str, d: int, device=None):
        super().__init__()
        self.scale = master_param(d, device=device)
        if kind != "rmsnorm":
            self.bias = master_param(d, device=device)


def init_norm(kind: str, d: int, device=None) -> Norm:
    p = Norm(kind, d, device)
    p.scale.data.fill_(1.0)
    if kind != "rmsnorm":
        p.bias.data.zero_()
    return p


def norm_fwd(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
             eps: float = 1e-6) -> torch.Tensor:
    """Computed in float32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p.scale
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, n, head_dim); cos/sin (..., S, head_dim//2) broadcast
    over n."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# dense FFNs
# --------------------------------------------------------------------------

class FFN(nn.Module):
    def __init__(self, d: int, d_ff: int, kind: str, device=None):
        super().__init__()
        if kind in ("swiglu", "geglu"):
            self.w_gate = master_param(d, d_ff, device=device)
            self.w_up = master_param(d, d_ff, device=device)
            self.w_down = master_param(d_ff, d, device=device)
        elif kind == "gelu":
            self.w_up = master_param(d, d_ff, device=device)
            self.b_up = master_param(d_ff, device=device)
            self.w_down = master_param(d_ff, d, device=device)
            self.b_down = master_param(d, device=device)
        elif kind == "rwkv_cm":
            # RWKV-6 channel mix: token-shift mix + squared-relu gate
            self.mu_k = master_param(d, device=device)
            self.mu_r = master_param(d, device=device)
            self.w_k = master_param(d, d_ff, device=device)
            self.w_v = master_param(d_ff, d, device=device)
            self.w_r = master_param(d, d, device=device)
        else:
            raise ValueError(kind)


def init_ffn(d: int, d_ff: int, kind: str, generator=None,
             device=None) -> FFN:
    p = FFN(d, d_ff, kind, device)
    std_in, std_out = d ** -0.5, d_ff ** -0.5
    if kind == "gelu":
        truncated_normal_(p.w_up.data, std_in, generator)
        p.b_up.data.zero_()
        truncated_normal_(p.w_down.data, std_out, generator)
        p.b_down.data.zero_()
    elif kind == "rwkv_cm":
        p.mu_k.data.fill_(0.5)
        p.mu_r.data.fill_(0.5)
        truncated_normal_(p.w_k.data, std_in, generator)
        truncated_normal_(p.w_v.data, std_out, generator)
        truncated_normal_(p.w_r.data, std_in, generator)
    else:
        truncated_normal_(p.w_gate.data, std_in, generator)
        truncated_normal_(p.w_up.data, std_in, generator)
        truncated_normal_(p.w_down.data, std_out, generator)
    return p


def ffn_fwd(p: FFN, x: torch.Tensor, kind: str,
            x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D).  ``jax.nn.gelu`` defaults to the tanh approximation,
    so gelu and geglu take it here too.  ``x_prev`` is the token-shift
    input of rwkv_cm: x shifted right by one along S (:func:`token_shift`)."""
    dt = x.dtype
    if kind in ("swiglu", "geglu"):
        g = x @ p.w_gate.to(dt)
        g = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        u = x @ p.w_up.to(dt)
        return (g * u) @ p.w_down.to(dt)
    if kind == "gelu":
        h = F.gelu(x @ p.w_up.to(dt) + p.b_up.to(dt), approximate="tanh")
        return h @ p.w_down.to(dt) + p.b_down.to(dt)
    if kind == "rwkv_cm":
        if x_prev is None:
            raise ValueError("rwkv_cm needs x_prev")
        mk, mr = p.mu_k.to(dt), p.mu_r.to(dt)
        xk = x * mk + x_prev * (1 - mk)
        xr = x * mr + x_prev * (1 - mr)
        k = torch.relu(xk @ p.w_k.to(dt)).square()
        r = torch.sigmoid(xr @ p.w_r.to(dt))
        return r * (k @ p.w_v.to(dt))
    raise ValueError(kind)


def token_shift(x: torch.Tensor,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D) shifted one step right along S; position 0 filled from
    ``prev`` (B, D) (the decode cache) or zeros."""
    shifted = torch.empty_like(x)
    shifted[:, 1:] = x[:, :-1]
    if prev is None:
        shifted[:, 0] = 0
    else:
        shifted[:, 0] = prev.to(x.dtype)
    return shifted


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, tie: bool, device=None):
        super().__init__()
        self.tok = master_param(vocab, d, device=device)
        self.head = None if tie else master_param(d, vocab, device=device)


def init_embedding(vocab: int, d: int, tie: bool, generator=None,
                   device=None) -> Embedding:
    p = Embedding(vocab, d, tie, device)
    # 1/sqrt(d): with sqrt(d) embedding scaling (gemma) activations are
    # unit-ish, and tied logits stay O(1) after the final norm
    truncated_normal_(p.tok.data, d ** -0.5, generator)
    if not tie:
        truncated_normal_(p.head.data, d ** -0.5, generator)
    return p


def embed_fwd(p: Embedding, tokens: torch.Tensor, dtype,
              scale_by_dim: bool) -> torch.Tensor:
    # gather, then cast: the reference's cast-then-gather, elementwise
    x = p.tok[tokens].to(dtype)
    if scale_by_dim:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=dtype)
    return x


def logits_fwd(p: Embedding, x: torch.Tensor,
               softcap: float = 0.0) -> torch.Tensor:
    w: Optional[torch.Tensor] = p.head
    if w is None:
        w = p.tok.T
    logits = x @ w.to(x.dtype)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
