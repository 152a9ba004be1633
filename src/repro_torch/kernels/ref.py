"""Plain oracles for the kernels of this package.

Port of ``repro/kernels/ref.py``.  ``torch.fft`` serves here as an oracle
only: no path of the port calls it in place of a kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def ref_fft_1d(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Batched 1-D DFT along the last axis (complex in, complex out)."""
    if sign == -1:
        return torch.fft.fft(x)
    return torch.fft.fft(x.conj()).conj().resolve_conj()


def ref_fft_1d_naive(x: np.ndarray, sign: int = -1) -> np.ndarray:
    """O(N^2) direct DFT — the independent oracle (never touches any FFT)."""
    n = x.shape[-1]
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    return np.einsum("...n,nk->...k", x, w)


def ref_spectral_scale(x: torch.Tensor, h: torch.Tensor,
                       alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * x * h with h broadcast over leading batch dims."""
    return (alpha * x) * h


def ref_flash_attention(q, k, v, causal=True, window=None, scale=None):
    """Oracle for the flash-attention kernel (GQA, causal/windowed): the
    whole (B, H, Sq, Skv) float32 score tensor and one softmax."""
    b, sq, h, d = q.shape
    _, sk, kvh, dv = v.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    k_rep = torch.repeat_interleave(k, g, dim=2)
    v_rep = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k_rep.float())
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (qi - ki < window)
    s = torch.where(mask, s, -2.0 ** 30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_rep.float()).to(q.dtype)
