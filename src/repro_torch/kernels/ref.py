"""Plain oracles for the kernels of this package.

Port of ``repro/kernels/ref.py`` (the FFT and spectral-scale oracles;
the attention oracle comes with its kernel).  ``torch.fft`` serves here as
an oracle only: no path of the port calls it in place of a kernel.
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
