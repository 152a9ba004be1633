"""Complex-in/complex-out entry points over the kernels.

Port of ``repro/kernels/ops.py``.  The reference splits complex64 into
float32 planes here and merges them back, two extra passes; the Hopper
kernels read and write complex64 as it is, so this layer only moves the
tensor to its device (and, for the broadcast scale, flattens the batch
dimensions).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fft_matmul, spectral_scale


def fft_matmul_1d(x: torch.Tensor, sign: int = -1,
                  device=None) -> torch.Tensor:
    """Batched 1-D FFT along the last axis of a complex64 tensor (any
    rank), on ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``)."""
    return fft_matmul.fft4step_axis(x.to(resolve_device(device)), -1, sign)


def spectral_scale_op(x: torch.Tensor, h: torch.Tensor, alpha: float = 1.0,
                      device=None) -> torch.Tensor:
    """alpha * x * h with h of shape (N,) broadcast against complex64 x
    (..., N) (the broadcast kernel; x is scaled by alpha first), on
    ``device`` (the CUDA card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    x, h = x.to(dev, torch.complex64), h.to(dev, torch.complex64)
    shape = x.shape
    rows = x.reshape(-1, shape[-1]).contiguous()
    return spectral_scale.spectral_scale_planes(rows, h.contiguous(),
                                                alpha).reshape(shape)
