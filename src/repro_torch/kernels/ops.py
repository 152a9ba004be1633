"""Complex-in/complex-out entry points over the kernels.

Port of ``repro/kernels/ops.py`` (``fft_matmul_1d``; ``spectral_scale_op``
comes with its kernel).  The reference splits complex64 into float32
planes here and merges them back, two extra passes; the Hopper kernel
reads and writes complex64 as it is, so this layer only flattens the
batch dimensions.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fft_matmul


def fft_matmul_1d(x: torch.Tensor, sign: int = -1,
                  device=None) -> torch.Tensor:
    """Batched 1-D FFT along the last axis of a complex64 tensor (any
    rank), on ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``)."""
    x = x.to(resolve_device(device))
    shape = x.shape
    rows = x.reshape(-1, shape[-1]).contiguous()
    return fft_matmul.fft4step(rows, sign).reshape(shape)
