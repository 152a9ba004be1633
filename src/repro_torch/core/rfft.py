"""Real-to-complex / complex-to-real 3-D transforms.

Port of ``repro/core/rfft.py``.  Two strategies, dispatched here and
implemented in ``repro_torch.real``:

``strategy="packed"``   the native path: two real z-pencils share one
    complex transform (two-for-one), the spectrum travels as exactly
    Nz/2 shard-aligned complex bins (Nyquist folded into DC), and every
    stage computes/moves half of what the c2c pipeline would.  The
    distributed input is this rank's block of the *spectral* layout
    (``Decomposition.spectral_spec()``: z-pencils / z-slabs).

``strategy="embed"``    cast to complex, run c2c, keep the non-redundant
    half of the last axis.  Meshless only so far: its distributed c2r
    needs ``negate_freq`` across sharded x and y for the whole volume
    (ROADMAP.md, queue 1, "distributed embed"), so a distributed call
    that resolves to it raises ``NotImplementedError``.

``strategy="auto"`` (default) picks packed wherever it is supported.
Both match ``numpy.fft.rfftn`` / ``irfftn`` with axes in (x, y, z) order.
Meshless calls run on ``device`` (the CUDA card unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import real as real_lib
from repro_torch.core import distributed
from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.real import packing, pipeline

EMBED_NOT_PORTED = ("distributed r2c/c2r by embedding is not ported yet "
                    "(ROADMAP.md, queue 1, 'distributed embed': its c2r needs "
                    "negate_freq across sharded x and y); use "
                    "strategy='packed' on a pencil or slab decomposition")


def rfft3d(x: torch.Tensor, mesh=None,
           decomp: Optional[Decomposition] = None,
           opts: Optional[FFTOptions] = None, strategy: str = "auto",
           norm: Optional[str] = None,
           kspace_filter: Optional[torch.Tensor] = None,
           fold_filter: bool = False, device=None) -> torch.Tensor:
    """Real input (Nx, Ny, Nz) -> complex (Nx, Ny, Nz//2 + 1).

    Matches ``torch.fft.rfftn`` with axes in (x, y, z) order (z halved).
    ``kspace_filter`` (shaped like the half spectrum; with a mesh, this
    rank's block of it) fuses a k-space multiply into the transform,
    right after the DC/Nyquist unfold.  ``fold_filter`` (packed
    distributed path only) moves the multiply *before* the unfold, onto
    the packed half spectrum inside the schedule — valid for filters with
    ``h(kz=0) == h(kz=Nyquist)``, that plane real and 2-D-even.
    """
    if opts is None:
        opts = FFTOptions()
    if x.is_complex():
        raise ValueError("rfft3d expects a real array")
    multi = real_lib.is_multidevice(mesh)
    # a distributed x is this rank's block of the packed input layout
    shape = (pipeline.global_grid(x, mesh, decomp) if multi
             else tuple(x.shape[-3:]))
    resolved = real_lib.resolve_strategy(strategy, shape, mesh, decomp, opts)
    if fold_filter and not (resolved == "packed" and multi
                            and kspace_filter is not None):
        raise ValueError("fold_filter=True needs a kspace_filter on the "
                         "distributed packed path (it folds the multiply "
                         "into the packed schedule)")
    if multi:
        if resolved != "packed":
            raise NotImplementedError(EMBED_NOT_PORTED)
        return real_lib.packed_rfft3d(x, mesh, decomp, opts, norm=norm,
                                      kspace_filter=kspace_filter,
                                      fold_filter=fold_filter)
    x = x.to(distributed._local_device(mesh, device))
    if resolved == "packed":
        y = real_lib.local_rfft3d_packed(x, opts, norm=norm)
    else:
        nz = x.shape[-1]
        xc = x.to(packing.complex_dtype_for(x.dtype))
        y = distributed.fft3d(xc, None, None, opts, norm=norm,
                              device=x.device)[..., :nz // 2 + 1]
    if kspace_filter is not None:
        from repro_torch.kernels import spectral_scale as ss
        y = ss.spectral_scale(y, kspace_filter.to(y.device, y.dtype))
    return y


def irfft3d(y: torch.Tensor, nz: int, mesh=None,
            decomp: Optional[Decomposition] = None,
            opts: Optional[FFTOptions] = None, strategy: str = "auto",
            norm: Optional[str] = None, device=None) -> torch.Tensor:
    """Inverse of :func:`rfft3d`; reconstructs the Hermitian half.

    F[kx, ky, kz] = conj(F[-kx mod Nx, -ky mod Ny, nz - kz]) for the
    missing bins kz in [nz//2 + 1, nz - 1].  ``norm``: None/"backward"
    (1/N) | "ortho" (1/sqrt(N)), matching :func:`rfft3d`.
    """
    if opts is None:
        opts = FFTOptions()
    multi = real_lib.is_multidevice(mesh)
    nx, ny = (pipeline.global_grid(y, mesh, decomp) if multi
              else y.shape[-3:])[:2]
    resolved = real_lib.resolve_strategy(strategy, (nx, ny, nz), mesh,
                                         decomp, opts)
    if multi:
        if resolved != "packed":
            raise NotImplementedError(EMBED_NOT_PORTED)
        return real_lib.packed_irfft3d(y, nz, mesh, decomp, opts, norm=norm)
    y = y.to(distributed._local_device(mesh, device))
    if resolved == "packed":
        return real_lib.local_irfft3d_packed(y, nz, opts, norm=norm)
    body = y[..., 1:(nz + 1) // 2]            # kz' = 1 .. ceil(nz/2)-1
    tail = torch.conj(body)
    tail = packing.negate_freq(tail, -3)      # -kx mod Nx
    tail = packing.negate_freq(tail, -2)      # -ky mod Ny
    tail = torch.flip(tail, [-1])             # ascending kz = nz-kz' order
    full = torch.cat([y, tail], dim=-1)
    assert full.shape[-1] == nz, (full.shape, nz)
    x = distributed.ifft3d(full, None, None, opts, norm=norm, device=y.device)
    return x.real


def rfft3d_local(x: torch.Tensor, device=None) -> torch.Tensor:
    """Single-device r2c via the plan-based local transform (z-axis
    halved)."""
    return rfft3d(x, mesh=None, device=device)
