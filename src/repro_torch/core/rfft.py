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
    half of the last axis.  Valid for every decomposition/shape — the
    fallback and numerical oracle.  Distributed, the c2c output is
    resharded so z is local before the slice (``_guarded_half_slice``;
    cell replicates over its z axis), and the c2r rebuilds the missing
    half by a ``Mesh.mirror`` of x and y, never a gather.

``strategy="auto"`` (default) picks packed wherever it is supported.
Both match ``numpy.fft.rfftn`` / ``irfftn`` with axes in (x, y, z) order.
Meshless calls run on ``device`` (the CUDA card unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import real as real_lib
from repro_torch.core import distributed
from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.core.schedule import layout_for
from repro_torch.real import packing, pipeline


def _z_shard_count(decomp: Decomposition, mesh, layout: str) -> int:
    """How many ways the (global) z axis is sharded in the given layout."""
    entry = decomp.spec(layout)[2]
    if entry is None:
        return 1
    sizes = dict(mesh.shape)
    if isinstance(entry, tuple):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def embed_spec(decomp: Decomposition) -> tuple:
    """The layout of the embed strategy's half spectrum: z local — the
    spectral spec for pencil and slab; for cell, whose spectral spec
    still shards z, x and y sharded and z replicated."""
    if decomp.kind == "cell":
        return (decomp.axes[0], decomp.axes[1], None)
    return decomp.spectral_spec()


def _embed_grid(blk: torch.Tensor, mesh, decomp: Decomposition) -> tuple:
    """The global (Nx, Ny, N) an :func:`embed_spec` block is a shard of
    (z is local)."""
    spec = embed_spec(decomp)
    return tuple(n if a is None else n * mesh.axis_size(a)
                 for a, n in zip(spec, blk.shape[-3:]))


def _guarded_half_slice(y: torch.Tensor, nz: int, mesh, decomp,
                        opts) -> torch.Tensor:
    """``y[..., : nz//2 + 1]`` that never cuts across a z shard.

    In the natural output layout z is sharded, and the odd-sized half
    spectrum cannot tile those shards: the block is resharded so z is
    local first (one all-to-all, no gather) and sliced there — which
    also honors ``Croft3D.output_sharding``'s contract that every r2c
    spectrum comes back in the z-local layout (:func:`embed_spec`).
    """
    nh = nz // 2 + 1
    if not real_lib.is_multidevice(mesh) or decomp is None:
        return y[..., :nh]
    if _z_shard_count(decomp, mesh, opts.output_layout) == 1:
        return y[..., :nh]
    nx, ny = (layout_for(decomp, opts.output_layout)
              .global_shape(y.shape, mesh.shape)[:2])
    full = mesh.reshard(y.contiguous(), (nx, ny, nz),
                        decomp.spec(opts.output_layout), embed_spec(decomp))
    return full[..., :nh]


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
    # resolved on the packed input layout (an explicit "embed" needs none)
    shape = (pipeline.global_grid(x, mesh, decomp) if multi
             else tuple(x.shape[-3:]))
    resolved = real_lib.resolve_strategy(strategy, shape, mesh, decomp, opts)
    if fold_filter and not (resolved == "packed" and multi
                            and kspace_filter is not None):
        raise ValueError("fold_filter=True needs a kspace_filter on the "
                         "distributed packed path (it folds the multiply "
                         "into the packed schedule)")
    if multi and resolved == "packed":
        return real_lib.packed_rfft3d(x, mesh, decomp, opts, norm=norm,
                                      kspace_filter=kspace_filter,
                                      fold_filter=fold_filter)
    x = x.to(distributed._local_device(mesh, device))
    if resolved == "packed":
        y = real_lib.local_rfft3d_packed(x, opts, norm=norm)
    else:
        # a distributed embed x is a block of the c2c natural layout
        nz = (layout_for(decomp, "natural").global_shape(x.shape, mesh.shape)
              if multi else x.shape)[-1]
        xc = x.to(packing.complex_dtype_for(x.dtype))
        y = distributed.fft3d(xc, mesh, decomp, opts, norm=norm,
                              device=x.device)
        y = _guarded_half_slice(y, nz, mesh, decomp, opts)
    if kspace_filter is not None:
        from repro_torch.grad import vjp
        y = vjp.spectral_scale(y, kspace_filter.to(y.device, y.dtype))
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
    nx, ny = (_embed_grid(y, mesh, decomp) if multi else y.shape[-3:])[:2]
    resolved = real_lib.resolve_strategy(strategy, (nx, ny, nz), mesh,
                                         decomp, opts)
    if multi and resolved == "packed":
        return real_lib.packed_irfft3d(y, nz, mesh, decomp, opts, norm=norm)
    y = y.to(distributed._local_device(mesh, device))
    if resolved == "packed":
        return real_lib.local_irfft3d_packed(y, nz, opts, norm=norm)
    body = y[..., 1:(nz + 1) // 2]            # kz' = 1 .. ceil(nz/2)-1
    tail = torch.conj(body)
    if multi:
        # x and y are sharded (z is local): the mirror moves each rank the
        # -kx, -ky blocks it needs
        spec = embed_spec(decomp)
        tail = mesh.mirror(tail.contiguous(),
                           (nx, ny, tail.shape[-1]), spec, (-3, -2))
    else:
        tail = packing.negate_freq(tail, -3)  # -kx mod Nx
        tail = packing.negate_freq(tail, -2)  # -ky mod Ny
    tail = torch.flip(tail, [-1])             # ascending kz = nz-kz' order
    full = torch.cat([y, tail], dim=-1)
    assert full.shape[-1] == nz, (full.shape, nz)
    if multi:
        # the c2c inverse starts from its schedule's input layout
        start = distributed.build_schedule(
            decomp, opts, +1).layout_in.partition_spec()
        if start != spec:
            full = mesh.reshard(full.contiguous(), (nx, ny, nz), spec, start)
    x = distributed.ifft3d(full, mesh, decomp, opts, norm=norm,
                           device=y.device)
    return x.real


def rfft3d_local(x: torch.Tensor, device=None) -> torch.Tensor:
    """Single-device r2c via the plan-based local transform (z-axis
    halved)."""
    return rfft3d(x, mesh=None, device=device)
