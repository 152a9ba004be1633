"""Distributed packed r2c/c2r pipelines (pencil and slab decompositions).

Port of ``repro/real/pipeline.py``.  The pipelines are *built*: the
functions below return :class:`repro_torch.core.schedule.Schedule`
objects using the packed stage ops (``PackTwo``/``UnpackTwo``/
``RepackHalves``/``SplitPairs``), and the entry points run them with the
same executor as the complex transform.  Layouts:

  real input    the decomposition's *spectral* layout (z fully local so
                the r2c stage runs first): pencil z-pencils
                (Nx/Py, Ny/Pz, Nz), slab z-slabs (Nx/P, Ny, Nz).
  packed        the shard-aligned half spectrum: (Nx, Ny, Nz/2) complex
  spectrum      in the decomposition's *natural* layout.  Bin 0 of the
                z axis carries the (real) DC and Nyquist planes folded
                into one complex plane (packing.py).
  r2c output    (Nx, Ny, Nz//2 + 1), ``numpy.fft.rfftn``-compatible, in
                the z-local spectral layout — the packed body is
                resharded once (``Mesh.reshard``, one all-to-all of the
                half volume, the schedule's ``ExtraComm``), then one
                (Nx, Ny)-plane Hermitian reconstruction
                (``unfold_dc_plane``) splits the folded DC/Nyquist plane.

The entry points run through the autograd plans of
``repro_torch/grad/vjp.py`` (``packed_rfft_plan``,
``packed_rfft_folded_plan``, ``packed_irfft_plan``), as the reference
runs its custom-VJP plans; without grad each runs its primal body:

  forward   body -> reshard to the spectral layout -> unfold -> scale
            -> optional filter
  folded    the ``with_epilogue(SpectralScale())`` body, its filter
            resharded to the body's output layout -> reshard -> unfold
            -> scale
  inverse   fold -> reshard to the natural layout -> inverse body ->
            scale

In the spectral layout x and y are sharded, so the plane reconstruction
reads g[-kx, -ky] from other ranks: the sharded forms gather the one
(Nx, Ny) plane per field (``Mesh.gather``) and keep this rank's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.decomposition import Decomposition, mesh_axis_sizes
from repro_torch.core.distributed import FFTOptions
from repro_torch.core.schedule import (ExtraComm, PackTwo, RepackHalves,
                                       Schedule, SplitPairs, Stage, UnpackTwo,
                                       layout_for, norm_factor)
from repro_torch.obs.tracer import span
from repro_torch.real import packing

#: grid dim two real lines are paired along, per decomposition kind
PAIR_AXIS = {"pencil": 1, "slab": 0}


def packed_unsupported_reason(shape: Sequence[int], decomp: Decomposition,
                              mesh_or_sizes, opts: FFTOptions) -> Optional[str]:
    """None if the distributed packed pipeline supports the problem, else
    a human-readable reason (``strategy="auto"`` falls back to the
    embedding on it).  Pure arithmetic over axis sizes."""
    nx, ny, nz = shape[-3], shape[-2], shape[-1]
    if decomp is None:
        return "packed distributed path needs a Decomposition"
    if decomp.kind not in PAIR_AXIS:
        return (f"packed pipeline supports pencil and slab decompositions, "
                f"not {decomp.kind}")
    if nz % 2:
        return f"packed two-for-one needs even Nz, got {nz}"
    try:
        sizes = mesh_axis_sizes(mesh_or_sizes)
        axis_sizes = decomp.axis_sizes(sizes)
    except (KeyError, TypeError) as e:
        return f"decomposition axes unresolvable on this mesh: {e}"
    if opts is not None and opts.transpose_impl in ("pairwise", "ring") and any(
            isinstance(a, tuple) for a in decomp.axes):
        return f"{opts.transpose_impl} transpose supports single mesh axes only"
    if decomp.kind == "slab":
        (p,) = axis_sizes
        if nx % p:
            return f"Nx={nx} not divisible by P={p} (z-slab input)"
        if (nx // p) % 2:
            return (f"local Nx={nx}//{p} is odd — cannot pair two x-lines "
                    "per complex transform")
        if (nz // 2) % p:
            return f"half spectrum Nz/2={nz // 2} not divisible by P={p}"
        return None
    py, pz = axis_sizes
    if nx % py:
        return f"Nx={nx} not divisible by Py={py} (z-pencil input)"
    if ny % pz:
        return f"Ny={ny} not divisible by Pz={pz} (z-pencil input)"
    if (ny // pz) % 2:
        return (f"local Ny={ny}//{pz} is odd — cannot pair two z-pencils "
                "per complex transform")
    if (nz // 2) % pz:
        return f"half spectrum Nz/2={nz // 2} not divisible by Pz={pz}"
    if ny % py:
        return f"Ny={ny} not divisible by Py={py} (y<->x transpose)"
    return None


# ---------------------------------------------------------------------------
# schedule builders.  Local axis order is (x, y, z); pairs ride on
# PAIR_AXIS[kind].  Input is the real spectral layout, body output the
# packed natural layout; the z-localizing reshard is recorded as an
# ExtraComm (one all-to-all of the half volume).
# ---------------------------------------------------------------------------

def build_packed_forward(decomp: Decomposition) -> Schedule:
    """Real spectral-layout block -> packed natural-layout half spectrum."""
    pair = PAIR_AXIS[decomp.kind]
    layout_in = layout_for(decomp, "spectral", real=True)
    if decomp.kind == "pencil":
        ax_y, ax_z = decomp.axes
        stages = (
            Stage("pack+z-rfft+zy", fft_axis=2, impl_stage=0, comm_axis=ax_z,
                  split_axis=2, concat_axis=1, chunk_axis=0,
                  prologue=(PackTwo(pair),),
                  epilogue=(UnpackTwo(pair, impl_stage=0),)),
            Stage("y-fft+yx", fft_axis=1, impl_stage=1, comm_axis=ax_y,
                  split_axis=1, concat_axis=0, chunk_axis=2),
            Stage("x-fft", fft_axis=0, impl_stage=2),
        )
    else:  # slab: pair two x-lines, one z<->x transpose of the half volume
        (ax_z,) = decomp.axes
        stages = (
            Stage("pack+z-rfft+zx", fft_axis=2, impl_stage=0, comm_axis=ax_z,
                  split_axis=2, concat_axis=0, chunk_axis=1,
                  prologue=(PackTwo(pair),),
                  epilogue=(UnpackTwo(pair, impl_stage=0),)),
            Stage("y-fft", fft_axis=1, impl_stage=1),
            Stage("x-fft", fft_axis=0, impl_stage=2),
        )
    sched = Schedule(f"{decomp.kind}/r2c/packed", -1, layout_in, stages)
    # the epilogue reshard moves the packed (half-volume) body output once
    return dataclasses.replace(
        sched, extra_comms=(ExtraComm("z-localize", sched.layout_out),))


def build_packed_inverse(decomp: Decomposition, nz: int) -> Schedule:
    """Packed natural-layout half spectrum -> real spectral-layout block."""
    pair = PAIR_AXIS[decomp.kind]
    layout_in = layout_for(decomp, "natural").with_den(2, mul=2)
    if decomp.kind == "pencil":
        ax_y, ax_z = decomp.axes
        stages = (
            Stage("x-ifft+xy", fft_axis=0, impl_stage=0, comm_axis=ax_y,
                  split_axis=0, concat_axis=1, chunk_axis=2),
            Stage("y-ifft+yz", fft_axis=1, impl_stage=1, comm_axis=ax_z,
                  split_axis=1, concat_axis=2, chunk_axis=0),
            Stage("repack+z-ifft+split", fft_axis=2, impl_stage=2,
                  prologue=(RepackHalves(pair, nz, impl_stage=2),),
                  epilogue=(SplitPairs(pair),)),
        )
    else:
        (ax_z,) = decomp.axes
        stages = (
            Stage("x-ifft+xz", fft_axis=0, impl_stage=0, comm_axis=ax_z,
                  split_axis=0, concat_axis=2, chunk_axis=1),
            Stage("y-ifft", fft_axis=1, impl_stage=1),
            Stage("repack+z-ifft+split", fft_axis=2, impl_stage=2,
                  prologue=(RepackHalves(pair, nz, impl_stage=2),),
                  epilogue=(SplitPairs(pair),)),
        )
    return Schedule(f"{decomp.kind}/c2r/packed", +1, layout_in, stages,
                    extra_comms=(ExtraComm("x-localize", layout_in),))


# ---------------------------------------------------------------------------
# DC/Nyquist plane fold/unfold — the only steps touching the odd
# (Nz//2 + 1)-sized axis, done once per transform on a single plane.
# ``gather`` is None on one device (the plane is all here); on a mesh it
# maps this rank's (..., nx, ny) piece of a plane to the whole plane, and
# ``sl`` is this rank's (x, y) slice of it.
# ---------------------------------------------------------------------------

def reversed_plane(p: torch.Tensor, gather=None, sl=None) -> torch.Tensor:
    """conj(P[-kx, -ky]) over this rank's (x, y) range."""
    full = p if gather is None else gather(p)
    rev = torch.conj(packing.negate_freq(packing.negate_freq(full, -1), -2))
    return rev if sl is None else rev[(Ellipsis,) + tuple(sl)]


def unfold_dc_plane(packed: torch.Tensor, gather=None,
                    sl=None) -> torch.Tensor:
    """Packed (..., Nx, Ny, Nz2) spectrum -> rfftn-style (..., Nx, Ny,
    Nz2 + 1).

    Bin 0 holds G = F2(DC_z) + i*F2(Nyq_z) with DC_z/Nyq_z real planes;
    the 2-D Hermitian split recovers both.  Expressed over the trailing
    axes only, so a batched spectrum unfolds all its planes in one pass.
    """
    with span("real:unfold_dc_plane", "unpack", packed.device):
        g = packed[..., 0]
        rev = reversed_plane(g, gather, sl)
        dc = 0.5 * (g + rev)
        nyq = -0.5j * (g - rev)
        return torch.cat([dc[..., None], packed[..., 1:], nyq[..., None]],
                         dim=-1)


def _hermitian_plane(p: torch.Tensor, gather=None, sl=None) -> torch.Tensor:
    """Project an (..., Nx, Ny) plane onto its 2-D-Hermitian part — what
    ``numpy.fft.irfftn`` implicitly does to the kz=0 and kz=Nyquist
    planes of a non-Hermitian half spectrum (the identity for spectra of
    a real field)."""
    return 0.5 * (p + reversed_plane(p, gather, sl))


def fold_dc_plane(y: torch.Tensor, nz: int, gather=None,
                  sl=None) -> torch.Tensor:
    """Inverse of :func:`unfold_dc_plane`, with the DC/Nyquist planes first
    projected onto their Hermitian parts so that arbitrary half spectra
    invert exactly like ``numpy.fft.irfftn``."""
    with span("real:fold_dc_plane", "pack", y.device):
        nz2 = nz // 2
        if gather is None:
            dc = _hermitian_plane(y[..., 0])
            nyq = _hermitian_plane(y[..., nz2])
        else:
            # both planes in one gather: (..., 2, nx, ny)
            both = _hermitian_plane(torch.stack([y[..., 0], y[..., nz2]], -3),
                                    gather, sl)
            dc, nyq = both.unbind(-3)
        g = dc + 1j * nyq
        return torch.cat([g[..., None], y[..., 1:nz2]], dim=-1)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def real_input_spec(decomp: Decomposition) -> tuple:
    """Spec of the packed pipeline's real input (the z-local spectral
    layout, pencil and slab alike)."""
    return decomp.spectral_spec()


def plane_access(mesh, decomp: Decomposition, shape: Sequence[int]):
    """(gather, slice) for the DC/Nyquist planes of a spectral-layout
    block of the (Nx, Ny, ...) grid: the (x, y) spec of the spectral
    layout and this rank's range of it."""
    spec = decomp.spectral_spec()[:2]
    plane = tuple(shape[-3:-1])
    sl = decomp.slices(shape, mesh, mesh.coords, "spectral")[:2]
    return (lambda p: mesh.gather(p.contiguous(), plane, spec)), sl


def global_grid(blk: torch.Tensor, mesh, decomp: Decomposition) -> tuple:
    """The global (Nx, Ny, N) a spectral-layout block is a shard of (the
    real input's and the half spectrum's layout alike)."""
    return layout_for(decomp, "spectral").global_shape(blk.shape, mesh.shape)


def packed_rfft3d(x: torch.Tensor, mesh, decomp: Decomposition,
                  opts: Optional[FFTOptions] = None,
                  norm: Optional[str] = None,
                  kspace_filter: Optional[torch.Tensor] = None,
                  fold_filter: bool = False) -> torch.Tensor:
    """Distributed packed r2c: this rank's block of the real (Nx, Ny, Nz)
    field, in the spectral layout, -> its block of the (Nx, Ny, Nz//2 + 1)
    spectrum in the same layout.  Every rank calls it collectively.

    ``kspace_filter`` (this rank's block of a filter shaped like the half
    spectrum) is applied right after the plane unfold; with
    ``fold_filter`` it is applied *before* the unfold, on the packed half
    spectrum inside the schedule — valid for filters with ``h(kz=0) ==
    h(kz=Nyquist)``, that plane real and 2-D-even.  Leading batch axes
    ride through one schedule (the executor's ``off``).  Differentiable
    in ``x`` and the filter through the plans of ``repro_torch.grad.vjp``.
    """
    from repro_torch.grad import vjp
    if opts is None:
        opts = FFTOptions()
    if x.ndim < 3:
        raise ValueError("packed_rfft3d expects a (..., Nx, Ny, Nz) block")
    shape = global_grid(x, mesh, decomp)
    reason = packed_unsupported_reason(shape, decomp, mesh, opts)
    if reason is not None:
        raise ValueError(f"packed r2c unsupported here: {reason}")
    scale = norm_factor(shape, -1, norm)
    x = x.to(mesh.device)
    nbatch = x.ndim - 3
    if kspace_filter is not None and fold_filter:
        # folded epilogue: the filter's packed half spectrum, moved to the
        # body's output layout, multiplies the body's last block
        cdtype = packing.complex_dtype_for(x.dtype)
        nat = build_packed_forward(decomp).layout_out.partition_spec()
        hp = kspace_filter[..., :shape[2] // 2].to(mesh.device, cdtype)
        hp = mesh.reshard(hp.contiguous(), shape[:2] + (shape[2] // 2,),
                          decomp.spectral_spec(), nat)
        plan = vjp.packed_rfft_folded_plan(mesh, decomp, opts, scale, nbatch,
                                           hp.ndim - 3)
        return plan(x, hp)
    y = vjp.packed_rfft_plan(mesh, decomp, opts, scale, nbatch)(x)
    if kspace_filter is not None:
        y = vjp.spectral_scale(y, kspace_filter.to(y.device, y.dtype))
    return y


def packed_irfft3d(y: torch.Tensor, nz: int, mesh, decomp: Decomposition,
                   opts: Optional[FFTOptions] = None,
                   norm: Optional[str] = None) -> torch.Tensor:
    """Distributed packed c2r: this rank's spectral-layout block of the
    (..., Nx, Ny, Nz//2 + 1) spectrum -> its block of the real
    (..., Nx, Ny, Nz) field in the same layout.  Differentiable through
    ``repro_torch.grad.vjp.packed_irfft_plan``."""
    from repro_torch.grad import vjp
    if opts is None:
        opts = FFTOptions()
    if y.ndim < 3:
        raise ValueError("packed_irfft3d expects a (..., Nx, Ny, Nh) block")
    nx, ny = global_grid(y, mesh, decomp)[:2]
    shape = (nx, ny, nz)
    reason = packed_unsupported_reason(shape, decomp, mesh, opts)
    if reason is not None:
        raise ValueError(f"packed c2r unsupported here: {reason}")
    plan = vjp.packed_irfft_plan(mesh, decomp, nz, opts,
                                 norm_factor(shape, +1, norm), y.ndim - 3)
    return plan(y.to(mesh.device))
