"""repro_torch.real — real-to-complex / complex-to-real transforms.

Port of ``repro/real``.  Two strategies:

  "packed"  the two-for-one trick (``packing.py``): two real z-pencils
            share one complex z transform, the spectrum is carried as
            exactly Nz/2 shard-aligned complex bins (Nyquist folded
            into DC), and every transpose/FFT stage after the first
            moves/computes half of what the c2c pipeline would
            (``pipeline.py``).  The hot unpack / Hermitian-extend steps
            run in the Hopper kernels of ``repro_torch.kernels.hermitian``
            under the ``"pallas"`` local impl.
  "embed"   cast real -> complex, run c2c, keep the non-redundant half
            (``repro_torch.core.rfft``); every decomposition, cell
            included.

``resolve_strategy`` picks between them ("auto") with the reference's
rule and reasons.  Public entry points:
``repro_torch.core.rfft.rfft3d/irfft3d(strategy=...)`` and
``Croft3D(..., problem="r2c")``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core import local_fft
from repro_torch.core.decomposition import mesh_axis_sizes
from repro_torch.core.distributed import FFTOptions
from repro_torch.core.schedule import norm_factor, normalize
from repro_torch.obs.tracer import span
from repro_torch.real import packing
from repro_torch.real.pipeline import (PAIR_AXIS, build_packed_forward,
                                       build_packed_inverse, fold_dc_plane,
                                       packed_irfft3d, packed_rfft3d,
                                       packed_unsupported_reason,
                                       real_input_spec, unfold_dc_plane)

STRATEGIES = ("auto", "packed", "embed")


def is_multidevice(mesh) -> bool:
    """True for a mesh of more than one rank (the reference's
    ``math.prod(mesh.devices.shape) > 1``)."""
    return mesh is not None and math.prod(
        mesh_axis_sizes(mesh).values()) > 1


def _choose_pair_axis(nx: int, ny: int) -> Optional[int]:
    """Axis to pair z-pencils along on a single device: prefer y (keeps
    x contiguous for the later transforms), fall back to x."""
    if ny % 2 == 0:
        return -2
    if nx % 2 == 0:
        return -3
    return None


def packed_local_reason(shape: Sequence[int]) -> Optional[str]:
    """None if the single-device packed path supports ``shape``."""
    nx, ny = shape[-3], shape[-2]
    if _choose_pair_axis(nx, ny) is None:
        return (f"no even axis to pair z-pencils along (Nx={nx}, Ny={ny} "
                "both odd)")
    return None


def local_rfft3d_packed(x: torch.Tensor, opts: Optional[FFTOptions] = None,
                        norm: Optional[str] = None) -> torch.Tensor:
    """Single-device packed r2c: real (..., Nx, Ny, Nz) -> (..., Nx, Ny, Nh).

    Works for odd Nz too (the fold-free two-for-one keeps all Nh bins —
    there is no shard alignment to preserve on one device).
    Differentiable: the backward runs the transposed pipeline.
    """
    if opts is None:
        opts = FFTOptions()
    reason = packed_local_reason(x.shape)
    if reason is not None:
        raise ValueError(f"packed r2c unsupported here: {reason}")
    if torch.is_grad_enabled() and x.requires_grad:
        from repro_torch.grad import vjp
        return vjp.Linear.apply(x, _LocalRfft(tuple(x.shape[-3:]), opts,
                                              norm))
    return _rfft_packed(x, opts, norm)


def _rfft_packed(x, opts, norm):
    nx, ny, nz = x.shape[-3], x.shape[-2], x.shape[-1]
    pair_axis = _choose_pair_axis(nx, ny)
    fold = nz % 2 == 0  # odd Nz has no Nyquist bin; carry all Nh bins
    c = packing.pack_two(x, pair_axis)
    with span("stage:fft", "fft"):
        C = local_fft.fft_1d(c, -1, -1, impl=opts.stage_impl(0),
                             plan_cache=opts.plan_cache)
    S = packing.unpack_two(C, pair_axis, nh=nz // 2 + 1, fold=fold,
                           use_pallas=opts.stage_impl(0) == "pallas")
    with span("stage:fft", "fft"):
        S = local_fft.fft_1d(S, -2, -1, impl=opts.stage_impl(1),
                             plan_cache=opts.plan_cache)
    with span("stage:fft", "fft"):
        S = local_fft.fft_1d(S, -3, -1, impl=opts.stage_impl(2),
                             plan_cache=opts.plan_cache)
    # the fold stays valid under the (linear) y/x transforms; unfold the
    # DC/Nyquist plane once, at the end, like the distributed pipeline
    y = unfold_dc_plane(S) if fold else S
    return normalize(y, norm_factor((nx, ny, nz), -1, norm))


class _LocalRfft:
    """:func:`local_rfft3d_packed` as a linear plan (``grad.vjp.Linear``).
    Its adjoint is the pipeline's unconjugated transpose on ``conj(g)``
    (``grad/vjp.py``'s convention; the result is real): scale ->
    plane-unfold transpose -> x, y FFTs -> unpack transpose -> z FFT ->
    pack transpose, the FFTs with the forward's sign and, as an adjoint
    schedule's, the per-stage impls in execution order."""

    def __init__(self, shape, opts, norm):
        self.shape, self.opts, self.norm = shape, opts, norm

    def run(self, x):
        return _rfft_packed(x, self.opts, self.norm)

    def adjoint(self, g):
        from repro_torch.grad import adjoint, vjp
        (nx, ny, nz), opts = self.shape, self.opts
        pair_axis = _choose_pair_axis(nx, ny)
        fold = nz % 2 == 0
        ct = normalize(vjp.conj(g), norm_factor((nx, ny, nz), -1, self.norm))
        if fold:
            ct = adjoint.unfold_dc_plane_t(ct)
        for stage, ax in ((0, -3), (1, -2)):
            ct = local_fft.fft_1d(ct, ax, -1, impl=opts.stage_impl(stage),
                                  plan_cache=opts.plan_cache)
        ct = adjoint.unpack_two_t(ct, pair_axis % ct.ndim, nz, fold)
        ct = local_fft.fft_1d(ct, -1, -1, impl=opts.stage_impl(2),
                              plan_cache=opts.plan_cache)
        return adjoint.pack_two_t(ct, pair_axis % ct.ndim)


def local_irfft3d_packed(y: torch.Tensor, nz: int,
                         opts: Optional[FFTOptions] = None,
                         norm: Optional[str] = None) -> torch.Tensor:
    """Single-device packed c2r: (..., Nx, Ny, Nh) -> real (..., Nx, Ny, Nz).
    Differentiable: the backward runs the transposed pipeline."""
    if opts is None:
        opts = FFTOptions()
    nx, ny = y.shape[-3], y.shape[-2]
    reason = packed_local_reason((nx, ny, nz))
    if reason is not None:
        raise ValueError(f"packed c2r unsupported here: {reason}")
    if torch.is_grad_enabled() and y.requires_grad:
        from repro_torch.grad import vjp
        return vjp.Linear.apply(y, _LocalIrfft(tuple(y.shape[-3:]), nz, opts,
                                               norm))
    return _irfft_packed(y, nz, opts, norm)


def _irfft_packed(y, nz, opts, norm):
    nx, ny = y.shape[-3], y.shape[-2]
    pair_axis = _choose_pair_axis(nx, ny)
    fold = nz % 2 == 0
    t = fold_dc_plane(y, nz) if fold else y
    with span("stage:fft", "fft"):
        t = local_fft.fft_1d(t, -3, +1, impl=opts.stage_impl(0),
                             plan_cache=opts.plan_cache)
    with span("stage:fft", "fft"):
        t = local_fft.fft_1d(t, -2, +1, impl=opts.stage_impl(1),
                             plan_cache=opts.plan_cache)
    C = packing.repack_halves(t, pair_axis, nz, folded=fold,
                              use_pallas=opts.stage_impl(2) == "pallas")
    with span("stage:fft", "fft"):
        c = local_fft.fft_1d(C, -1, +1, impl=opts.stage_impl(2),
                             plan_cache=opts.plan_cache)
    return normalize(packing.split_pairs(c, pair_axis),
                     norm_factor((nx, ny, nz), +1, norm))


class _LocalIrfft:
    """:func:`local_irfft3d_packed` as a linear plan: its adjoint is the
    transposed pipeline on the real ``g`` (scale -> split transpose -> z
    FFT -> repack transpose -> y, x FFTs -> plane-fold transpose),
    conjugated."""

    def __init__(self, shape, nz, opts, norm):
        self.shape, self.nz, self.opts, self.norm = shape, nz, opts, norm

    def run(self, y):
        return _irfft_packed(y, self.nz, self.opts, self.norm)

    def adjoint(self, g):
        from repro_torch.grad import adjoint, vjp
        (nx, ny, nh), nz, opts = self.shape, self.nz, self.opts
        pair_axis = _choose_pair_axis(nx, ny)
        fold = nz % 2 == 0
        ct = normalize(g, norm_factor((nx, ny, nz), +1, self.norm))
        ct = adjoint.split_pairs_t(ct, pair_axis % ct.ndim)
        ct = local_fft.fft_1d(ct, -1, +1, impl=opts.stage_impl(0),
                              plan_cache=opts.plan_cache)
        ct = adjoint.repack_halves_t(ct, pair_axis % ct.ndim, nh, fold)
        for stage, ax in ((1, -2), (2, -3)):
            ct = local_fft.fft_1d(ct, ax, +1, impl=opts.stage_impl(stage),
                                  plan_cache=opts.plan_cache)
        if fold:
            ct = adjoint.fold_dc_plane_t(ct, nz)
        return vjp.conj(ct)


def unsupported_reason(shape: Sequence[int], mesh, decomp,
                       opts: Optional[FFTOptions]) -> Optional[str]:
    """Why the packed strategy cannot run this problem (None = it can)."""
    if not is_multidevice(mesh):
        return packed_local_reason(shape)
    return packed_unsupported_reason(shape, decomp, mesh,
                                     opts or FFTOptions())


def resolve_strategy(strategy: Optional[str], shape: Sequence[int], mesh,
                     decomp, opts: Optional[FFTOptions]) -> str:
    """Resolve "auto" to "packed"/"embed"; validate explicit choices.

    Explicitly requesting "packed" on an unsupported problem raises with
    the reason; "auto" falls back to the embedding.
    """
    strategy = strategy or "auto"
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "embed":
        return "embed"
    reason = unsupported_reason(shape, mesh, decomp, opts)
    if reason is None:
        return "packed"
    if strategy == "packed":
        raise ValueError(f"packed r2c unsupported here: {reason}")
    return "embed"


__all__ = [
    "PAIR_AXIS", "STRATEGIES", "build_packed_forward", "build_packed_inverse",
    "fold_dc_plane", "is_multidevice", "local_irfft3d_packed",
    "local_rfft3d_packed", "packed_irfft3d", "packed_local_reason",
    "packed_rfft3d", "packed_unsupported_reason", "packing",
    "real_input_spec", "resolve_strategy", "unfold_dc_plane",
    "unsupported_reason",
]
