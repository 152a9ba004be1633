"""Distributed 3-D FFT entry points: build a stage schedule, run it.

Port of ``repro/core/distributed.py`` (the complex transform).  Mapping
from the paper's MPI+OpenMP design to PyTorch:

  row/column MPI communicators  ->  mesh axes: one process group each
                                    (``core/mesh.py``)
  MPI_Alltoall                  ->  ``all_to_all_single`` (split/concat
                                    axes express the pack/unpack steps
                                    2,4,6,8)
  OpenMP comm thread + K chunks ->  K chunks per stage, emitted as a
                                    depth-1 software pipeline: chunk i's
                                    collective is in flight (async) while
                                    chunk i+1's FFT runs.  K=1 reproduces
                                    options 1/2, K>=2 options 3/4.
                                    ``transpose_impl="ring"`` decomposes
                                    each transpose into P-1 point-to-point
                                    rounds with the fused pack/unpack
                                    kernel (``kernels/transpose_pack.py``).
  FFTW plan reuse               ->  plan-constant caching (plan.py);
                                    disabled = "multiple plans" options 1/3.

The pipeline itself is data: ``schedule.build_c2c`` builds it (and
``schedule.build_local_c2c`` one device's) and ``schedule.run_schedule``
executes it on each rank's local block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import schedule as schedule_lib
from repro_torch.core.decomposition import Decomposition
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FFTOptions:
    """Knobs reproducing the paper's option matrix (§5.1) plus extensions.

    overlap_k      CROFT's K: chunks per (FFT -> all_to_all) stage. 1 = no
                   overlap (options 1/2); 2 = CROFT's shipped default.
    plan_cache     True = "single plan" (options 2/4); False = re-materialize
                   twiddles per call ("multiple plans", options 1/3).
    local_impl     "matmul" (four-step) | "stockham" | "xla" (the library
                   FFT) | "pallas" (the hand-written four-step Hopper
                   kernel; the reference's name, kept so tokens match);
                   or a 3-tuple of those, one per pipeline stage in
                   execution order.  A homogeneous tuple collapses to its
                   single value (canonical form for wisdom keys).
    output_layout  "natural" (paper: restore the input pencil layout with two
                   reverse transposes) | "spectral" (beyond-paper: stay in
                   z-pencil layout, halving collective bytes).
    transpose_impl "alltoall" (one fused collective) | "ring" (P-1
                   point-to-point rounds with the fused pack/unpack
                   kernel) | "pairwise" (FFTW3-style blocking rounds).
                   ring/pairwise run over single mesh axes only — folded
                   axes and the cell regroup communicator are rejected by
                   ``Decomposition.validate``.
    overlap_mode   "pipelined" | "unrolled", or a 3-tuple of those, one per
                   pipeline stage (indexed like ``local_impl``): the
                   reference's two emission orders of K >= 2 chunks, kept
                   for plan tokens and the tuner's candidates.  The port
                   issues both as one order, chunk after chunk, each
                   chunk's collective posted before the next chunk's FFT
                   (``schedule.run_stage``); results are bitwise equal.
    """

    overlap_k: int = 2
    plan_cache: bool = True
    local_impl: Union[str, tuple] = "matmul"
    output_layout: str = "natural"
    transpose_impl: str = "alltoall"
    overlap_mode: Union[str, tuple] = "pipelined"

    TRANSPOSE_IMPLS = ("alltoall", "ring", "pairwise")
    OVERLAP_MODES = ("pipelined", "unrolled")

    def __post_init__(self):
        object.__setattr__(self, "local_impl",
                           _canon_stage_tuple("local_impl", self.local_impl))
        om = _canon_stage_tuple("overlap_mode", self.overlap_mode)
        for m in (om if isinstance(om, tuple) else (om,)):
            if m not in self.OVERLAP_MODES:
                raise ValueError(f"overlap_mode must be one of "
                                 f"{self.OVERLAP_MODES}, got {m!r}")
        object.__setattr__(self, "overlap_mode", om)
        if self.transpose_impl not in self.TRANSPOSE_IMPLS:
            raise ValueError(f"transpose_impl must be one of "
                             f"{self.TRANSPOSE_IMPLS}, got "
                             f"{self.transpose_impl!r}")

    # -- canonical string form (plan-cache / wisdom keys) -------------------
    def to_token(self) -> str:
        """Canonical string form covering every knob that changes the
        transform, e.g.
        ``k2/matmul-stockham-xla/natural/ring/pipelined-unrolled-unrolled``
        with ``/noplan`` appended when ``plan_cache=False``.  Round trips
        through :meth:`from_token`."""
        def join(v):
            return "-".join(v) if isinstance(v, tuple) else v
        tok = (f"k{self.overlap_k}/{join(self.local_impl)}/"
               f"{self.output_layout}/{self.transpose_impl}/"
               f"{join(self.overlap_mode)}")
        if not self.plan_cache:
            tok += "/noplan"
        return tok

    @classmethod
    def from_token(cls, token: str) -> "FFTOptions":
        """Inverse of :meth:`to_token`."""
        parts = token.split("/")
        plan_cache = True
        if parts and parts[-1] == "noplan":
            plan_cache = False
            parts = parts[:-1]
        if len(parts) != 5 or not parts[0].startswith("k"):
            raise ValueError(f"malformed FFTOptions token {token!r}")

        def split(v):
            items = v.split("-")
            return tuple(items) if len(items) > 1 else v
        return cls(overlap_k=int(parts[0][1:]), local_impl=split(parts[1]),
                   output_layout=parts[2], transpose_impl=parts[3],
                   overlap_mode=split(parts[4]), plan_cache=plan_cache)

    def stage_impl(self, stage: int) -> str:
        """Local 1-D implementation for the given pipeline stage."""
        if isinstance(self.local_impl, tuple):
            return self.local_impl[stage]
        return self.local_impl

    def stage_overlap(self, stage: int) -> str:
        """Chunk emission mode for the given pipeline stage."""
        if isinstance(self.overlap_mode, tuple):
            return self.overlap_mode[stage]
        return self.overlap_mode

    @classmethod
    def paper_option(cls, opt: int, **kw) -> "FFTOptions":
        """CROFT paper options 1-4 (§5.1)."""
        table = {
            1: dict(overlap_k=1, plan_cache=False),
            2: dict(overlap_k=1, plan_cache=True),
            3: dict(overlap_k=2, plan_cache=False),
            4: dict(overlap_k=2, plan_cache=True),  # shipped CROFT
        }
        return cls(**{**table[opt], **kw})


def _canon_stage_tuple(name: str, value: Union[str, tuple]) -> Union[str, tuple]:
    """Canonicalize a per-stage knob: 3-tuples collapse to their single
    value when homogeneous (the canonical form for wisdom keys)."""
    if isinstance(value, (list, tuple)):
        value = tuple(value)
        if len(value) != 3:
            raise ValueError(
                f"per-stage {name} needs exactly 3 entries, got {value}")
        if len(set(value)) == 1:
            value = value[0]
    return value


def _stage(blk: torch.Tensor, *, fft_axis: Optional[int],
           comm_axis, split_axis: int, concat_axis: int, chunk_axis: int,
           sign: int, opts: FFTOptions, mesh, stage: int = 0) -> torch.Tensor:
    """One ad-hoc pipeline stage (K-chunked FFT -> all-to-all) on this
    rank's block: a thin shim over :func:`schedule.run_stage` for callers
    that use the CROFT overlap pattern outside a full 3-D schedule."""
    st = schedule_lib.Stage("ad-hoc", fft_axis=fft_axis, comm_axis=comm_axis,
                            split_axis=split_axis, concat_axis=concat_axis,
                            chunk_axis=chunk_axis, impl_stage=stage)
    return schedule_lib.run_stage(blk, st, sign, opts, mesh)


class _Transpose(torch.autograd.Function):
    """An ad-hoc K-chunked transpose (no FFT) under autograd: a
    permutation of elements across the ranks, whose adjoint is the
    transpose back (split and concat axes swapped)."""

    @staticmethod
    def forward(ctx, blk, mesh, axis, split, concat, chunk, opts):
        ctx.args = (mesh, axis, split, concat, chunk, opts)
        return _stage(blk, fft_axis=None, comm_axis=axis, split_axis=split,
                      concat_axis=concat, chunk_axis=chunk, sign=-1,
                      opts=opts, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split, concat, chunk, opts = ctx.args
        back = _stage(g.contiguous(), fft_axis=None, comm_axis=axis,
                      split_axis=concat, concat_axis=split, chunk_axis=chunk,
                      sign=-1, opts=opts, mesh=mesh)
        return back, None, None, None, None, None, None


def transpose_stage(blk: torch.Tensor, *, comm_axis, split_axis: int,
                    concat_axis: int, chunk_axis: int, opts: FFTOptions,
                    mesh) -> torch.Tensor:
    """:func:`_stage` with no FFT (the all-to-all of CROFT's K-chunked
    pipeline alone), differentiable: the MoE dispatch and the FNet
    mixer's sequence transpose train through it."""
    return _Transpose.apply(blk, mesh, comm_axis, split_axis, concat_axis,
                            chunk_axis, opts)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def build_schedule(decomp: Decomposition, opts: FFTOptions,
                   sign: int = -1) -> schedule_lib.Schedule:
    """The c2c schedule ``distributed_fft3d`` will run for this plan
    (public hook for golden tests / inspection / the cost model)."""
    from_spectral = opts.output_layout == "spectral" and sign == +1
    return schedule_lib.build_c2c(decomp, sign=sign,
                                  output_layout=opts.output_layout,
                                  from_spectral=from_spectral)


def inverse_schedule(sched: schedule_lib.Schedule) -> schedule_lib.Schedule:
    """The unnormalized inverse of a pure c2c schedule.

    The adjoint reverses the pipeline (every transpose swaps
    split/concat; per-stage impl/K overrides ride along) and a 1-D DFT
    matrix is symmetric, so the adjoint with the sign flipped *is* the
    inverse up to the 1/N factor the caller applies via ``norm``.  This
    is how searched schedules — which have no fixed inverse builder — get
    their inverse.  Restricted to pure complex pipelines: packing
    prologues/epilogues and out-of-body reshards are not sign-symmetric.
    """
    if any(st.prologue or st.epilogue for st in sched.stages) \
            or sched.epilogue or sched.extra_comms:
        raise ValueError("inverse_schedule covers pure c2c schedules only")
    from repro_torch.grad.adjoint import adjoint_schedule
    adj = adjoint_schedule(sched)
    return dataclasses.replace(adj, name=f"{sched.name}^-1",
                               sign=-sched.sign, points=None)


def c2c_schedule(mesh, decomp: Optional[Decomposition], opts: FFTOptions,
                 sign: int = -1) -> schedule_lib.Schedule:
    """The schedule a fixed c2c plan runs: :func:`build_schedule`'s on a
    mesh of more than one rank, else the single-device one
    (``schedule.build_local_c2c``)."""
    if mesh is None or mesh.size == 1:
        return schedule_lib.build_local_c2c(sign)
    return build_schedule(decomp, opts, sign)


def _run_plan(x: torch.Tensor, mesh, sched, opts: FFTOptions, scale,
              kspace_filter: Optional[torch.Tensor]) -> torch.Tensor:
    """Run ``sched`` through its plan (``repro_torch.grad.vjp``), so
    ``backward()`` runs the adjoint schedule; without grad the ops are
    those of the schedule alone.  Without a mesh ``x`` stays where it
    is."""
    from repro_torch.grad import vjp
    if mesh is not None:
        x = x.to(mesh.device)
    nbatch = x.ndim - 3
    if kspace_filter is None:
        return vjp.linear_plan(mesh, sched, opts, scale, nbatch)(x)
    return vjp.filtered_plan(mesh, sched, opts, scale, nbatch)(
        x, kspace_filter.to(x.device, x.dtype))


def scheduled_fft3d(x: torch.Tensor, mesh, sched: schedule_lib.Schedule,
                    opts: Optional[FFTOptions] = None,
                    norm: Optional[str] = None,
                    kspace_filter: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Run a prebuilt :class:`~repro_torch.core.schedule.Schedule` — the
    entry point of every plan (``Croft3D`` holds its schedules) and of
    pipelines that exist only as schedule objects (mixed per-stage
    transposes, searched orders).  ``x`` is this rank's block of the
    schedule's input layout (leading batch dims allowed), or with
    ``mesh=None`` the whole grid, transformed where it lies; the same
    contract as :func:`distributed_fft3d` otherwise, gradients
    included."""
    if opts is None:
        opts = FFTOptions()
    # normalization uses *global* sizes, applied to the local output
    shape = sched.layout_in.global_shape(
        x.shape, mesh.shape if mesh is not None else {})
    return _run_plan(x, mesh, sched, opts,
                     schedule_lib.norm_factor(shape, sched.sign, norm),
                     kspace_filter)


def distributed_fft3d(x: torch.Tensor, mesh, decomp: Decomposition,
                      sign: int = -1, opts: Optional[FFTOptions] = None,
                      norm: Optional[str] = None,
                      kspace_filter: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """3-D FFT of a field distributed over ``mesh``; ``x`` is this rank's
    local block (leading batch dims allowed), laid out as the schedule's
    input layout says.  Every rank calls it collectively.  It builds and
    validates its schedule on every call: a plan (``Croft3D``) does both
    once.

    ``kspace_filter`` (this rank's block of a filter laid out like the
    output spectrum) fuses a pointwise k-space multiply into the
    transform as a terminal schedule epilogue (``SpectralScale``).

    Differentiable in ``x`` and the filter: the run goes through the
    plans of ``repro_torch.grad.vjp``, whose backward runs the adjoint
    schedule (every rank must call ``backward()``)."""
    if opts is None:
        opts = FFTOptions()
    sched = build_schedule(decomp, opts, sign)
    shape = sched.layout_in.global_shape(x.shape, mesh.shape)
    decomp.validate(shape, mesh, opts.overlap_k, opts.transpose_impl)
    return scheduled_fft3d(x, mesh, sched, opts, norm, kspace_filter)


def _local_device(mesh, device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


def _c2c(x, mesh, decomp, sign, opts, norm, device, kspace_filter):
    """:func:`fft3d`/:func:`ifft3d`: :func:`c2c_schedule`'s schedule, a
    decomposition's validated on every call, through the executor."""
    if opts is None:
        opts = FFTOptions()
    sched = c2c_schedule(mesh, decomp, opts, sign)
    x = x.to(_local_device(mesh, device))
    if sched.comm_stages():
        decomp.validate(sched.layout_in.global_shape(x.shape, mesh.shape),
                        mesh, opts.overlap_k, opts.transpose_impl)
    return scheduled_fft3d(x, mesh, sched, opts, norm, kspace_filter)


def fft3d(x, mesh=None, decomp=None, opts: Optional[FFTOptions] = None,
          norm: Optional[str] = None, device=None,
          kspace_filter: Optional[torch.Tensor] = None):
    """Forward 3-D FFT, the k-space multiply fused in when
    ``kspace_filter`` is given.  Without a mesh (or on a mesh of one
    rank) the whole grid on ``device``: the CUDA card unless the caller
    passes ``device="cpu"``."""
    return _c2c(x, mesh, decomp, -1, opts, norm, device, kspace_filter)


def ifft3d(x, mesh=None, decomp=None, opts: Optional[FFTOptions] = None,
           norm: Optional[str] = "backward", device=None):
    """Inverse 3-D FFT (paper eq. 2: 1/(NxNyNz) normalization)."""
    return _c2c(x, mesh, decomp, +1, opts, norm, device, None)


def fft3d_local(x: torch.Tensor, sign: int = -1, *, impl="matmul",
                plan_cache: bool = True,
                norm: Optional[str] = None) -> torch.Tensor:
    """Single-device 3-D FFT over the last three axes (x, y, z order),
    where ``x`` lies: ``build_local_c2c`` through the executor.

    ``impl`` may be a 3-tuple of implementations, one per axis in
    transform order (x, y, z) — the per-stage form of
    ``FFTOptions.local_impl``.
    """
    if x.ndim < 3:
        raise ValueError(f"fft3d_local needs >= 3 dims, got {x.ndim}")
    return scheduled_fft3d(x, None, schedule_lib.build_local_c2c(sign),
                           FFTOptions(local_impl=impl, plan_cache=plan_cache),
                           norm)
