"""Public CROFT API: plan-style handle over the distributed 3-D FFT.

Port of ``repro/core/api.py``.  ``Croft3D`` is the analogue of
``croft_parallel3d`` plus FFTW's plan object: it binds (grid shape, mesh,
decomposition, options) once, validates, and exposes the forward/inverse
transforms.  With a mesh, every rank holds a ``Croft3D`` and calls it
with its own local block.

Problem classes: ``problem="c2c"`` (default) plans the complex
transform; ``problem="r2c"`` plans a real-input transform whose forward
matches ``torch.fft.rfftn`` and whose inverse is the exact c2r — the
packed two-for-one pipeline or the embedding (``repro_torch.real``,
``strategy=``).  ``forward_filtered`` fuses a k-space multiply into the
forward; :func:`poisson_solve` is a spectral solver whose multiply
computes -1/k² in the pass.

Every transform is differentiable: ``loss.backward()`` runs the adjoint
schedule of the plan (``repro_torch.grad``), with a mesh on every rank
— each rank must call ``backward()``.

Autotuning: ``Croft3D.tuned(shape, mesh, mode=...)`` (or ``tune=`` on the
constructor) lets ``repro_torch.tuning`` pick the plan, every rank the
same one; ``schedule=`` runs a searched pipeline (a
``tuning.candidates.ScheduleCandidate``) instead of a fixed builder's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import distributed
from repro_torch.core.decomposition import Decomposition, spec_slices
from repro_torch.core.distributed import FFTOptions
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.tracer import span

POISSON_FUSED = "poisson_fused_multipliers"


@dataclasses.dataclass
class Croft3D:
    """A planned distributed 3-D FFT.

    >>> plan = Croft3D((1024, 1024, 1024), mesh,
    ...                Decomposition("pencil", ("data", "model")))
    >>> y = plan.forward(x)        # x: this rank's block, plan.input_sharding
    >>> x2 = plan.inverse(y)       # == x up to dtype tolerance

    Real transforms: ``Croft3D(shape, mesh, dec, problem="r2c")``.
    ``forward`` then takes a real block (``input_dtype``; the packed
    strategy wants z-pencils, see ``input_sharding``) and returns the
    (Nx, Ny, Nz//2 + 1) half spectrum; ``inverse`` returns the real field.

    Meshless plans run on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``); with a mesh, on the mesh's device.  A c2c
    plan builds its two schedules once; every transform, meshless or
    not, runs them through ``schedule.run_schedule``.
    """

    shape: tuple[int, int, int]
    mesh: Optional[object] = None
    decomp: Optional[Decomposition] = None
    opts: FFTOptions = dataclasses.field(default_factory=FFTOptions)
    dtype: torch.dtype = torch.complex64
    #: problem class: "c2c" | "r2c" (``dtype`` is always the spectrum dtype)
    problem: str = "c2c"
    device: Optional[object] = None
    #: r2c only: "packed" | "embed" | None (= auto); resolved in __post_init__
    strategy: Optional[str] = None
    #: autotune mode ("wisdom" | "model" | "measure"); when set, the
    #: planner overrides ``decomp``/``opts`` (see ``repro_torch.tuning``)
    tune: Optional[str] = None
    #: tune for a *training step*: the planner prices forward + adjoint
    #: schedule (problem axis "c2c_grad"/"r2c_grad") instead of forward
    #: only.  Transforms themselves are identical — gradients work on
    #: every plan; this only changes which plan wins.
    grad: bool = False
    wisdom_path: Optional[str] = None
    #: extra keyword arguments for ``tuning.tune`` (top_k, measure_iters, ...)
    tune_kw: Optional[dict] = None
    #: searched pipeline (``tuning.candidates.ScheduleCandidate``): when
    #: set, forward/inverse run this explicit stage list (per-stage
    #: transpose impls / K) instead of the fixed builders; ``decomp`` and
    #: ``opts`` are taken from it.  c2c only.  Set directly, or by the
    #: tune path when the planner's schedule search picks one.
    schedule: Optional[object] = None
    tune_result = None  # TuneResult when the planner picked the plan

    def __post_init__(self):
        if self.problem not in ("c2c", "r2c"):
            hint = ("; grad-aware tuning is selected with grad=True "
                    "(Croft3D.tuned(..., grad=True)), not a problem suffix"
                    if str(self.problem).endswith("_grad") else "")
            raise ValueError(f"problem must be 'c2c' or 'r2c', got "
                             f"{self.problem!r}{hint}")
        self.shape = tuple(self.shape)
        if self.tune is not None and self.mesh is None:
            raise ValueError("tune= needs a mesh (single-device plans have "
                             "nothing to tune)")
        if self.tune is not None:
            from repro_torch import tuning
            tune_problem = self.problem + ("_grad" if self.grad else "")
            result = tuning.tune(self.shape, self.mesh, mode=self.tune,
                                 dtype=self.dtype, problem=tune_problem,
                                 wisdom_path=self.wisdom_path,
                                 **(self.tune_kw or {}))
            self.decomp, self.opts = result.decomp, result.opts
            if self.problem == "r2c":
                self.strategy = result.strategy
            self.schedule = result.schedule
            self.tune_result = result
        if self.schedule is not None:
            if self.problem != "c2c":
                raise ValueError("schedule= (a searched pipeline) plans "
                                 "the c2c problem only")
            if self.mesh is None:
                raise ValueError("schedule= needs a mesh")
            self.decomp, self.opts = self.schedule.decomp, self.schedule.opts
            # basic mesh/axis checks at the weakest fixed-builder
            # settings, then the searched pipeline's own shape checks
            # (its transpose orders chunk along other axes than the
            # fixed pipelines, so the fixed K rules don't apply)
            self.decomp.validate(self.shape, self.mesh, 1, "alltoall")
            self.schedule.validate(self.shape, self.mesh.shape)
            self._sched_fwd = self.schedule.build_schedule()
            self._sched_inv = distributed.inverse_schedule(self._sched_fwd)
        elif self.mesh is not None:
            if self.decomp is None:
                raise ValueError("a mesh requires a Decomposition")
            self.decomp.validate(self.shape, self.mesh, self.opts.overlap_k,
                                 self.opts.transpose_impl)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))
        if self.problem == "r2c":
            from repro_torch import real as real_lib
            self.strategy = real_lib.resolve_strategy(
                self.strategy, self.shape, self.mesh, self.decomp, self.opts)
        elif self.schedule is None:
            self._sched_fwd, self._sched_inv = (
                distributed.c2c_schedule(self.mesh, self.decomp, self.opts,
                                         sign) for sign in (-1, +1))

    @classmethod
    def from_tokens(cls, shape: Sequence[int], decomp_token: str,
                    opts_token: str, mesh, **kw) -> "Croft3D":
        """The plan named by the reference's ``Decomposition.to_token()``
        and ``FFTOptions.to_token()`` strings (the wisdom store's and the
        plan cache's plan identity)."""
        return cls(tuple(shape), mesh, Decomposition.from_token(decomp_token),
                   FFTOptions.from_token(opts_token), **kw)

    # -- dtypes / shapes -----------------------------------------------------
    @property
    def input_dtype(self) -> torch.dtype:
        """What ``forward`` consumes: real for r2c, ``dtype`` for c2c."""
        if self.problem == "r2c":
            from repro_torch.real.packing import real_dtype_for
            return real_dtype_for(self.dtype)
        return self.dtype

    @property
    def spectrum_shape(self) -> tuple[int, int, int]:
        """Global shape of ``forward``'s output."""
        if self.problem == "r2c":
            return self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape

    # -- layouts -------------------------------------------------------------
    def _slices(self, spec, shape=None) -> tuple:
        """This rank's index ranges of ``shape`` (the grid) under a
        partition spec."""
        return spec_slices(spec, shape or self.shape, self.mesh.shape,
                           self.mesh.coords)

    @property
    def input_sharding(self) -> Optional[tuple]:
        """The global index ranges of this rank's input block (None when
        meshless): a c2c plan's are its forward schedule's input layout.
        Packed real input is z-pencils: the r2c stage runs first, so the
        pipeline starts where the c2c pipeline ends."""
        if self.mesh is None:
            return None
        if self.problem == "c2c":
            return self._slices(self._sched_fwd.layout_in.partition_spec())
        return self._slices(self.decomp.spec(
            "spectral" if self.strategy == "packed" else "natural"))

    @property
    def output_sharding(self) -> Optional[tuple]:
        """The global index ranges of this rank's output block: a c2c
        plan's are its forward schedule's output layout (a searched one
        can end on layouts no fixed spec names, e.g. x sharded by the z
        communicator).  The r2c half spectrum keeps Nh = Nz//2 + 1 local
        (it never divides the z shards): its block is the spectral
        layout's, or for cell x and y sharded with z replicated
        (``rfft.embed_spec``)."""
        if self.mesh is None:
            return None
        if self.problem == "c2c":
            return self._slices(self._sched_fwd.layout_out.partition_spec())
        from repro_torch.core.rfft import embed_spec
        return self._slices(embed_spec(self.decomp), self.spectrum_shape)

    def batched_sharding(self, which: str = "input") -> Optional[tuple]:
        """``input_sharding``/``output_sharding`` widened with a leading
        full batch axis (the block of a (B, ...) stack this rank holds)."""
        base = (self.input_sharding if which == "input"
                else self.output_sharding)
        if base is None:
            return None
        return (slice(None),) + tuple(base)

    def local_shape(self) -> tuple[int, ...]:
        if self.mesh is None:
            return self.shape
        return self.decomp.local_shape(self.shape, self.mesh)

    def local_input_shape(self) -> tuple[int, ...]:
        """The shape of the block ``forward`` takes on this rank."""
        if self.mesh is None:
            return self.shape
        return tuple(s.stop - s.start for s in self.input_sharding)

    def _check(self, x: torch.Tensor, sharding, shape) -> None:
        if self.mesh is None:
            want = tuple(shape)
        else:
            want = tuple(s.stop - s.start for s in sharding)
        if tuple(x.shape[-3:]) != want:
            raise ValueError(f"expected a block of shape {want} (leading "
                             f"batch dims allowed), got {tuple(x.shape)}")

    # -- transforms ----------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("croft3d:forward", "plan", problem=self.problem):
            return self._forward(x)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        with span("croft3d:inverse", "plan", problem=self.problem):
            return self._inverse(y)

    def _inverse(self, y: torch.Tensor) -> torch.Tensor:
        self._check(y, self.output_sharding, self.spectrum_shape)
        if self.problem == "r2c":
            from repro_torch.core import rfft
            return rfft.irfft3d(y, self.shape[-1], self.mesh, self.decomp,
                                self.opts, strategy=self.strategy,
                                device=self.device)
        return distributed.scheduled_fft3d(y.to(self.device), self.mesh,
                                           self._sched_inv, self.opts,
                                           norm="backward")

    def _forward(self, x: torch.Tensor, h=None,
                 fold: bool = False) -> torch.Tensor:
        self._check(x, self.input_sharding, self.shape)
        if self.problem == "r2c":
            from repro_torch.core import rfft
            return rfft.rfft3d(x, self.mesh, self.decomp, self.opts,
                               strategy=self.strategy, kspace_filter=h,
                               fold_filter=fold, device=self.device)
        if fold:
            raise ValueError("fold=True is the packed r2c folded epilogue; "
                             "c2c filters are always fused in-schedule")
        return distributed.scheduled_fft3d(x.to(self.device), self.mesh,
                                           self._sched_fwd, self.opts,
                                           kspace_filter=h)

    def forward_filtered(self, x: torch.Tensor, h: torch.Tensor,
                         alpha: float = 1.0,
                         fold: bool = False) -> torch.Tensor:
        """``forward`` with the k-space multiply ``alpha * h`` fused in.

        The multiply rides as a schedule epilogue (c2c: attached to the
        last stage via ``Schedule.with_epilogue``; packed r2c: right
        after the DC/Nyquist plane unfold) through the
        ``kernels/spectral_scale.py`` kernel.  ``h`` is shaped like
        ``spectrum_shape`` (with a mesh: this rank's ``output_sharding``
        block of it).

        ``fold=True`` (distributed packed r2c only) moves the multiply
        *before* the DC/Nyquist unfold, onto the packed half spectrum
        inside the schedule — valid for filters with ``h(kz=0) ==
        h(kz=Nyquist)``, that plane real and 2-D-even (e.g. a
        kz-independent low-pass over (kx, ky)).
        """
        with span("croft3d:forward_filtered", "plan",
                  problem=self.problem):
            hh = h if alpha == 1.0 else h * alpha
            return self._forward(x, hh, fold)

    def forward_batched(self, x: torch.Tensor) -> torch.Tensor:
        """``forward`` over a (B, Nx, Ny, Nz) stack: the executor carries
        the batch axis through every stage (natively for packed r2c, its
        DC/Nyquist unfold included), so the collective count is B=1's and
        each field's result equals its own ``forward``."""
        return self.forward(x)

    def inverse_batched(self, y: torch.Tensor) -> torch.Tensor:
        """``inverse`` over a (B, ...) spectrum stack."""
        return self.inverse(y)

    def forward_filtered_batched(self, x: torch.Tensor,
                                 h: torch.Tensor) -> torch.Tensor:
        """:meth:`forward_filtered` over (B, ...) field and filter stacks
        (each field brings its own ``h``), through the same collectives as
        one field."""
        return self.forward_filtered(x, h)

    def release(self) -> None:
        """Drop the cached autograd plans (``repro_torch.grad.vjp``; the
        cache is shared by every plan and rebuilt on demand), and with
        them the meshes they hold.  The port runs eagerly and holds no
        compiled executables, the reference's other use of this hook."""
        from repro_torch.grad import vjp
        vjp.clear_plans()

    # -- autotuning ----------------------------------------------------------
    @classmethod
    def tuned(cls, shape, mesh, *, mode: str = "model",
              wisdom_path: Optional[str] = None, dtype=torch.complex64,
              problem: str = "c2c", batch: int = 1, grad: bool = False,
              **tune_kw) -> "Croft3D":
        """Plan via the autotuner (``repro_torch.tuning``) instead of
        hand-picked (decomp, opts); every rank of ``mesh`` calls it and
        gets the same plan.

        ``mode="model"`` is FFTW ESTIMATE (analytic, zero execution),
        ``mode="measure"`` is PATIENT (times the top candidates on the
        mesh, each the slowest rank's time), ``mode="wisdom"`` reuses a
        stored plan from ``wisdom_path`` (or $CROFT_WISDOM).
        ``problem="r2c"`` plans the real transform (the planner also
        chooses the packed/embed strategy).  ``batch=B`` plans for B
        stacked fields: the cost model scales volume terms by B,
        ``mode="measure"`` times ``forward_batched`` over B fields, and
        the wisdom key gains a ``|b{B}`` dimension.  ``grad=True`` prices
        a *training step*: forward schedule plus its adjoint, timed as
        forward + ``backward()``, under a ``|grad`` key.  The chosen
        plan's provenance is on ``plan.tune_result``.
        """
        if batch != 1:
            tune_kw = dict(tune_kw, batch=batch)
        return cls(tuple(shape), mesh, dtype=dtype, tune=mode,
                   problem=problem, grad=grad, wisdom_path=wisdom_path,
                   tune_kw=tune_kw or None)

    def candidate(self):
        """This plan's tuner-space identity: the searched
        ``ScheduleCandidate`` when one was picked, else the
        (decomp, opts) ``Candidate`` — the object the cost model reads."""
        from repro_torch.tuning.candidates import Candidate
        if self.schedule is not None:
            if self.schedule.problem == self.problem:
                return self.schedule
            return dataclasses.replace(self.schedule, problem=self.problem)
        return Candidate(self.decomp, self.opts, problem=self.problem,
                         strategy=self.strategy)

    # -- models --------------------------------------------------------------
    def _forward_schedule(self):
        """The stage schedule ``forward`` executes (None when meshless) —
        the tuner's ``cost_model.schedule_for``, so this plan's models and
        the planner's ranking read the identical object (including
        out-of-body reshards like the embedding's guarded half-slice)."""
        if self.mesh is None or self.decomp is None:
            return None
        from repro_torch.tuning.cost_model import schedule_for
        return schedule_for(self.shape, self.candidate())

    def flops_model(self) -> float:
        """Analytic 5 N log2 N FLOP count for the full 3-D transform,
        summed over the schedule's local-FFT events (so the packed real
        pipeline's halved stages are charged at their true sizes)."""
        sched = self._forward_schedule()
        if sched is None:
            n_total = math.prod(self.shape)
            flops = 5.0 * n_total * sum(math.log2(s) for s in self.shape)
            if self.problem == "r2c" and self.strategy == "packed":
                flops *= 0.5
            return flops
        sizes = dict(self.mesh.shape)
        per_device = sum(5.0 * elems * math.log2(n) for _, elems, n
                         in sched.fft_events(self.shape, sizes))
        return per_device * self.decomp.n_procs(sizes)

    def comm_bytes_model(self) -> float:
        """Bytes each rank's transposes move per transform: the sum of the
        schedule's per-stage transpose volumes plus its out-of-body
        reshards — read from the same ``Schedule`` the executor runs.
        ``Mesh.counting`` counts all of it for an all-to-all stage, whose
        send buffer holds the rank's own chunk, and (P-1)/P of it for a
        ring or pairwise stage, which never sends the piece it keeps."""
        sched = self._forward_schedule()
        if sched is None:
            return 0.0
        events = sched.comm_events(self.shape, self.mesh.shape,
                                   self.dtype.itemsize)
        return float(sum(ev["bytes"] for ev in events))


def auto_pencil(shape: Sequence[int], mesh,
                axes: Sequence[str] = ("data", "model")) -> Decomposition:
    """Pencil decomposition over the given mesh axes (fig. 5 virtual grid)."""
    return Decomposition("pencil", tuple(axes))


def poisson_solve(rhs: torch.Tensor, plan: Croft3D,
                  box: float = 2 * math.pi) -> torch.Tensor:
    """Spectral Poisson solve  ∇²u = f  on a periodic box (example app).

    Works with both problem classes: a c2c plan sees the full spectrum, an
    r2c plan the Hermitian half (kz from ``rfftfreq``).  The multiplier
    1/(-k²) is computed inside the k-space multiply from the three 1-D
    wavenumber vectors (``kernels/spectral_scale.py:poisson_scale``), one
    pass over the forward's output: no tensor of the spectrum's shape
    holds it.  With a mesh, ``rhs`` is this rank's input block and the
    vectors are cut to its ``output_sharding`` block.  The vectors, k²
    and -1/k² are float32 for every plan dtype, a complex128 plan's
    included (-1/k² to about 6e-8 relative).  Each solve counts one on
    the ``poisson_fused_multipliers`` counter.
    """
    from repro_torch.grad import vjp
    nx, ny, nz = plan.shape
    dev = plan.device
    with span("poisson:solve", "plan", problem=plan.problem):
        with span("poisson:multiplier", "epilogue", dev):
            kx = torch.fft.fftfreq(nx, d=box / (2 * math.pi * nx),
                                   dtype=torch.float32, device=dev)
            ky = torch.fft.fftfreq(ny, d=box / (2 * math.pi * ny),
                                   dtype=torch.float32, device=dev)
            freq = (torch.fft.rfftfreq if plan.problem == "r2c"
                    else torch.fft.fftfreq)
            kz = freq(nz, d=box / (2 * math.pi * nz), dtype=torch.float32,
                      device=dev)
            if plan.mesh is not None:
                sx, sy, sz = plan.output_sharding
                kx, ky, kz = kx[sx], ky[sy], kz[sz]
        u_hat = plan.forward(rhs.to(plan.input_dtype))
        u_hat = vjp.poisson_scale(u_hat, kx, ky, kz)
        metrics_lib.get_registry().counter(
            POISSON_FUSED, "Poisson solves whose -1/k^2 was computed inside "
            "the k-space multiply").inc()
        return plan.inverse(u_hat)
