"""Autograd wiring: plan-level backward passes for every entry point.

Port of ``repro/grad/vjp.py``.  Without this module ``loss.backward()``
through the transform has no route: the kernels write into fresh
tensors that carry no ``grad_fn``, and the collectives are not
autograd-aware.  Here each plan is a ``torch.autograd.Function`` whose
backward runs the *adjoint schedule*
(:func:`repro_torch.grad.adjoint.adjoint_schedule`) through the same
executor, options, overlap engine, transpose impl and kernels as the
forward.

Convention.  The reference's adjoint schedules are JAX's unconjugated
transpose ``ct -> A^T ct``; PyTorch's autograd wants ``g -> A^H g``.
The schedules stay the reference's, and every plan conjugates at its
boundary::

    backward(g) = scale * conj(run(adjoint, conj(g)))

A real input takes the real part (the packed pipelines' transposes end
in ``pack2T``, real already).  For a pure complex schedule (no packed
stage ops) the conjugation commutes with every transpose and turns each
same-sign FFT into the opposite-sign one, so such a plan runs its
adjoint with the sign flipped (``distributed.inverse_schedule``) and
conjugates nothing: the same result without two passes over the
spectrum.  The k-space multiply ``y = s * h`` has cotangents
``g * conj(h)`` and ``g * conj(s)``, both through the spectral-scale
kernel.  So for a complex input ``x.grad == conj(jax_vjp(conj(g)))``,
for a real one ``x.grad == jax_vjp(conj(g))``.

Scaling: norm factors (``schedule.norm_factor``) are real scalars, so
the same ``scale`` rides both directions, applied by
``schedule.normalize``.  The linear plans save no tensors; the filtered
ones save the spectrum ``s`` and ``h``.

Plans are cached per ``(mesh, schedule, opts, scale, nbatch)``, as the
reference caches its ``custom_vjp`` instances (a ``Mesh`` hashes by
identity; a meshless plan's mesh is None); ``Croft3D.release`` clears
them.  The primal is unchanged: without grad (grad mode off, or no
input requiring it) each plan runs exactly the ops the entry points ran
before, the filtered ones fused.

Collectives in the backward pass.  The backward runs every collective of
the adjoint schedule, so **every rank must call** ``backward()`` on a
loss that depends on its block: a rank that skips it leaves the others
waiting in their collectives.  On the card the backward runs on
autograd's device thread; the gloo host staging and the pending handles
of ``core/mesh.py`` work from there.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import schedule as schedule_lib
from repro_torch.core.schedule import normalize
from repro_torch.grad.adjoint import (adjoint_schedule, fold_dc_plane_t,
                                      unfold_dc_plane_t)


def needs_grad(*ts) -> bool:
    """Whether autograd will want a backward from these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def conj(t: torch.Tensor) -> torch.Tensor:
    """The conjugate in memory (a real tensor is its own)."""
    return torch.conj_physical(t) if t.is_complex() else t


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum the broadcast dims of a gradient back to ``shape``."""
    if tuple(t.shape) == tuple(shape):
        return t
    lead = t.ndim - len(shape)
    t = t.sum(dim=tuple(range(lead))) if lead else t
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


class Linear(torch.autograd.Function):
    """``y = plan.run(x)`` with ``x.grad = plan.adjoint(g)`` (``A^H g``)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        ctx.real_in = not x.is_complex()
        return plan.run(x)

    @staticmethod
    def backward(ctx, g):
        gx = ctx.plan.adjoint(g.contiguous())
        if ctx.real_in and gx.is_complex():
            gx = gx.real
        return gx, None


class _Plan:
    """A linear map with ``run`` (the primal) and ``adjoint`` (``A^H``);
    calling it runs the primal, through :class:`Linear` under grad."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if needs_grad(x):
            return Linear.apply(x, self)
        return self.run(x)


class SpectralScale(torch.autograd.Function):
    """``y = alpha * s * h`` (``kernels/spectral_scale.py``): the
    cotangents ``alpha * g * conj(h)`` and ``alpha * g * conj(s)`` go
    through the same kernel (full-shape complex64) or expression."""

    @staticmethod
    def forward(ctx, s, h, alpha):
        from repro_torch.kernels import spectral_scale as ss
        ctx.save_for_backward(s, h)
        ctx.alpha = alpha
        return ss.spectral_scale(s, h, alpha)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import spectral_scale as ss
        s, h = ctx.saved_tensors
        g = g.contiguous()
        gs = gh = None
        if ctx.needs_input_grad[0]:
            gs = _sum_to(ss.spectral_scale(g, h.conj(), ctx.alpha), s.shape)
            gs = gs if s.is_complex() else gs.real
        if ctx.needs_input_grad[1]:
            gh = _sum_to(ss.spectral_scale(g, s.conj(), ctx.alpha), h.shape)
            gh = gh if h.is_complex() else gh.real
        return gs, gh, None


def spectral_scale(s: torch.Tensor, h: torch.Tensor,
                   alpha: float = 1.0) -> torch.Tensor:
    """The k-space multiply, differentiable in ``s`` and ``h``; the plain
    kernel dispatch when neither needs a gradient."""
    if needs_grad(s, h):
        return SpectralScale.apply(s, h, alpha)
    from repro_torch.kernels import spectral_scale as ss
    return ss.spectral_scale(s, h, alpha)


class PoissonScale(torch.autograd.Function):
    """``y = alpha * s * h`` with the Poisson multiplier ``h = -1/k²``
    computed in the multiply from the wavenumber vectors
    (``kernels/spectral_scale.py:poisson_scale``).  ``h`` is real, so the
    cotangent ``alpha * g * conj(h)`` is the same multiply of ``g``."""

    @staticmethod
    def forward(ctx, s, kx, ky, kz, alpha):
        from repro_torch.kernels import spectral_scale as ss
        ctx.save_for_backward(kx, ky, kz)
        ctx.alpha = alpha
        return ss.poisson_scale(s, kx, ky, kz, alpha)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import spectral_scale as ss
        return (ss.poisson_scale(g, *ctx.saved_tensors, ctx.alpha),
                None, None, None, None)


def poisson_scale(s: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                  kz: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """The Poisson multiply, differentiable in ``s``; the plain kernel
    dispatch when ``s`` needs no gradient."""
    if needs_grad(s):
        return PoissonScale.apply(s, kx, ky, kz, alpha)
    from repro_torch.kernels import spectral_scale as ss
    return ss.poisson_scale(s, kx, ky, kz, alpha)


# ---------------------------------------------------------------------------
# complex transform (every c2c plan, meshless included): y = scale * F x
# ---------------------------------------------------------------------------

def _pure_complex(sched: schedule_lib.Schedule) -> bool:
    return not (any(st.prologue or st.epilogue for st in sched.stages)
                or sched.epilogue or sched.extra_comms)


class LinearPlan(_Plan):
    """A schedule and its adjoint.  ``run`` is the forward (the ops of the
    pre-grad path, so primal results are unchanged); ``adjoint`` runs the
    transposed schedule under the same options."""

    def __init__(self, mesh, sched: schedule_lib.Schedule, opts, scale,
                 nbatch: int):
        self.mesh, self.opts, self.scale = mesh, opts, scale
        self.schedule = sched
        self.adjoint_schedule = adjoint_schedule(sched)
        self._flipped = None
        if _pure_complex(sched):
            from repro_torch.core.distributed import inverse_schedule
            self._flipped = inverse_schedule(sched)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        return normalize(schedule_lib.run_schedule(
            x, self.schedule, self.opts, self.mesh), self.scale)

    def adjoint(self, g: torch.Tensor) -> torch.Tensor:
        if self._flipped is not None:
            return normalize(schedule_lib.run_schedule(
                g, self._flipped, self.opts, self.mesh), self.scale)
        return conj(normalize(schedule_lib.run_schedule(
            conj(g), self.adjoint_schedule, self.opts, self.mesh), self.scale))


@functools.lru_cache(maxsize=512)
def linear_plan(mesh, sched: schedule_lib.Schedule, opts, scale,
                nbatch: int = 0) -> LinearPlan:
    return LinearPlan(mesh, sched, opts, scale, nbatch)


class FilteredPlan:
    """``(x, h) -> scale * (h * F x)``, differentiable in both.

    The primal keeps the fused in-schedule epilogue (``SpectralScale``
    as a terminal schedule op: no extra pass over the spectrum).  Under
    grad the forward runs unfused so the spectrum ``s = scale * F x`` is
    saved: ``x.grad = A^H(g * conj(h))``, ``h.grad = g * conj(s)``."""

    def __init__(self, mesh, sched, opts, scale, nbatch: int):
        self.linear = linear_plan(mesh, sched, opts, scale, nbatch)
        self.fused = sched.with_epilogue(schedule_lib.SpectralScale())

    def __call__(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        lin = self.linear
        if needs_grad(x, h):
            return spectral_scale(lin(x), h)
        return normalize(schedule_lib.run_schedule(
            x, self.fused, lin.opts, lin.mesh, {"filter": h}), lin.scale)


@functools.lru_cache(maxsize=512)
def filtered_plan(mesh, sched: schedule_lib.Schedule, opts, scale,
                  nbatch: int = 0) -> FilteredPlan:
    return FilteredPlan(mesh, sched, opts, scale, nbatch)


# ---------------------------------------------------------------------------
# packed real transforms (the r2c/c2r pipelines of repro_torch.real.pipeline)
# ---------------------------------------------------------------------------

class _Packed:
    """What the packed plans share: the schedule, its adjoint, the body's
    (natural) and the spectrum's (spectral) specs, and the DC/Nyquist
    plane gather of a block of the grid."""

    def __init__(self, mesh, decomp, opts, scale, sched):
        self.mesh, self.decomp, self.opts, self.scale = (mesh, decomp, opts,
                                                         scale)
        self.schedule = sched
        self.adjoint_schedule = adjoint_schedule(sched)
        self.spect = decomp.spectral_spec()

    def _grid(self, blk: torch.Tensor) -> tuple:
        from repro_torch.real import pipeline
        return pipeline.global_grid(blk, self.mesh, self.decomp)

    def _planes(self, shape):
        from repro_torch.real import pipeline
        return pipeline.plane_access(self.mesh, self.decomp, shape)

    def _run(self, blk, sched, operands=None):
        return schedule_lib.run_schedule(blk, sched, self.opts, self.mesh,
                                         operands)


class PackedRfftPlan(_Packed, _Plan):
    """Linear core of ``packed_rfft3d``: real x -> rfftn-style spectrum.

    Forward: packed body -> z-localizing reshard -> DC/Nyquist plane
    unfold -> norm scale.  Backward (the transpose, right to left):
    scale -> plane-unfold transpose -> reshard -> adjoint body, ending in
    the transposed pack (a real gradient, matching the real input)."""

    def __init__(self, mesh, decomp, opts, scale):
        from repro_torch.real import pipeline
        super().__init__(mesh, decomp, opts, scale,
                         pipeline.build_packed_forward(decomp))
        self.nat = self.schedule.layout_out.partition_spec()

    def body(self, x: torch.Tensor, hp=None) -> torch.Tensor:
        """The packed body, in the natural layout; ``hp`` (the packed
        filter in that layout) rides as the fused epilogue."""
        if hp is None:
            return self._run(x, self.schedule)
        return self._run(x, self.schedule.with_epilogue(
            schedule_lib.SpectralScale()), {"filter": hp})

    def finish(self, body: torch.Tensor, shape) -> torch.Tensor:
        """Body -> z-localizing reshard -> plane unfold -> scale."""
        from repro_torch.real import pipeline
        gather, sl = self._planes(shape)
        packed = self.mesh.reshard(body, shape[:2] + (shape[2] // 2,),
                                   self.nat, self.spect)
        return normalize(pipeline.unfold_dc_plane(packed, gather, sl),
                         self.scale)

    def finish_t(self, g: torch.Tensor) -> torch.Tensor:
        """The unconjugated transpose of :meth:`finish` on ``conj(g)``:
        the body-layout cotangent."""
        nx, ny, nh = self._grid(g)
        shape = (nx, ny, 2 * (nh - 1))
        gather, sl = self._planes(shape)
        ctp = unfold_dc_plane_t(normalize(conj(g), self.scale), gather, sl)
        return self.mesh.reshard(ctp.contiguous(), (nx, ny, nh - 1),
                                 self.spect, self.nat)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.body(x), self._grid(x))

    def adjoint(self, g: torch.Tensor) -> torch.Tensor:
        return conj(self._run(self.finish_t(g), self.adjoint_schedule))


@functools.lru_cache(maxsize=512)
def packed_rfft_plan(mesh, decomp, opts, scale,
                     nbatch: int = 0) -> PackedRfftPlan:
    return PackedRfftPlan(mesh, decomp, opts, scale)


class _Folded(torch.autograd.Function):
    """``(x, hp) -> scale * unfold(hp * body(x))`` under grad: the body
    unfused, its output saved for the filter's gradient."""

    @staticmethod
    def forward(ctx, x, hp, plan):
        from repro_torch.kernels import spectral_scale as ss
        b = plan.body(x)
        ctx.save_for_backward(b, hp)
        ctx.plan = plan
        return plan.finish(ss.spectral_scale(b, hp), plan._grid(x))

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import spectral_scale as ss
        b, hp = ctx.saved_tensors
        plan = ctx.plan
        ctu = plan.finish_t(g.contiguous())
        gx = gh = None
        if ctx.needs_input_grad[0]:
            gx = conj(plan._run(ss.spectral_scale(ctu, hp),
                                plan.adjoint_schedule))
        if ctx.needs_input_grad[1]:
            gh = _sum_to(conj(ss.spectral_scale(ctu, b)), hp.shape)
        return gx, gh, None


class PackedRfftFoldedPlan:
    """Folded-epilogue variant: ``(x, hp) -> scale * unfold(hp *
    body(x))``, ``hp`` the packed half-spectrum filter in the body's
    (natural) layout.

    The filter rides the packed half spectrum *before* the plane unfold
    (one fused in-schedule multiply on Nz/2 bins), valid when
    ``h(kz=0) == h(kz=Nyquist)`` and that plane is 2-D Hermitian.  The
    gradient is the gradient of this implemented map: ``hp.grad =
    conj(unfoldT(conj g) * body(x))``."""

    def __init__(self, mesh, decomp, opts, scale):
        self.plan = PackedRfftPlan(mesh, decomp, opts, scale)

    def __call__(self, x: torch.Tensor, hp: torch.Tensor) -> torch.Tensor:
        if needs_grad(x, hp):
            return _Folded.apply(x, hp, self.plan)
        return self.plan.finish(self.plan.body(x, hp), self.plan._grid(x))


@functools.lru_cache(maxsize=512)
def packed_rfft_folded_plan(mesh, decomp, opts, scale, nbatch: int = 0,
                            h_nbatch: int = 0) -> PackedRfftFoldedPlan:
    return PackedRfftFoldedPlan(mesh, decomp, opts, scale)


class PackedIrfftPlan(_Packed, _Plan):
    """Linear core of ``packed_irfft3d``: rfftn-style spectrum -> real x.

    Forward: DC/Nyquist plane fold -> reshard to the natural layout ->
    packed inverse body -> norm scale.  Backward: scale -> adjoint body
    -> reshard -> plane-fold transpose."""

    def __init__(self, mesh, decomp, nz: int, opts, scale):
        from repro_torch.real import pipeline
        super().__init__(mesh, decomp, opts, scale,
                         pipeline.build_packed_inverse(decomp, nz))
        self.nz = nz
        self.nat = self.schedule.layout_in.partition_spec()

    def run(self, y: torch.Tensor) -> torch.Tensor:
        from repro_torch.real import pipeline
        nx, ny = self._grid(y)[:2]
        shape = (nx, ny, self.nz)
        gather, sl = self._planes(shape)
        packed = pipeline.fold_dc_plane(y, self.nz, gather, sl)
        body_in = self.mesh.reshard(packed.contiguous(),
                                    (nx, ny, self.nz // 2), self.spect,
                                    self.nat)
        return normalize(self._run(body_in, self.schedule), self.scale)

    def adjoint(self, g: torch.Tensor) -> torch.Tensor:
        shape = self._grid(g)
        gather, sl = self._planes(shape)
        pbar = self._run(normalize(conj(g), self.scale),
                         self.adjoint_schedule)
        pbar = self.mesh.reshard(pbar, shape[:2] + (self.nz // 2,), self.nat,
                                 self.spect)
        return conj(fold_dc_plane_t(pbar, self.nz, gather, sl))


@functools.lru_cache(maxsize=512)
def packed_irfft_plan(mesh, decomp, nz: int, opts, scale,
                      nbatch: int = 0) -> PackedIrfftPlan:
    return PackedIrfftPlan(mesh, decomp, nz, opts, scale)


_CACHES = (linear_plan, filtered_plan, packed_rfft_plan,
           packed_rfft_folded_plan, packed_irfft_plan)


def clear_plans() -> None:
    """Drop every cached plan (and the meshes they hold)."""
    for cache in _CACHES:
        cache.cache_clear()
