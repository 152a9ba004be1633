"""Adjoint schedules: the pure ``Schedule -> Schedule`` transpose.

Port of ``repro/grad/adjoint.py``.  The backward pass of a distributed
FFT is the same scheduled machinery run in reverse.  Because every
pipeline is data (``repro_torch.core.schedule``), the adjoint is a
mechanical walk over the stage list:

  * stage order reverses;
  * each global transpose swaps its split/concat axes (the transpose of
    a tiled all-to-all is the all-to-all that undoes it, over the same
    communicator, K-chunked along the same uninvolved axis);
  * each local FFT keeps its axis *and its sign*: this is the
    unconjugated linear transpose ``A^T`` (the reference's convention),
    and the DFT matrix is symmetric, so the transpose of an unnormalized
    FFT with sign s is the unnormalized FFT with the same sign s;
  * each packed-real stage op maps to its explicit transpose (the folded
    two-for-one unpack weights DC/Nyquist bins differently from interior
    bins, so its transpose is *not* a scaled inverse — see the ``*T``
    ops below);
  * terminal epilogue ops (the fused k-space multiply) transpose into
    leading prologue ops — ``x -> h * x`` is its own unconjugated
    transpose.

PyTorch's autograd wants ``A^H``, not ``A^T``: ``repro_torch.grad.vjp``
conjugates at the boundary of each plan, so the schedules here stay
byte-equal to the reference's (``describe()`` goldens included).

The result is an ordinary :class:`~repro_torch.core.schedule.Schedule`:
layout propagation runs at construction, so a malformed adjoint fails at
build time, and :func:`adjoint_schedule` also checks that the output
layout equals the forward input layout.

The transposes of the packed pipeline's DC/Nyquist plane fold/unfold
(``real.pipeline.unfold_dc_plane`` / ``fold_dc_plane``) live here too:
they run outside any schedule, on a mesh through the pipeline's own
plane gather.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.schedule import (DIMS, PackTwo, RepackHalves, Schedule,
                                       ScheduleError, SpectralScale,
                                       SplitPairs, Stage, StageOp, UnpackTwo)


# ---------------------------------------------------------------------------
# transposed packed-real stage ops.  Each ``FooT`` is the unconjugated
# linear transpose of ``Foo``: T(complex(a,b))(ct) = (Re ct, -Im ct),
# T(real)(t) = complex(t, 0), T(imag)(t) = -i*t, T(conj) = conj,
# T(c * .) = c * . (unconjugated), T(permutation) = inverse permutation.
# The free functions take absolute axes (the meshless path uses them too).
# ---------------------------------------------------------------------------

def pack_two_t(ct: torch.Tensor, ax: int) -> torch.Tensor:
    """Transpose of ``packing.pack_two``: ``concat(Re ct, -Im ct)``."""
    return torch.cat([ct.real, -ct.imag], dim=ax)


def split_pairs_t(ct: torch.Tensor, ax: int) -> torch.Tensor:
    """Transpose of ``packing.split_pairs``: halves (u, v) ->
    ``complex(u, -v)``."""
    m = ct.shape[ax]
    return torch.complex(ct.narrow(ax, 0, m // 2),
                         -ct.narrow(ax, m // 2, m - m // 2))


def _pad_bins(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros(t.shape[:-1] + (n - t.shape[-1],))], -1)


def _negate_last(t: torch.Tensor) -> torch.Tensor:
    return torch.roll(torch.flip(t, [-1]), 1, -1)


def unpack_two_t(ct: torch.Tensor, ax: int, n: int,
                 fold: bool = True) -> torch.Tensor:
    """Transpose of ``packing.unpack_two``: the cotangent of the two half
    spectra, halves (a, b) along ``ax`` -> that of the n-bin packed
    spectrum.

    fold=True (n even, ``nz2 = n // 2`` bins each)::

      Ct[0]     = complex( Re a[0], -Re b[0])
      Ct[nz2]   = complex(-Im a[0],  Im b[0])
      Ct[k]     = (a[k] - i b[k]) / 2                    k = 1..nz2-1
      Ct[n - k] = conj(a[k] + i b[k]) / 2                k = 1..nz2-1

    fold=False (n // 2 + 1 bins each, any n): with a, b zero-padded to n
    bins, ``Ct = (a + conj(a[-k]))/2 - i (b + conj(b[-k]))/2``.
    """
    m = ct.shape[ax]
    a = ct.narrow(ax, 0, m // 2)
    b = ct.narrow(ax, m // 2, m - m // 2)
    if not fold:
        pa, pb = _pad_bins(a, n), _pad_bins(b, n)
        return (0.5 * (pa + torch.conj(_negate_last(pa)))
                - 0.5j * (pb + torch.conj(_negate_last(pb))))
    a0, b0 = a[..., 0], b[..., 0]
    c0 = torch.complex(a0.real, -b0.real)
    cn = torch.complex(-a0.imag, b0.imag)
    ak, bk = a[..., 1:], b[..., 1:]
    body = 0.5 * (ak - 1j * bk)
    tail = torch.flip(0.5 * torch.conj(ak + 1j * bk), [-1])
    return torch.cat([c0[..., None], body, cn[..., None], tail], dim=-1)


def repack_halves_t(ct: torch.Tensor, ax: int, nh: int,
                    fold: bool = True) -> torch.Tensor:
    """Transpose of ``packing.repack_halves``: the cotangent of the full
    packed spectrum (n bins) -> that of the halves (a, b), stacked along
    ``ax``.

    fold=True (``nz2 = n // 2`` bins each; ``nh`` unused)::

      a[0] = complex( Re Ct[0], -Re Ct[nz2])
      b[0] = complex(-Im Ct[0],  Im Ct[nz2])
      a[k] =     Ct[k] + conj(Ct[n - k])                 k = 1..nz2-1
      b[k] = i * (Ct[k] - conj(Ct[n - k]))               k = 1..nz2-1

    fold=False (``nh`` bins each): bin 0 and, for even n with
    ``nh == n // 2 + 1``, the Nyquist bin take ``(Re Ct, -Im Ct)``; the
    body ``(Ct[k], i Ct[k])`` plus the mirrored tail
    ``(conj Ct[n-k], -i conj Ct[n-k])``.
    """
    n = ct.shape[-1]
    if fold:
        nz2 = n // 2
        c0, cn = ct[..., 0], ct[..., nz2]
        a0 = torch.complex(c0.real, -cn.real)
        b0 = torch.complex(-c0.imag, cn.imag)
        body = ct[..., 1:nz2]
        tail = torch.conj(torch.flip(ct[..., nz2 + 1:], [-1]))
        A = torch.cat([a0[..., None], body + tail], dim=-1)
        B = torch.cat([b0[..., None], 1j * (body - tail)], dim=-1)
        return torch.cat([A, B], dim=ax)
    has_nyq = n % 2 == 0 and nh - 1 == n // 2
    body_hi = nh - 1 if has_nyq else nh
    edge = [ct[..., :1]] + ([ct[..., n // 2:n // 2 + 1]] if has_nyq else [])
    a_edge = [torch.complex(e.real, torch.zeros_like(e.real)) for e in edge]
    b_edge = [torch.complex(-e.imag, torch.zeros_like(e.imag)) for e in edge]
    body = ct[..., 1:body_hi]
    tail = torch.conj(torch.flip(ct[..., nh:], [-1]))   # Ct[n - k], k = 1..
    A = torch.cat([a_edge[0], body + tail] + a_edge[1:], dim=-1)
    B = torch.cat([b_edge[0], 1j * body - 1j * tail] + b_edge[1:], dim=-1)
    return torch.cat([A, B], dim=ax)


@dataclasses.dataclass(frozen=True)
class PackTwoT(StageOp):
    """Transpose of :class:`PackTwo`: complex cotangent -> real block,
    ``concat(Re ct, -Im ct)`` along the pair axis."""

    pair_axis: int

    def apply(self, blk, opts, ctx, off):
        return pack_two_t(blk, self.pair_axis + off)

    def transform(self, layout):
        if layout.real:
            raise ScheduleError("pack2T needs a complex cotangent")
        return dataclasses.replace(
            layout.with_den(self.pair_axis, div=2), real=True)

    def describe(self):
        return f"pack2T[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class SplitPairsT(StageOp):
    """Transpose of :class:`SplitPairs`: real cotangent halves (u, v)
    along the pair axis -> ``complex(u, -v)``."""

    pair_axis: int

    def apply(self, blk, opts, ctx, off):
        return split_pairs_t(blk, self.pair_axis + off)

    def transform(self, layout):
        if not layout.real:
            raise ScheduleError("split2T needs a real cotangent")
        return dataclasses.replace(
            layout.with_den(self.pair_axis, mul=2), real=False)

    def describe(self):
        return f"split2T[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class UnpackTwoT(StageOp):
    """Transpose of the folded :class:`UnpackTwo` (:func:`unpack_two_t`):
    per-bin rules, NOT a scaled repack."""

    pair_axis: int
    z_axis: int = 2
    impl_stage: int = 0

    def apply(self, blk, opts, ctx, off):
        m = blk.shape[-1]
        return unpack_two_t(blk, self.pair_axis + off, 2 * m)

    def transform(self, layout):
        return layout.with_den(self.pair_axis, mul=2).with_den(
            self.z_axis, div=2)

    def describe(self):
        return f"unpack2T[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class RepackHalvesT(StageOp):
    """Transpose of the folded :class:`RepackHalves`
    (:func:`repack_halves_t`)."""

    pair_axis: int
    nz: int
    z_axis: int = 2
    impl_stage: int = 2

    def apply(self, blk, opts, ctx, off):
        return repack_halves_t(blk, self.pair_axis + off, self.nz // 2)

    def transform(self, layout):
        return layout.with_den(self.pair_axis, div=2).with_den(
            self.z_axis, mul=2)

    def describe(self):
        return f"repack2T[{DIMS[self.pair_axis]}]"


def adjoint_ops(op: StageOp) -> tuple:
    """The transpose of one stage op (a tuple, spliced in adjoint order)."""
    if isinstance(op, PackTwo):
        return (PackTwoT(op.pair_axis),)
    if isinstance(op, SplitPairs):
        return (SplitPairsT(op.pair_axis),)
    if isinstance(op, UnpackTwo):
        return (UnpackTwoT(op.pair_axis, op.z_axis, op.impl_stage),)
    if isinstance(op, RepackHalves):
        return (RepackHalvesT(op.pair_axis, op.nz, op.z_axis, op.impl_stage),)
    if isinstance(op, SpectralScale):
        return (op,)  # x -> alpha * h * x is its own transpose (no conj)
    if isinstance(op, PackTwoT):
        return (PackTwo(op.pair_axis),)
    if isinstance(op, SplitPairsT):
        return (SplitPairs(op.pair_axis),)
    if isinstance(op, UnpackTwoT):
        return (UnpackTwo(op.pair_axis, op.z_axis, op.impl_stage),)
    if isinstance(op, RepackHalvesT):
        return (RepackHalves(op.pair_axis, op.nz, op.z_axis, op.impl_stage),)
    raise ScheduleError(f"no adjoint rule for stage op {op.describe()}")


# ---------------------------------------------------------------------------
# the Schedule -> Schedule transform
# ---------------------------------------------------------------------------

def _renum(op: StageOp, k: int) -> StageOp:
    """Retarget an op's per-stage impl selector at its adjoint slot."""
    if hasattr(op, "impl_stage"):
        return dataclasses.replace(op, impl_stage=k)
    return op


def _chunk_hazards(unit: dict) -> set:
    """Axes a stage with this compute unit must NOT be K-chunked along.

    The executor chunks the whole prologue->fft->epilogue chain, so the
    chunk axis may not be the FFT axis, nor an axis a pack-family op
    slices/concatenates (its pair axis, and the z spectrum axis for the
    folded unpack/repack pair).  A fused k-space multiply consumes a
    full-block operand, so a stage carrying one is never chunkable.
    """
    hz = set()
    if unit["fft_axis"] is not None:
        hz.add(unit["fft_axis"])
    for op in unit["prologue"] + unit["epilogue"]:
        if isinstance(op, SpectralScale):
            hz |= {0, 1, 2}
        if hasattr(op, "pair_axis"):
            hz.add(op.pair_axis)
        if hasattr(op, "z_axis"):
            hz.add(op.z_axis)
    return hz


def adjoint_schedule(sched: Schedule) -> Schedule:
    """The linear transpose of ``sched`` as a first-class schedule.

    Maps cotangents of the forward *output* layout to cotangents of the
    forward *input* layout, reusing the forward plan's communicators,
    chunk axes and (renumbered) per-stage impl choices.  Raises
    :class:`ScheduleError` if the transposed pipeline fails layout
    propagation or does not land back on the forward input layout.
    """
    # compute unit of one forward stage, transposed: the stage chain is
    # prologue -> fft -> epilogue, so its transpose runs the transposed
    # epilogue ops (reversed) -> the same-sign fft -> the transposed
    # prologue ops (reversed).
    def compute_t(st: Stage):
        pro = []
        for op in reversed(st.epilogue):
            pro.extend(adjoint_ops(op))
        epi = []
        for op in reversed(st.prologue):
            epi.extend(adjoint_ops(op))
        if st.fft_axis is None and not pro and not epi:
            return None
        return dict(name=f"adj-{st.name}", fft_axis=st.fft_axis,
                    prologue=tuple(pro), epilogue=tuple(epi))

    def comm_t(st: Stage) -> dict:
        # transposed tiled all-to-all: same communicator, split<->concat
        # swapped; the chunk axis is uninvolved in {split, concat} (an
        # unchanged set), so it stays valid for the adjoint's K-chunking.
        # Per-stage impl/K overrides ride along: the adjoint of a ring
        # stage is a ring stage over the same wire.
        return dict(comm_axis=st.comm_axis, split_axis=st.concat_axis,
                    concat_axis=st.split_axis, chunk_axis=st.chunk_axis,
                    transpose_impl=st.transpose_impl, overlap_k=st.overlap_k)

    stages = []
    # the terminal epilogue transposes into ops that run FIRST
    lead = []
    for op in reversed(sched.epilogue):
        lead.extend(adjoint_ops(op))
    pending = (dict(name="adj-epilogue", fft_axis=None,
                    prologue=tuple(lead), epilogue=())
               if lead else None)
    for st in reversed(sched.stages):
        if st.comm_axis is not None:
            # this stage's transposed comm executes before its transposed
            # compute: it terminates whatever compute is pending — unless
            # the forced chunk axis is hazardous for that compute, in
            # which case the compute flushes separately and the comm
            # rides alone
            if pending is not None and st.chunk_axis in _chunk_hazards(pending):
                stages.append(Stage(**pending))
                pending = None
            base = pending or dict(name=f"adj-comm-{st.name}", fft_axis=None,
                                   prologue=(), epilogue=())
            stages.append(Stage(**base, **comm_t(st)))
            pending = None
        unit = compute_t(st)
        if unit is not None:
            if pending is not None:
                stages.append(Stage(**pending))
            pending = unit
    if pending is not None:
        stages.append(Stage(**pending))

    # renumber fft stages 0..2 in adjoint execution order so per-stage
    # local_impl / overlap_mode tuples index naturally
    out, k = [], 0
    for st in stages:
        if st.fft_axis is not None:
            st = dataclasses.replace(
                st, impl_stage=k,
                prologue=tuple(_renum(op, k) for op in st.prologue),
                epilogue=tuple(_renum(op, k) for op in st.epilogue))
            k += 1
        out.append(st)

    extra = tuple(dataclasses.replace(ec, name=f"adj-{ec.name}")
                  for ec in sched.extra_comms)
    adj = Schedule(f"{sched.name}^T", sched.sign, sched.layout_out,
                   tuple(out), extra_comms=extra)
    if str(adj.layout_out) != str(sched.layout_in):
        raise ScheduleError(
            f"adjoint of {sched.name} does not restore the input layout: "
            f"{adj.layout_out} != {sched.layout_in}")
    return adj


# ---------------------------------------------------------------------------
# out-of-body plane transposes (packed pipeline's DC/Nyquist fold/unfold).
# ``gather``/``sl`` as in ``real.pipeline``: None on one device; on a mesh
# the plane gather of the pipeline's own ``plane_access`` and this rank's
# (x, y) slice.
# ---------------------------------------------------------------------------

def _reversed(p: torch.Tensor, gather=None, sl=None) -> torch.Tensor:
    from repro_torch.real.pipeline import reversed_plane
    return reversed_plane(p, gather, sl)


def unfold_dc_plane_t(ct: torch.Tensor, gather=None, sl=None) -> torch.Tensor:
    """Transpose of ``real.pipeline.unfold_dc_plane``: rfftn-shaped
    cotangent (..., Nz2 + 1) -> packed cotangent (..., Nz2) with bin 0 =
    Herm2(ct[0]) - i * Herm2(ct[Nz2]); Herm2(p) = (p + conj(p[-kx,
    -ky])) / 2 is self-transpose.  Both planes share one gather."""
    nz2 = ct.shape[-1] - 1
    both = torch.stack([ct[..., 0], ct[..., nz2]], -3)
    h0, hn = (0.5 * (both + _reversed(both, gather, sl))).unbind(-3)
    g = h0 - 1j * hn
    return torch.cat([g[..., None], ct[..., 1:nz2]], dim=-1)


def fold_dc_plane_t(pbar: torch.Tensor, nz: int, gather=None,
                    sl=None) -> torch.Tensor:
    """Transpose of ``real.pipeline.fold_dc_plane``: packed cotangent
    (..., Nz2) -> rfftn-shaped cotangent (..., Nz2 + 1)."""
    p0 = pbar[..., 0]
    rev = _reversed(p0, gather, sl)
    y0 = 0.5 * (p0 + rev)
    yn = 0.5j * (p0 - rev)
    return torch.cat([y0[..., None], pbar[..., 1:], yn[..., None]], dim=-1)
