"""Stage-schedule IR: one declarative representation of the FFT pipeline.

Port of ``repro/core/schedule.py``.  The paper's pipeline (§4.1 steps
1-9, overlapped via K chunks) is *data*:

  ``Stage``      one pipeline step: optional prologue ops, an optional
                 local 1-D FFT, optional epilogue ops and an optional
                 global transpose over one communicator, K-chunked along
                 an uninvolved axis for overlap.
  ``Layout``     symbolic local-block layout: which mesh axes shard each
                 grid dimension, static divisors (the packed half
                 spectrum) and the real/complex dtype class.  Schedules
                 propagate layouts through every stage at build time, so
                 malformed pipelines fail before they run.
  ``Schedule``   an ordered stage list + terminal epilogue ops (the fused
                 k-space multiply, ``with_epilogue``) + metadata for
                 collectives outside the stage list (the packed
                 pipeline's z-localizing reshard).
  ``run_schedule``  the single executor: owns K-chunked overlap, the
                 chunk-indivisible fallback (``effective_k``), per-stage
                 ``local_impl`` selection, and batch-axis offsetting.
  ``norm_factor`` / ``normalize``  the one normalization rule and the
                 one scaled pass (``inverse:normalize``) every plan
                 applies to the executor's output.

:func:`build_c2c` covers every complex pipeline (pencil / slab / cell,
natural / spectral, forward / from-spectral) and :func:`build_local_c2c`
the single-device one; ``describe()`` renders the same text as the
reference, so both are held to the same goldens;
``repro_torch.real.pipeline`` builds the packed two-for-one real
pipelines on the same IR with the stage ops below.  The executor runs
every decomposition: the cell regroup and a folded mesh axis transpose
over the folded axis's own process group (``Mesh.group``), with the
fused all-to-all only — ring and pairwise stay single-axis, as
``Decomposition.validate`` says.  ``repro_torch.grad.adjoint`` turns any
schedule into its transpose, which this executor runs as the backward
pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import local_fft
from repro_torch.core.mesh import Pending
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.tracer import span
from repro_torch.resil import inject as inject_lib

AxisName = Union[str, tuple]

DIMS = ("x", "y", "z")


class ScheduleError(ValueError):
    """A builder produced an inconsistent pipeline (caught at build time)."""


def flat_axes(axis) -> tuple:
    """Flatten a (possibly nested-folded) mesh axis spec to bare names."""
    if isinstance(axis, tuple):
        out = []
        for a in axis:
            out.extend(flat_axes(a))
        return tuple(out)
    return (axis,)


def _axis_str(axis: AxisName) -> str:
    return "+".join(flat_axes(axis))


# ---------------------------------------------------------------------------
# symbolic layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayoutAxis:
    """One grid dimension of a local block.

    local extent = shape[dim] / prod(mesh axis sizes of ``shards``) / den
    """

    dim: str                      # "x" | "y" | "z"
    shards: tuple = ()            # flat mesh-axis names sharding this dim
    den: int = 1

    def local_extent(self, n: int, sizes) -> int:
        return n // math.prod(sizes[s] for s in self.shards) // self.den

    def __str__(self) -> str:
        s = f"N{self.dim}"
        if self.den != 1:
            s += f":{self.den}"
        for name in self.shards:
            s += f"/{name}"
        return s


@dataclasses.dataclass(frozen=True)
class Layout:
    """Symbolic local-block layout (three grid dims + dtype class)."""

    axes: tuple                   # (LayoutAxis, LayoutAxis, LayoutAxis)
    real: bool = False

    def local_shape(self, shape: Sequence[int], axis_sizes) -> tuple:
        sizes = dict(axis_sizes)
        return tuple(a.local_extent(n, sizes)
                     for a, n in zip(self.axes, shape[-3:]))

    def global_shape(self, local_shape: Sequence[int], axis_sizes) -> tuple:
        """Inverse of :meth:`local_shape` (the grid a local block is a
        shard of)."""
        sizes = dict(axis_sizes)
        return tuple(n * math.prod(sizes[s] for s in a.shards) * a.den
                     for a, n in zip(self.axes, local_shape[-3:]))

    def elems(self, shape: Sequence[int], axis_sizes) -> int:
        return math.prod(self.local_shape(shape, axis_sizes))

    def bytes(self, shape: Sequence[int], axis_sizes,
              complex_itemsize: int = 8) -> int:
        item = complex_itemsize // 2 if self.real else complex_itemsize
        return self.elems(shape, axis_sizes) * item

    def partition_spec(self) -> tuple:
        """The spec tuple (see ``decomposition.spec_slices``)."""
        entries = []
        for a in self.axes:
            if not a.shards:
                entries.append(None)
            elif len(a.shards) == 1:
                entries.append(a.shards[0])
            else:
                entries.append(tuple(a.shards))
        return tuple(entries)

    # -- transforms used by the schedule propagation ------------------------
    def after_all_to_all(self, comm_axis: AxisName, split_axis: int,
                         concat_axis: int) -> "Layout":
        """The concat dim loses the communicator's shards (its local extent
        grows), the split dim gains them — a global transpose."""
        names = flat_axes(comm_axis)
        axes = list(self.axes)
        cat = axes[concat_axis]
        missing = [n for n in names if n not in cat.shards]
        if missing:
            raise ScheduleError(
                f"all_to_all over {names} concatenates dim {cat.dim!r} which "
                f"is not sharded by {missing} (layout {self})")
        axes[concat_axis] = dataclasses.replace(
            cat, shards=tuple(s for s in cat.shards if s not in names))
        spl = axes[split_axis]
        axes[split_axis] = dataclasses.replace(spl, shards=spl.shards + names)
        return dataclasses.replace(self, axes=tuple(axes))

    def with_den(self, axis: int, mul: int = 1, div: int = 1) -> "Layout":
        axes = list(self.axes)
        a = axes[axis]
        den = a.den * mul
        if den % div:
            raise ScheduleError(f"cannot divide den={den} of {a} by {div}")
        axes[axis] = dataclasses.replace(a, den=den // div)
        return dataclasses.replace(self, axes=tuple(axes))

    def check_fft_axis(self, axis: int) -> None:
        a = self.axes[axis]
        if a.shards:
            raise ScheduleError(
                f"FFT along dim {a.dim!r} while it is sharded by {a.shards} "
                f"(layout {self})")

    def __str__(self) -> str:
        tag = "R" if self.real else "C"
        return tag + "(" + ", ".join(str(a) for a in self.axes) + ")"


def layout_for(decomp, which: str = "natural", real: bool = False) -> Layout:
    """The :class:`Layout` of a decomposition's natural/spectral spec."""
    axes = tuple(
        LayoutAxis(dim, () if entry is None else flat_axes(entry))
        for dim, entry in zip(DIMS, decomp.spec(which)))
    return Layout(axes, real=real)


# ---------------------------------------------------------------------------
# stage ops (prologue/epilogue): declarative, layout-aware
# ---------------------------------------------------------------------------

class StageOp:
    """Protocol for prologue/epilogue ops.

    ``apply`` runs inside the executor (per K-chunk for chunked stages);
    ``transform`` propagates the symbolic layout; ``describe`` renders the
    op for golden snapshots.  Imports happen inside ``apply`` so the IR
    stays importable from anywhere (core <-> real <-> kernels).
    """

    def apply(self, blk, opts, ctx, off: int):
        raise NotImplementedError

    def transform(self, layout: Layout) -> Layout:
        return layout

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class PackTwo(StageOp):
    """Pair two real pencils along ``pair_axis`` into one complex block."""

    pair_axis: int

    def apply(self, blk, opts, ctx, off):
        from repro_torch.real import packing
        return packing.pack_two(blk, self.pair_axis + off)

    def transform(self, layout):
        if not layout.real:
            raise ScheduleError("pack2 needs a real block")
        return dataclasses.replace(
            layout.with_den(self.pair_axis, mul=2), real=False)

    def describe(self):
        return f"pack2[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class UnpackTwo(StageOp):
    """Split the packed z spectrum into two folded half spectra (the
    shard-aligned Nz/2-bin layout, Nyquist folded into DC); the
    ``"pallas"`` impl runs the Hopper unpack kernel."""

    pair_axis: int
    z_axis: int = 2
    impl_stage: int = 0

    def apply(self, blk, opts, ctx, off):
        from repro_torch.real import packing
        use_pallas = opts.stage_impl(self.impl_stage) == "pallas"
        return packing.unpack_two(blk, self.pair_axis + off, fold=True,
                                  use_pallas=use_pallas)

    def transform(self, layout):
        return layout.with_den(self.pair_axis, div=2).with_den(
            self.z_axis, mul=2)

    def describe(self):
        return f"unpack2[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class RepackHalves(StageOp):
    """Inverse of :class:`UnpackTwo`: rebuild the full packed z spectrum
    (the ``"pallas"`` impl runs the Hopper extend kernel)."""

    pair_axis: int
    nz: int
    z_axis: int = 2
    impl_stage: int = 2

    def apply(self, blk, opts, ctx, off):
        from repro_torch.real import packing
        use_pallas = opts.stage_impl(self.impl_stage) == "pallas"
        return packing.repack_halves(blk, self.pair_axis + off, self.nz,
                                     folded=True, use_pallas=use_pallas)

    def transform(self, layout):
        return layout.with_den(self.pair_axis, mul=2).with_den(
            self.z_axis, div=2)

    def describe(self):
        return f"repack2[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class SplitPairs(StageOp):
    """Complex block -> real block, doubled along ``pair_axis``."""

    pair_axis: int

    def apply(self, blk, opts, ctx, off):
        from repro_torch.real import packing
        return packing.split_pairs(blk, self.pair_axis + off)

    def transform(self, layout):
        if layout.real:
            raise ScheduleError("split2 needs a complex block")
        return dataclasses.replace(
            layout.with_den(self.pair_axis, div=2), real=True)

    def describe(self):
        return f"split2[{DIMS[self.pair_axis]}]"


@dataclasses.dataclass(frozen=True)
class SpectralScale(StageOp):
    """Fused k-space multiply: ``blk * alpha * operands[key]``.

    Attached via :meth:`Schedule.with_epilogue`; the filter block arrives
    through the executor's ``operands`` mapping, laid out like the block
    at the attachment point (``Schedule.layout_out`` for terminal
    epilogues).
    """

    key: str = "filter"
    alpha: float = 1.0

    def apply(self, blk, opts, ctx, off):
        if self.key not in ctx:
            raise ScheduleError(
                f"schedule epilogue needs operand {self.key!r}; pass it via "
                "run_schedule(..., operands={...})")
        from repro_torch.kernels import spectral_scale as ss
        return ss.spectral_scale(blk, ctx[self.key], self.alpha)

    def describe(self):
        return f"kscale[{self.key}]"


# ---------------------------------------------------------------------------
# stages and schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline step (paper steps {1,2,3} / {5,6,7} as one unit).

    Executed as: prologue ops -> local FFT along ``fft_axis`` (if any,
    using ``opts.stage_impl(impl_stage)``) -> epilogue ops -> global
    transpose over ``comm_axis`` (if any).  When a communicator is
    present the chain is split into K chunks along ``chunk_axis`` (an
    axis not involved in the transpose): chunk i's collective has no data
    dependence on chunk i+1's FFT, so the two overlap — the paper's
    second OpenMP thread.

    ``prologue``/``epilogue`` hold :class:`StageOp` s — the packed real
    transforms' pair/split ops run here, per K-chunk.
    ``transpose_impl`` / ``overlap_k`` are *per-stage* overrides of the
    same-named :class:`FFTOptions` knobs (None = inherit).
    """

    name: str
    fft_axis: Optional[int] = None
    comm_axis: Optional[AxisName] = None
    split_axis: int = 0
    concat_axis: int = 0
    chunk_axis: int = 0
    impl_stage: int = 0
    prologue: tuple = ()
    epilogue: tuple = ()
    transpose_impl: Optional[str] = None
    overlap_k: Optional[int] = None


def stage_transpose_impl(st: Stage, opts) -> str:
    """The transpose implementation this stage actually runs (its own
    override when set, else the plan-wide ``opts.transpose_impl``)."""
    return st.transpose_impl if st.transpose_impl is not None \
        else opts.transpose_impl


def stage_overlap_k(st: Stage, opts) -> int:
    """The chunk count this stage actually targets (its own override when
    set, else the plan-wide ``opts.overlap_k``)."""
    return st.overlap_k if st.overlap_k is not None else opts.overlap_k


def stage_category(st: Stage) -> str:
    """The dominant tracer category of a stage (``repro_torch.obs``'s
    ``CATEGORIES``)."""
    if st.fft_axis is not None:
        return "fft"
    if st.comm_axis is not None:
        return "collective"
    if st.prologue:
        return "pack"
    return "unpack" if st.epilogue else "epilogue"


@dataclasses.dataclass(frozen=True)
class StagePoints:
    """Layouts at the four observation points of one stage."""

    entry: Layout                 # stage input (what gets K-chunked)
    fft: Layout                   # after prologue (the FFT operand)
    comm: Layout                  # after epilogue (what the a2a moves)
    out: Layout                   # after the a2a


@dataclasses.dataclass(frozen=True)
class ExtraComm:
    """A collective outside the stage list: e.g. the packed pipeline's
    z-localizing reshard (``mesh.reshard``, one all-to-all of the half
    volume, never K-chunked)."""

    name: str
    layout: Layout


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A fully-specified pipeline: stages + terminal epilogue + metadata.

    Layouts are propagated through every stage at construction; an
    inconsistent builder (FFT along a sharded axis, transpose over a
    communicator the concat dim is not sharded by, ...) raises
    :class:`ScheduleError` immediately.
    """

    name: str
    sign: int
    layout_in: Layout
    stages: tuple
    epilogue: tuple = ()          # terminal ops, run once (never chunked)
    extra_comms: tuple = ()       # out-of-body collectives (metadata only)
    points: tuple = None          # derived; do not pass

    def __post_init__(self):
        points = []
        cur = self.layout_in
        for st in self.stages:
            entry = cur
            for op in st.prologue:
                cur = op.transform(cur)
            if st.fft_axis is not None:
                cur.check_fft_axis(st.fft_axis)
            fft = cur
            for op in st.epilogue:
                cur = op.transform(cur)
            comm = cur
            if st.comm_axis is not None:
                cur = cur.after_all_to_all(st.comm_axis, st.split_axis,
                                           st.concat_axis)
            points.append(StagePoints(entry, fft, comm, cur))
        for op in self.epilogue:
            cur = op.transform(cur)
        object.__setattr__(self, "points", tuple(points))
        object.__setattr__(self, "_layout_out", cur)
        # hashed once: every transform looks its plan up by its schedule
        # (``grad.vjp``'s caches), and ``points`` follows from the rest
        object.__setattr__(self, "_hash", hash((
            self.name, self.sign, self.layout_in, self.stages,
            self.epilogue, self.extra_comms)))

    def __hash__(self) -> int:
        return self._hash

    @property
    def layout_out(self) -> Layout:
        return self._layout_out

    def with_epilogue(self, op: StageOp) -> "Schedule":
        """Attach a terminal epilogue op (run once on the final block,
        after the last collective — never per-chunk)."""
        return dataclasses.replace(self, epilogue=self.epilogue + (op,),
                                   points=None)

    # -- introspection (cost model, golden tests, effective_k) --------------
    def comm_stages(self) -> list:
        return [(i, st) for i, st in enumerate(self.stages)
                if st.comm_axis is not None]

    def transpose_count(self) -> int:
        """Global transposes per transform, including out-of-body
        reshards."""
        return len(self.comm_stages()) + len(self.extra_comms)

    def effective_k(self, shape: Sequence[int], axis_sizes,
                    overlap_k: int) -> tuple:
        """Per-comm-stage chunk count the executor will actually use: K
        where the stage-entry extent of ``chunk_axis`` divides, else the
        silent fallback to 1 (no overlap for that stage)."""
        out = []
        for i, st in self.comm_stages():
            ext = self.points[i].entry.local_shape(shape, axis_sizes)[
                st.chunk_axis]
            k = st.overlap_k if st.overlap_k is not None else overlap_k
            out.append(k if k > 1 and ext % k == 0 else 1)
        return tuple(out)

    def fft_events(self, shape: Sequence[int], axis_sizes) -> list:
        """(impl_stage, local_elems, transform_size) per local FFT, in
        pipeline order."""
        out = []
        for st, pts in zip(self.stages, self.points):
            if st.fft_axis is None:
                continue
            loc = pts.fft.local_shape(shape, axis_sizes)
            out.append((st.impl_stage, math.prod(loc), loc[st.fft_axis]))
        return out

    def comm_events(self, shape: Sequence[int], axis_sizes,
                    complex_itemsize: int = 8) -> list:
        """One dict per collective: bytes each rank injects, communicator
        size, chunkability — in-body transposes first, then out-of-body
        reshards (one fused all-to-all each, never chunked)."""
        sizes = dict(axis_sizes)
        out = []
        for i, st in self.comm_stages():
            pts = self.points[i]
            csize = math.prod(sizes[n] for n in flat_axes(st.comm_axis))
            out.append({
                "name": st.name,
                "bytes": pts.comm.bytes(shape, axis_sizes, complex_itemsize),
                "comm_size": csize,
                "chunkable": True,
                "chunk_extent": pts.entry.local_shape(shape, axis_sizes)[
                    st.chunk_axis],
            })
        for ec in self.extra_comms:
            out.append({
                "name": ec.name,
                "bytes": ec.layout.bytes(shape, axis_sizes, complex_itemsize),
                "comm_size": 1,
                "chunkable": False,
                "chunk_extent": 1,
            })
        return out

    def describe(self) -> str:
        """Stable text rendering (the golden-snapshot format)."""
        lines = [f"schedule {self.name} sign={self.sign:+d}",
                 f"  in : {self.layout_in}"]
        for i, (st, pts) in enumerate(zip(self.stages, self.points)):
            parts = [op.describe() for op in st.prologue]
            if st.fft_axis is not None:
                parts.append(f"fft[{DIMS[st.fft_axis]}]@s{st.impl_stage}")
            parts.extend(op.describe() for op in st.epilogue)
            if st.comm_axis is not None:
                a2a = (f"a2a[{_axis_str(st.comm_axis)}] split={st.split_axis} "
                       f"concat={st.concat_axis} chunk={st.chunk_axis}")
                if st.transpose_impl is not None:
                    a2a += f" impl={st.transpose_impl}"
                if st.overlap_k is not None:
                    a2a += f" K={st.overlap_k}"
                parts.append(a2a)
            lines.append(f"  {i} {st.name}: " + " | ".join(parts)
                         + f" -> {pts.out}")
        for op in self.epilogue:
            lines.append(f"  + epilogue {op.describe()}")
        for ec in self.extra_comms:
            lines.append(f"  + reshard {ec.name}: {ec.layout} "
                         "(one fused all-to-all)")
        lines.append(f"  out: {self.layout_out}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

CHUNKS_OVERLAPPED = "stage_chunks_overlapped"


def _fft_along(blk: torch.Tensor, axis: int, sign: int, opts,
               stage: int = 0, donate: bool = False) -> torch.Tensor:
    return local_fft.fft_1d(blk, axis, sign, impl=opts.stage_impl(stage),
                            plan_cache=opts.plan_cache, donate=donate)


def _pack_pieces(blk: torch.Tensor, mesh, axis: AxisName,
                 split_axis: int) -> list:
    """Rotated-block pack shared by the ring and pairwise transposes: one
    rotation pass (``kernels/transpose_pack``) writes the P send pieces
    — piece s is the block bound for rank ``(idx + s) % P`` — each as a
    contiguous buffer."""
    from repro_torch.kernels import transpose_pack
    return transpose_pack.pack_pieces(blk.contiguous(), split_axis,
                                      mesh.axis_index(axis),
                                      mesh.axis_size(axis))


def _landing(pieces: list) -> torch.Tensor:
    """One (P, *piece) buffer for the received pieces; slot 0 is this
    rank's own piece (round 0: no wire traffic)."""
    buf = torch.empty((len(pieces),) + tuple(pieces[0].shape),
                      dtype=pieces[0].dtype, device=pieces[0].device)
    buf[0].copy_(pieces[0])
    return buf


def _ring_transpose(blk: torch.Tensor, mesh, axis: AxisName, split_axis: int,
                    concat_axis: int, round_cb=None) -> Pending:
    """P-1-round ring transpose: pack -> send -> unpack.  All P-1 rounds
    are posted at once — round s sends piece s to ``(idx + s) % P`` and
    receives from ``(idx - s) % P`` — and the received pieces are
    reassembled with one fused rotation.

    ``round_cb(s, piece)`` (the observability hook) is called on each
    received piece once the exchange has completed and before the
    unpack; it returns the piece, possibly wrapped, which then takes the
    slot.  With ``round_cb=None`` nothing more is launched."""
    from repro_torch.kernels import transpose_pack
    p = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    with span("transpose:pack", "pack", mesh.device):
        pieces = _pack_pieces(blk, mesh, axis, split_axis)
        buf = _landing(pieces)
    # slot order [round 0, round P-1, ..., round 1] (the reference's
    # [recv[0]] + recv[:0:-1]) puts the piece from src (idx + m) % P at
    # slot m; rotating by -idx restores src order.
    sends = [(pieces[s], (idx + s) % p) for s in range(1, p)]
    recvs = [(buf[p - s], (idx - s) % p) for s in range(1, p)]
    wire = mesh.exchange(sends, recvs, axis)

    def finish():
        with span("transpose:unpack", "unpack", mesh.device):
            if round_cb is not None:
                for s in range(1, p):
                    slot = buf[p - s]
                    piece = round_cb(s, slot)
                    if piece is not slot:
                        slot.copy_(piece)
            return transpose_pack.unpack_pieces(buf, concat_axis, -idx)
    return Pending([wire], finish)


def _pairwise_transpose(blk: torch.Tensor, mesh, axis: AxisName,
                        split_axis: int, concat_axis: int) -> Pending:
    """FFTW3-style emulation: P-1 *blocking* sendrecv rounds — each
    round's exchange is waited on before the next is posted (the torch
    form of the reference's ``optimization_barrier`` chain).
    Numerically identical to the other impls; this is the baseline whose
    serialized rounds the ring pipeline exists to avoid (figs 12-15).
    Both sides share the ring's fused pack and unpack."""
    from repro_torch.kernels import transpose_pack
    p = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    with span("transpose:pack", "pack", mesh.device):
        pieces = _pack_pieces(blk, mesh, axis, split_axis)
        buf = _landing(pieces)
    for s in range(1, p):
        mesh.exchange([(pieces[s], (idx + s) % p)],
                      [(buf[p - s], (idx - s) % p)], axis).wait()
    with span("transpose:unpack", "unpack", mesh.device):
        return Pending.done(transpose_pack.unpack_pieces(buf, concat_axis,
                                                         -idx))


def _all_to_all(blk: torch.Tensor, mesh, axis: AxisName, split_axis: int,
                concat_axis: int, impl: str = "alltoall",
                ring_round_cb=None) -> Pending:
    """Global transpose along one communicator, issued asynchronously.

    ``impl="alltoall"``  one fused collective (CROFT's MPI_Alltoall).
    ``impl="ring"``      P-1 point-to-point rounds posted together, with
                         the fused pack/unpack kernel.
    ``impl="pairwise"``  P-1 blocking exchanges (FFTW3's MPI_Sendrecv
                         pattern) — numerically identical.
    """
    if impl == "alltoall":
        return mesh.all_to_all(blk, axis, split_axis, concat_axis)
    if impl not in ("ring", "pairwise"):
        raise ValueError(f"unknown transpose impl {impl!r}")
    if isinstance(axis, tuple):
        raise ValueError(f"{impl} transpose supports single mesh axes only")
    if impl == "ring":
        return _ring_transpose(blk, mesh, axis, split_axis, concat_axis,
                               round_cb=ring_round_cb)
    return _pairwise_transpose(blk, mesh, axis, split_axis, concat_axis)


def stage_pre(blk: torch.Tensor, st: Stage, sign: int, opts, off: int = 0,
              ctx=None, donate: bool = False) -> torch.Tensor:
    """The compute leg of one stage: prologue ops -> local FFT ->
    epilogue ops, on one (chunk of a) local block.  ``donate``: the
    executor made ``blk`` and reads it no more, so the local FFT may
    write its output into it (``local_fft.fft_matmul``); given to the
    FFT where no prologue op ran before it."""
    ctx = ctx or {}
    for op in st.prologue:
        blk = op.apply(blk, opts, ctx, off)
    if st.fft_axis is not None:
        with span("stage:fft", "fft"):
            blk = _fft_along(blk, st.fft_axis + off, sign, opts,
                             st.impl_stage, donate and not st.prologue)
    for op in st.epilogue:
        blk = op.apply(blk, opts, ctx, off)
    return blk


def stage_comm(blk: torch.Tensor, st: Stage, opts, mesh,
               off: int = 0, ring_round_cb=None) -> Pending:
    """The collective leg of one stage (the global transpose), issued
    asynchronously; the counterpart of :func:`stage_pre`.
    ``ring_round_cb(round, piece)``, when given and the stage resolves to
    the ring impl, is called on each of the P-1 received pieces so
    ``repro_torch.obs`` can tag per-round spans."""
    return _all_to_all(blk, mesh, st.comm_axis, st.split_axis + off,
                       st.concat_axis + off, stage_transpose_impl(st, opts),
                       ring_round_cb=ring_round_cb)


def ring_round(blk: torch.Tensor, st: Stage, opts, mesh, rnd: int,
               off: int = 0) -> torch.Tensor:
    """One ring-transpose round of a comm stage, standalone: the fused
    rotated pack, then round ``rnd``'s single exchange (send piece
    ``rnd`` to ``(idx + rnd) % P``, receive from ``(idx - rnd) % P``).
    Round 0 is the rank's own piece, with no wire traffic.  Returns the
    received piece without placing it; production execution stays in
    :func:`stage_comm`.  ``repro_torch.obs.instrument`` times ring stages
    round by round with it; every rank of the communicator must call it
    with the same ``rnd``."""
    axis = st.comm_axis
    pieces = _pack_pieces(blk, mesh, axis, st.split_axis + off)
    if rnd == 0:
        return pieces[0]
    p = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    got = torch.empty_like(pieces[rnd])
    mesh.exchange([(pieces[rnd], (idx + rnd) % p)],
                  [(got, (idx - rnd) % p)], axis).wait()
    return got


def run_stage(blk: torch.Tensor, st: Stage, sign: int, opts, mesh,
              off: int = 0, ctx=None, ring_round_cb=None,
              donate: bool = False) -> torch.Tensor:
    """Execute one stage on a local block (axis indices offset by ``off``
    for leading batch dims).  Owns the K-chunked overlap and the silent
    fallback to one chunk when ``chunk_axis`` is not divisible by K.

    With K >= 2 chunks, chunk i's compute leg, pack and collective are
    queued before chunk i+1's compute leg, and every wait (with its
    unpack) follows the last post.  The compute stream runs kernels in
    the order they are queued, and a collective's stream waits for all
    that was queued before its post: chunk i's transfer then runs while
    chunk i+1 is transformed and packed, and the last chunk's transfer
    while the earlier chunks are unpacked.  (Queuing chunk i+1's FFT
    ahead of chunk i's pack, the reference's "pipelined" dataflow, would
    hold chunk i's transfer behind that FFT.)  Both ``opts.stage_overlap``
    modes therefore issue this one order; they stay distinct names for
    plan tokens and the tuner's candidates.  A pairwise stage waits on
    each of its rounds inside its collective leg and overlaps nothing.
    Every chunk compute leg queued while an earlier chunk's collective is
    in flight adds one to the ``stage_chunks_overlapped`` counter.
    ``donate`` (:func:`stage_pre`'s) is taken by a stage with no
    collective alone: chunks and collectives keep their buffers.
    """
    ctx = ctx or {}

    def pre(c):
        return stage_pre(c, st, sign, opts, off, ctx)

    def comm(c):
        return stage_comm(c, st, opts, mesh, off, ring_round_cb=ring_round_cb)

    if st.comm_axis is None:
        # nothing to overlap with: never chunked
        return stage_pre(blk, st, sign, opts, off, ctx, donate)
    k = stage_overlap_k(st, opts)
    ax = st.chunk_axis + off
    if k <= 1 or blk.shape[ax] % k:
        return comm(pre(blk)).wait()
    overlapped = metrics_lib.get_registry().counter(
        CHUNKS_OVERLAPPED, "chunk compute legs queued while an earlier "
        "chunk's collective of the same stage was in flight")
    pending = []
    for c in torch.chunk(blk, k, dim=ax):
        if any(p.in_flight for p in pending):
            overlapped.inc()
        # a chunk's compute output dies once its pack is queued
        pending.append(comm(pre(c)))
    # the waits (and their unpacks) first, so the cat's span is the cat's
    parts = [p.wait() for p in pending]
    with span("stage:cat", "unpack", blk.device, chunks=k):
        return torch.cat(parts, dim=ax)


def _root(t: torch.Tensor) -> torch.Tensor:
    """The tensor ``t`` views (``t`` itself when it views none)."""
    return t if t._base is None else t._base


def run_schedule(blk: torch.Tensor, sched: Schedule, opts, mesh,
                 operands=None, ring_round_cb=None) -> torch.Tensor:
    """Execute a schedule on this rank's local block.

    Leading batch axes are carried along unsharded: every axis index in
    the schedule is offset by ``blk.ndim - 3``.  ``operands`` supplies
    named blocks to ops that need them (the fused k-space filter).
    ``ring_round_cb(round, piece)`` is the observability hook threaded to
    every ring-impl transpose (see :func:`stage_comm`).

    A block the executor made (any that views another tensor than the
    caller's ``blk``) is donated to the stage that consumes it: its
    local FFT may write into it (:func:`stage_pre`).  The caller's block
    is never written.
    """
    off = blk.ndim - 3
    ctx = dict(operands or {})
    caller = _root(blk)
    for st in sched.stages:
        blk = run_stage(blk, st, sched.sign, opts, mesh, off, ctx,
                        ring_round_cb=ring_round_cb,
                        donate=_root(blk) is not caller)
    for op in sched.epilogue:
        blk = op.apply(blk, opts, ctx, off)
    # Fault plane: output poisoning.  The port runs eagerly, so the
    # injector is asked on every call (the reference asks once, while
    # tracing); with none armed, or none matching, it launches nothing.
    if inject_lib.corrupt("exec.output", sched.name):
        blk = blk * torch.tensor(float("nan"), dtype=blk.dtype,
                                 device=blk.device)
    return blk


def norm_factor(shape: Sequence[int], sign: int,
                norm: Optional[str]) -> Optional[float]:
    """The real factor scaling a transform of the global grid ``shape``
    (None: none).  None and ``"backward"``: 1/(NxNyNz) on the inverse
    (paper eq. 2); ``"ortho"``: 1/sqrt(NxNyNz) both ways; ``"none"``:
    none.  Any other name raises."""
    nxyz = shape[-3] * shape[-2] * shape[-1]
    if norm is None or norm == "backward":
        return 1.0 / nxyz if sign == +1 else None
    if norm == "ortho":
        return 1.0 / math.sqrt(nxyz)
    if norm == "none":
        return None
    raise ValueError(f"unknown norm {norm!r}")


def normalize(y: torch.Tensor, factor: Optional[float]) -> torch.Tensor:
    """``y`` times a :func:`norm_factor`, as one ``inverse:normalize``
    span (``y`` itself when the factor is None)."""
    if factor is None:
        return y
    with span("inverse:normalize", "epilogue", y.device):
        return y * factor


# ---------------------------------------------------------------------------
# complex-transform builders (pencil / slab / cell)
# ---------------------------------------------------------------------------

def _pencil_stages(ax_y: AxisName, ax_z: AxisName,
                   output_layout: str) -> list:
    """Forward pencil pipeline, paper §4.1 steps 1-9 (+ optional restore)."""
    stages = [
        # steps 1-4: FFT along x, transpose x<->y in the column communicator
        Stage("x-fft+xy", fft_axis=0, impl_stage=0, comm_axis=ax_y,
              split_axis=0, concat_axis=1, chunk_axis=2),
        # steps 5-8: FFT along y, transpose y<->z in the row communicator
        Stage("y-fft+yz", fft_axis=1, impl_stage=1, comm_axis=ax_z,
              split_axis=1, concat_axis=2, chunk_axis=0),
        # step 9: FFT along z
        Stage("z-fft", fft_axis=2, impl_stage=2),
    ]
    if output_layout == "natural":
        # restore: reverse YZ then XY transposes (paper §5.2, overlapped)
        stages += [
            Stage("restore-yz", comm_axis=ax_z, split_axis=2, concat_axis=1,
                  chunk_axis=0),
            Stage("restore-xy", comm_axis=ax_y, split_axis=1, concat_axis=0,
                  chunk_axis=2),
        ]
    return stages


def build_c2c(decomp, *, sign: int = -1, output_layout: str = "natural",
              from_spectral: bool = False) -> Schedule:
    """Schedule for the complex 3-D transform of one decomposition.

    ``from_spectral`` builds the reversed pipeline consuming the spectral
    (z-local) layout and emitting the natural one — used by the inverse
    when the forward ran with ``output_layout="spectral"`` (the forward's
    restoring transposes and the inverse's leading transposes cancel).
    """
    kind = decomp.kind
    if from_spectral:
        if kind == "pencil":
            ax_y, ax_z = decomp.axes
            stages = [
                Stage("z-fft+zy", fft_axis=2, impl_stage=0, comm_axis=ax_z,
                      split_axis=2, concat_axis=1, chunk_axis=0),
                Stage("y-fft+yx", fft_axis=1, impl_stage=1, comm_axis=ax_y,
                      split_axis=1, concat_axis=0, chunk_axis=2),
                Stage("x-fft", fft_axis=0, impl_stage=2),
            ]
        elif kind == "slab":
            (ax_z,) = decomp.axes
            stages = [
                Stage("y-fft", fft_axis=1, impl_stage=0),
                Stage("z-fft+zx", fft_axis=2, impl_stage=1, comm_axis=ax_z,
                      split_axis=2, concat_axis=0, chunk_axis=1),
                Stage("x-fft", fft_axis=0, impl_stage=2),
            ]
        else:
            raise ScheduleError("cell has no spectral layout to start from")
        return Schedule(f"{kind}/c2c/from-spectral", sign,
                        layout_for(decomp, "spectral"), tuple(stages))

    if kind == "pencil":
        ax_y, ax_z = decomp.axes
        stages = _pencil_stages(ax_y, ax_z, output_layout)
    elif kind == "slab":
        (ax_z,) = decomp.axes
        stages = [
            Stage("y-fft", fft_axis=1, impl_stage=0),  # y free on both layouts
            Stage("x-fft+xz", fft_axis=0, impl_stage=1, comm_axis=ax_z,
                  split_axis=0, concat_axis=2, chunk_axis=1),
            Stage("z-fft", fft_axis=2, impl_stage=2),
        ]
        if output_layout == "natural":
            stages.append(Stage("restore-zx", comm_axis=ax_z, split_axis=2,
                                concat_axis=0, chunk_axis=1))
    else:  # cell: regroup to x-pencils over the folded (y, x) communicator
        if output_layout == "spectral":
            raise ScheduleError("cell decomposition returns natural layout "
                                "only")
        ax_x, ax_y, ax_z = decomp.axes
        fold_y = (tuple(ax_y) + flat_axes(ax_x) if isinstance(ax_y, tuple)
                  else (ax_y,) + flat_axes(ax_x))
        if len(fold_y) == 1:
            fold_y = fold_y[0]
        stages = [Stage("regroup-x", comm_axis=ax_x, split_axis=1,
                        concat_axis=0, chunk_axis=2)]
        stages += _pencil_stages(fold_y, ax_z, "natural")
        stages += [Stage("scatter-x", comm_axis=ax_x, split_axis=0,
                         concat_axis=1, chunk_axis=2)]
    return Schedule(f"{kind}/c2c/{output_layout}", sign,
                    layout_for(decomp, "natural"), tuple(stages))


def build_local_c2c(sign: int = -1) -> Schedule:
    """Schedule for the complex 3-D transform of one device's whole grid:
    x, y, then z, with no collective.  Meshless plans and plans on a
    mesh of one rank run it."""
    return Schedule("local/c2c", sign, Layout(tuple(LayoutAxis(d)
                                                     for d in DIMS)),
                    (Stage("x-fft", fft_axis=0, impl_stage=0),
                     Stage("y-fft", fft_axis=1, impl_stage=1),
                     Stage("z-fft", fft_axis=2, impl_stage=2)))
