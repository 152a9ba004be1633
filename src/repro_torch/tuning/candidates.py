"""Candidate enumeration: every valid (Decomposition, FFTOptions) pair.

Port of ``repro/tuning/candidates.py``: the same search space in the same
order, so labels and plan keys are byte-equal to the reference's.

The planner's search space is the cross product of

  * how the grid maps onto the mesh — slab / pencil / cell, over every
    ordered assignment of mesh axes (and folded axis groups) that covers
    the whole mesh, and
  * the ``FFTOptions`` knob matrix — overlap K, local 1-D FFT
    implementation (optionally per pipeline stage), output layout,
    transpose implementation,

filtered by :meth:`Decomposition.validate` (divisibility, P <= N limits,
overlap chunking).  ``problem="r2c"`` additionally enumerates the real-
transform strategy axis: every c2c candidate as an "embed" plan, plus a
"packed" two-for-one plan wherever ``repro_torch.real`` supports it.
Everything here is pure arithmetic over axis *sizes*, so candidates can
be generated with no devices present.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Iterator, Mapping, Optional, Sequence

from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions, build_schedule

# default knob ranges, the reference's: "pallas" (in the port, the
# hand-written Hopper kernel) is absent, so the candidate lists stay
# byte-equal; callers pass local_impls=(..., "pallas") to race it, and
# "xla" is the library FFT (torch.fft)
DEFAULT_OVERLAP_KS = (1, 2, 4)
DEFAULT_LOCAL_IMPLS = ("matmul", "stockham", "xla")
DEFAULT_LAYOUTS = ("natural", "spectral")
#: the ``_grad`` problems plan a *training step*: same search space as
#: their base problem, but the cost model prices forward + adjoint
#: schedule and measurement times ``backward()`` through the transform
PROBLEMS = ("c2c", "r2c", "c2c_grad", "r2c_grad")
GRAD_SUFFIX = "_grad"


def split_grad(problem: str) -> tuple:
    """``"r2c_grad" -> ("r2c", True)``; base problems pass through."""
    if problem.endswith(GRAD_SUFFIX):
        return problem[: -len(GRAD_SUFFIX)], True
    return problem, False


def _impl_str(impl) -> str:
    if isinstance(impl, tuple):
        return "-".join(impl)
    return impl


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space."""

    decomp: Decomposition
    opts: FFTOptions
    #: problem class this plan solves
    problem: str = "c2c"
    #: r2c only: "packed" | "embed"
    strategy: Optional[str] = None

    @property
    def label(self) -> str:
        def axis_str(a):
            if isinstance(a, tuple):
                return "+".join(a)
            return a
        axes = "x".join(axis_str(a) for a in self.decomp.axes)
        o = self.opts
        base = (f"{self.decomp.kind}[{axes}]/k{o.overlap_k}/"
                f"{_impl_str(o.local_impl)}/"
                f"{o.output_layout}/{o.transpose_impl}"
                + ("" if o.overlap_mode == "pipelined"
                   else f"/{_impl_str(o.overlap_mode)}")
                + ("" if o.plan_cache else "/noplan"))
        if self.problem != "c2c":
            base += f"/{self.problem}" + (f"-{self.strategy}"
                                          if self.strategy else "")
        return base

    # -- canonical string form ----------------------------------------------
    #
    # ``label`` is for humans (it elides default knobs); ``plan_key`` is
    # for caches: it covers every field that changes the program run
    # and round trips exactly, including the per-stage
    # ``local_impl``/``overlap_mode`` 3-tuples.

    @property
    def plan_key(self) -> str:
        key = f"{self.decomp.to_token()}|{self.opts.to_token()}"
        if self.problem != "c2c":
            # strategy may be None (grad c2c plans) — emit the empty
            # string so from_plan_key round-trips it back to None
            key += f"|{self.problem}:{self.strategy or ''}"
        return key

    @classmethod
    def from_plan_key(cls, key: str) -> "Candidate":
        """Inverse of :attr:`plan_key`."""
        parts = key.split("|")
        if len(parts) not in (2, 3):
            raise ValueError(f"malformed plan key {key!r}")
        decomp = Decomposition.from_token(parts[0])
        opts = FFTOptions.from_token(parts[1])
        if len(parts) == 2:
            return cls(decomp, opts)
        problem, _, strategy = parts[2].partition(":")
        if problem not in PROBLEMS:
            # reject rather than construct a plan for a problem class this
            # version cannot build (e.g. a key written by a newer version)
            # — callers treat ValueError as a cache miss, not a crash
            raise ValueError(f"unknown problem {problem!r} in plan key "
                             f"{key!r} (known: {PROBLEMS})")
        return cls(decomp, opts, problem=problem,
                   strategy=strategy or None)


def _groupings(names: Sequence[str], k: int) -> Iterator[tuple]:
    """Ordered partitions of ``names`` into k non-empty groups.

    Each group becomes one Decomposition axis entry: a bare name when the
    group is a single axis, a folded tuple otherwise.  Every grouping
    covers the whole mesh — leaving an axis out would replicate the grid
    over it (never faster, so not part of the search space).
    """
    if len(names) < k:
        return
    for assignment in itertools.product(range(k), repeat=len(names)):
        if set(assignment) != set(range(k)):
            continue
        groups = []
        for g in range(k):
            members = tuple(n for n, a in zip(names, assignment) if a == g)
            groups.append(members[0] if len(members) == 1 else members)
        yield tuple(groups)


def decompositions_for(shape: Sequence[int], axis_sizes: Mapping[str, int],
                       overlap_k: int = 1) -> list[Decomposition]:
    """All decompositions valid for (shape, mesh axes) at the given K."""
    names = list(axis_sizes)
    out: list[Decomposition] = []
    for kind, slots in (("slab", 1), ("pencil", 2), ("cell", 3)):
        for axes in _groupings(names, slots):
            dec = Decomposition(kind, axes)
            if dec.is_valid(shape, axis_sizes, overlap_k):
                out.append(dec)
    return out


def _stagewise_impls(local_impls: Sequence) -> list:
    """Heterogeneous per-stage combinations (ROADMAP follow-on): every
    3-tuple over ``local_impls`` whose entries are not all equal (the
    homogeneous ones are already in the base space as scalars)."""
    singles = [i for i in local_impls if not isinstance(i, (tuple, list))]
    return [combo for combo in itertools.product(singles, repeat=3)
            if len(set(combo)) > 1]


def enumerate_candidates(
        shape: Sequence[int],
        axis_sizes: Mapping[str, int],
        *,
        overlap_ks: Sequence[int] = DEFAULT_OVERLAP_KS,
        local_impls: Sequence[str] = DEFAULT_LOCAL_IMPLS,
        layouts: Sequence[str] = DEFAULT_LAYOUTS,
        include_baselines: bool = False,
        heterogeneous_impls: bool = False,
        problem: str = "c2c",
) -> list[Candidate]:
    """The full valid search space, deterministically ordered.

    ``include_baselines`` adds configurations that model the paper's
    baselines and are never expected to win — ``transpose_impl="pairwise"``
    (FFTW3's sendrecv pattern) and ``plan_cache=False`` (options 1/3) —
    useful for benchmark sweeps, noise for production tuning.

    ``heterogeneous_impls`` widens the ``local_impl`` axis with per-stage
    3-tuples (e.g. matmul on the contiguous first stage, Stockham on the
    strided ones).

    ``problem="r2c"`` returns real-transform candidates: each valid c2c
    point as an "embed" plan plus a "packed" two-for-one plan where the
    packed pipeline's constraints hold (pencil or slab decomposition,
    even divisibility — see ``repro_torch.real.packed_unsupported_reason``).
    """
    if problem not in PROBLEMS:
        raise ValueError(f"problem must be one of {PROBLEMS}, got {problem!r}")
    base_problem, is_grad = split_grad(problem)
    impls = list(local_impls)
    if heterogeneous_impls:
        impls += _stagewise_impls(local_impls)
    out: list[Candidate] = []
    for k in overlap_ks:
        for dec in decompositions_for(shape, axis_sizes, overlap_k=k):
            for impl in impls:
                for layout in layouts:
                    if layout == "spectral" and dec.kind == "cell":
                        continue  # cell pipeline restores natural layout
                    variants = [dict(transpose_impl="alltoall",
                                     plan_cache=True)]
                    # ring / pairwise point-to-point over ONE mesh axis: folded
                    # axes and the cell regroup (which runs the pencil
                    # pipeline over a folded (y, x) communicator) are
                    # rejected by Decomposition.validate — never emit
                    # candidates that cannot run
                    single_axes = (dec.kind != "cell" and all(
                        not isinstance(a, tuple) for a in dec.axes))
                    if single_axes:
                        # the ring pipeline is a real contender (it
                        # overlaps even when no chunk axis divides), so
                        # it is part of the production search space —
                        # the cost model's latency/bandwidth split ranks
                        # it, not a hardcoded preference
                        variants.append(dict(transpose_impl="ring",
                                             plan_cache=True))
                    if include_baselines:
                        variants.append(dict(transpose_impl="alltoall",
                                             plan_cache=False))
                        if single_axes:
                            variants.append(dict(transpose_impl="pairwise",
                                                 plan_cache=True))
                    for var in variants:
                        out.append(Candidate(dec, FFTOptions(
                            overlap_k=k, local_impl=impl,
                            output_layout=layout, **var)))
    if base_problem == "r2c":
        out = _realize_r2c(shape, axis_sizes, out)
    if is_grad:
        # same physical plans; the problem tag switches the cost model to
        # fwd+adjoint pricing and measurement to a forward+backward step
        out = [dataclasses.replace(c, problem=problem) for c in out]
    return out


def _realize_r2c(shape, axis_sizes, base: list[Candidate]) -> list[Candidate]:
    """Map a c2c candidate list onto the r2c strategy axis.

    The packed pipelines (pencil and slab) ignore ``output_layout`` (they
    always start from the z-local spectral layout and never pay restoring
    transposes), so the packed variant rides only on the spectral-layout
    points to avoid duplicate plans.
    """
    from repro_torch.real import packed_unsupported_reason
    out: list[Candidate] = []
    for c in base:
        out.append(dataclasses.replace(c, problem="r2c", strategy="embed"))
        if (c.opts.output_layout == "spectral"
                and packed_unsupported_reason(shape, c.decomp, axis_sizes,
                                              c.opts) is None):
            out.append(dataclasses.replace(c, problem="r2c",
                                           strategy="packed"))
    return out


def default_candidate(shape: Sequence[int], axis_sizes: Mapping[str, int],
                      problem: str = "c2c") -> Optional[Candidate]:
    """What an untuned caller would pick: the decomposition kind matching
    the mesh rank (slab for 1 axis, pencil for 2, cell for 3, folded
    pencil otherwise) with stock ``FFTOptions()``.  None if invalid for
    the shape."""
    names = list(axis_sizes)
    if len(names) == 1:
        dec = Decomposition("slab", (names[0],))
    elif len(names) == 2:
        dec = Decomposition("pencil", tuple(names))
    elif len(names) == 3:
        dec = Decomposition("cell", tuple(names))
    else:
        dec = Decomposition("pencil", (tuple(names[:-1]), names[-1]))
    opts = FFTOptions()
    if not dec.is_valid(shape, axis_sizes, opts.overlap_k):
        if not dec.is_valid(shape, axis_sizes, 1):
            return None
        opts = dataclasses.replace(opts, overlap_k=1)
    base_problem, _ = split_grad(problem)
    if base_problem == "r2c":
        from repro_torch.real import packed_unsupported_reason
        strategy = ("packed" if packed_unsupported_reason(
            shape, dec, axis_sizes, opts) is None else "embed")
        return Candidate(dec, opts, problem=problem, strategy=strategy)
    return Candidate(dec, opts, problem=problem)


# ---------------------------------------------------------------------------
# schedule-space candidates: search *pipelines*, not just knobs
# ---------------------------------------------------------------------------
#
# A ScheduleCandidate is an explicit stage list over a decomposition —
# which dim each stage FFTs, which communicator it transposes over and
# how, plus *per-stage* transpose-impl / K overrides.  The fixed builders
# reach only a few points of this space (one transpose order per kind,
# one impl and one K for the whole pipeline); the enumerator below walks
# the rest, pruned by the same symbolic layout propagation that validates
# the fixed builders (malformed pipelines raise ScheduleError at build
# time) plus a divisibility check against the concrete shape.

SCHED_PREFIX = "sched:"
#: problems the schedule search covers (r2c pipelines carry pack/unpack
#: prologues the symbolic move space does not model)
SCHED_PROBLEMS = ("c2c", "c2c_grad")
_GRID = "xyz"
_IMPL_CODE = {"alltoall": "a", "ring": "r", "pairwise": "p"}
_CODE_IMPL = {v: k for k, v in _IMPL_CODE.items()}
_COMM_RE = re.compile(r"^t(\d+)s(\d)c(\d)h(\d)([arp])?(?:k(\d+))?$")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a searched pipeline, symbolically.

    ``fft`` is a grid dim (0..2) or None; ``comm`` indexes
    ``decomp.axes`` (which communicator transposes) or None; ``split`` /
    ``concat`` / ``chunk`` are grid dims of the transpose (split gains
    the communicator's shards, concat loses them, chunk is the
    uninvolved axis the executor K-chunks along); ``impl`` / ``k`` are
    per-stage overrides of ``opts.transpose_impl`` / ``opts.overlap_k``
    (None = inherit the plan-wide knob).
    """

    fft: Optional[int] = None
    comm: Optional[int] = None
    split: int = 0
    concat: int = 0
    chunk: int = 0
    impl: Optional[str] = None
    k: Optional[int] = None

    def token(self) -> str:
        parts = []
        if self.fft is not None:
            parts.append(f"f{self.fft}")
        if self.comm is not None:
            t = f"t{self.comm}s{self.split}c{self.concat}h{self.chunk}"
            if self.impl is not None:
                t += _IMPL_CODE[self.impl]
            if self.k is not None:
                t += f"k{self.k}"
            parts.append(t)
        return ".".join(parts)

    @classmethod
    def from_token(cls, tok: str) -> "StageSpec":
        fft = comm = impl = k = None
        split = concat = chunk = 0
        saw_comm = False
        for part in tok.split("."):
            if re.fullmatch(r"f[0-2]", part) and fft is None and not saw_comm:
                fft = int(part[1:])
                continue
            m = _COMM_RE.match(part)
            if m is None or saw_comm:
                raise ValueError(f"malformed stage token {tok!r}")
            saw_comm = True
            comm, split, concat, chunk = (int(m.group(i)) for i in (1, 2, 3, 4))
            if m.group(5):
                impl = _CODE_IMPL[m.group(5)]
            if m.group(6):
                k = int(m.group(6))
        if fft is None and not saw_comm:
            raise ValueError(f"empty stage token {tok!r}")
        if saw_comm and (split == concat or chunk in (split, concat)):
            raise ValueError(f"degenerate transpose in stage token {tok!r}")
        return cls(fft=fft, comm=comm, split=split, concat=concat,
                   chunk=chunk, impl=impl, k=k)

    def name(self) -> str:
        """Builder-style stage name (``x-fft+xy`` / ``move-yz`` / ``z-fft``)."""
        if self.comm is None:
            return f"{_GRID[self.fft]}-fft"
        move = f"{_GRID[self.split]}{_GRID[self.concat]}"
        if self.fft is not None:
            return f"{_GRID[self.fft]}-fft+{move}"
        return f"move-{move}"


@dataclasses.dataclass(frozen=True)
class ScheduleCandidate:
    """A searched pipeline: an explicit stage list over a decomposition.

    Duck-types :class:`Candidate` everywhere the tuner needs (``decomp``,
    ``opts``, ``problem``, ``strategy``, ``plan_key``, ``label``) and
    adds ``build_schedule()`` — consumers that care (cost model, measure,
    ``Croft3D``) dispatch on ``is_schedule`` / ``build_schedule``.
    Always a forward (sign=-1) pipeline starting from the natural layout;
    the inverse is derived (``distributed.inverse_schedule``).
    """

    decomp: Decomposition
    opts: FFTOptions
    stages: tuple                 # of StageSpec
    problem: str = "c2c"

    is_schedule = True            # duck-type marker
    strategy = None               # Candidate-compat (schedule search = c2c)

    def __post_init__(self):
        if self.problem not in SCHED_PROBLEMS:
            raise ValueError(f"schedule candidates cover {SCHED_PROBLEMS}, "
                             f"got {self.problem!r}")

    # -- canonical string form ----------------------------------------------
    @property
    def plan_key(self) -> str:
        key = (SCHED_PREFIX + self.decomp.to_token() + "|"
               + self.opts.to_token() + "|"
               + ";".join(sp.token() for sp in self.stages))
        if self.problem != "c2c":
            key += f"|{self.problem}:"
        return key

    @classmethod
    def from_plan_key(cls, key: str) -> "ScheduleCandidate":
        """Inverse of :attr:`plan_key` (ValueError = cache miss upstream)."""
        if not key.startswith(SCHED_PREFIX):
            raise ValueError(f"not a schedule plan key: {key!r}")
        parts = key[len(SCHED_PREFIX):].split("|")
        if len(parts) not in (3, 4):
            raise ValueError(f"malformed schedule plan key {key!r}")
        decomp = Decomposition.from_token(parts[0])
        opts = FFTOptions.from_token(parts[1])
        stages = tuple(StageSpec.from_token(t)
                       for t in parts[2].split(";") if t)
        if not stages:
            raise ValueError(f"schedule plan key {key!r} has no stages")
        problem = "c2c"
        if len(parts) == 4:
            problem, _, strategy = parts[3].partition(":")
            if problem not in SCHED_PROBLEMS or strategy:
                raise ValueError(f"unknown problem tail {parts[3]!r} in "
                                 f"schedule plan key {key!r}")
        for sp in stages:
            if sp.comm is not None and sp.comm >= len(decomp.axes):
                raise ValueError(f"stage communicator {sp.comm} out of range "
                                 f"for {decomp.to_token()}")
        return cls(decomp, opts, stages, problem=problem)

    @property
    def label(self) -> str:
        impls = sorted({sp.impl for sp in self.stages
                        if sp.impl is not None} | {self.opts.transpose_impl})
        return (f"sched:{self.decomp.kind}[{len(self.stages)}st]/"
                f"k{self.opts.overlap_k}/{'+'.join(impls)}/"
                f"{self.opts.output_layout}"
                + (f"/{self.problem}" if self.problem != "c2c" else ""))

    # -- realization ---------------------------------------------------------
    def build_schedule(self, sign: int = -1):
        """The concrete :class:`~repro_torch.core.schedule.Schedule`; raises
        ``ScheduleError`` for pipelines the layout propagation rejects."""
        from repro_torch.core import schedule as schedule_lib
        stages = []
        n_fft = 0
        for sp in self.stages:
            stages.append(schedule_lib.Stage(
                sp.name(), fft_axis=sp.fft,
                comm_axis=(None if sp.comm is None
                           else self.decomp.axes[sp.comm]),
                split_axis=sp.split, concat_axis=sp.concat,
                chunk_axis=sp.chunk,
                impl_stage=min(n_fft, 2) if sp.fft is not None else 0,
                transpose_impl=sp.impl, overlap_k=sp.k))
            if sp.fft is not None:
                n_fft += 1
        return schedule_lib.Schedule(
            "sched/" + self.decomp.to_token(), sign,
            schedule_lib.layout_for(self.decomp, "natural"), tuple(stages))

    def validate(self, shape: Sequence[int],
                 axis_sizes: Mapping[str, int]) -> None:
        """Raise unless this pipeline can execute at the concrete shape
        (layout propagation + shard divisibility + per-stage impl rules).
        The fixed-builder chunk checks in ``Decomposition.validate`` do
        not apply here: searched orders chunk along their own axes, and
        the executor falls back to K=1 per stage when one doesn't divide."""
        sched = self.build_schedule()
        for sp in self.stages:
            if sp.comm is None:
                continue
            impl = sp.impl if sp.impl is not None else self.opts.transpose_impl
            if impl in ("ring", "pairwise") and isinstance(
                    self.decomp.axes[sp.comm], tuple):
                raise ValueError(f"{impl} transpose supports single mesh "
                                 f"axes only (stage {sp.token()!r})")
        if not _layouts_divisible(sched, shape, axis_sizes):
            raise ValueError(f"schedule {self.plan_key!r} has non-divisible "
                             f"layouts for shape {tuple(shape)}")

    def stage_summary(self) -> str:
        """Human-readable pipeline rendering for the wisdom CLI: stage
        names with each comm stage's resolved impl and K."""
        bits = []
        for sp in self.stages:
            b = sp.name()
            if sp.comm is not None:
                impl = sp.impl if sp.impl is not None \
                    else self.opts.transpose_impl
                k = sp.k if sp.k is not None else self.opts.overlap_k
                b += f"[{impl},K={k}]"
            bits.append(b)
        return " -> ".join(bits)

    # -- canonicalization / dedup -------------------------------------------
    def normalized(self) -> "ScheduleCandidate":
        """Fold homogeneous per-stage overrides into the base options and
        drop overrides equal to them, so candidates that run the exact
        same program serialize to the exact same plan token."""
        comm = [sp for sp in self.stages if sp.comm is not None]
        if not comm:
            return self
        opts = self.opts
        impls = {sp.impl if sp.impl is not None else opts.transpose_impl
                 for sp in comm}
        if len(impls) == 1:
            opts = dataclasses.replace(opts, transpose_impl=impls.pop())
        ks = {sp.k if sp.k is not None else opts.overlap_k for sp in comm}
        if len(ks) == 1:
            opts = dataclasses.replace(opts, overlap_k=ks.pop())
        stages = []
        for sp in self.stages:
            if sp.comm is None:
                stages.append(sp)
                continue
            impl = sp.impl if sp.impl is not None else opts.transpose_impl
            k = sp.k if sp.k is not None else opts.overlap_k
            stages.append(dataclasses.replace(
                sp, impl=None if impl == opts.transpose_impl else impl,
                k=None if k == opts.overlap_k else k))
        return dataclasses.replace(self, opts=opts, stages=tuple(stages))

    def as_options_candidate(self) -> Optional[Candidate]:
        """The equivalent fixed-builder :class:`Candidate` when this
        pipeline is expressible in the options space, else None — the
        dedup hook that keeps the searcher from re-measuring plans the
        knob enumeration already covers."""
        norm = self.normalized()
        if any(sp.impl is not None or sp.k is not None for sp in norm.stages):
            return None
        sig = tuple((sp.fft, sp.comm, sp.split, sp.concat, sp.chunk)
                    for sp in norm.stages)
        for layout in ("natural", "spectral"):
            opts = dataclasses.replace(norm.opts, output_layout=layout)
            try:
                fixed = build_schedule(self.decomp, opts, sign=-1)
                fsig = tuple(
                    (st.fft_axis,
                     None if st.comm_axis is None
                     else self.decomp.axes.index(st.comm_axis),
                     st.split_axis, st.concat_axis, st.chunk_axis)
                    for st in fixed.stages)
            except Exception:   # no such fixed pipeline (ScheduleError etc.)
                continue
            if fsig == sig and not any(st.prologue or st.epilogue
                                       for st in fixed.stages):
                return Candidate(self.decomp, opts, problem=norm.problem)
        return None

    @classmethod
    def from_candidate(cls, cand: Candidate) -> "ScheduleCandidate":
        """Wrap a fixed-builder candidate as a (no-override) schedule
        candidate, so fixed and searched plans can be priced by the same
        per-stage cost walk.  ValueError for pipelines with packing ops
        or communicators outside ``decomp.axes`` (cell's folded regroup)."""
        if split_grad(cand.problem)[0] != "c2c":
            raise ValueError("only c2c candidates wrap as schedules")
        sched = build_schedule(cand.decomp, cand.opts, sign=-1)
        specs = []
        for st in sched.stages:
            if st.prologue or st.epilogue:
                raise ValueError(f"stage {st.name!r} carries packing ops")
            try:
                comm = (None if st.comm_axis is None
                        else cand.decomp.axes.index(st.comm_axis))
            except ValueError:
                raise ValueError(f"stage {st.name!r} transposes over a "
                                 "communicator outside decomp.axes")
            specs.append(StageSpec(fft=st.fft_axis, comm=comm,
                                   split=st.split_axis, concat=st.concat_axis,
                                   chunk=st.chunk_axis))
        return cls(cand.decomp, cand.opts, tuple(specs), problem=cand.problem)


def candidate_from_plan_key(key: str):
    """Parse either candidate form from its plan token (the single entry
    point wisdom and the serve cache use)."""
    if key.startswith(SCHED_PREFIX):
        return ScheduleCandidate.from_plan_key(key)
    return Candidate.from_plan_key(key)


def _layouts_divisible(sched, shape: Sequence[int],
                       axis_sizes: Mapping[str, int]) -> bool:
    """True when every stage-point layout tiles the shape exactly (the
    shard product of each dim divides its global extent) — the concrete-
    shape validity check the symbolic propagation cannot do."""
    sizes = dict(axis_sizes)
    for pts in sched.points:
        for lay in (pts.entry, pts.comm, pts.out):
            for ax, n in zip(lay.axes, shape[-3:]):
                denom = math.prod(sizes[s] for s in ax.shards) * ax.den
                if n % denom:
                    return False
    return True


def dedupe_candidates(cands: Sequence) -> list:
    """Drop candidates that serialize to the same plan token, collapsing
    searched pipelines onto their options-space equivalent when one
    exists (a mixed per-stage tuple can normalize to a homogeneous
    candidate that is already in the list — without this, the planner
    costs and measures the identical executable twice)."""
    out, seen = [], set()
    for c in cands:
        if getattr(c, "is_schedule", False):
            c = c.normalized()
            eq = c.as_options_candidate()
            if eq is not None:
                c = eq
        key = c.plan_key
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def _orders(decomp: Decomposition, layouts: Sequence[str],
            max_transposes: int) -> list:
    """Enumerate transpose orders as (moves, final_layout) pairs.

    A move is ``("fft", dim)`` or ``("move", comm, src_dim, dst_dim)``.
    The walk is over symbolic states (which dim each communicator
    currently shards + which dims are transformed): FFT any free
    untransformed dim, or move a communicator to any free dim.  Once all
    three dims are transformed the state is a spectral-layout result;
    continuing home (each communicator back to its natural dim) yields
    the natural-layout result.  Pruned: revisited states within a path,
    back-to-back moves of the same communicator (a wasted round trip),
    and more than ``max_transposes`` moves total.
    """
    init = {"slab": (2,), "pencil": (1, 2)}[decomp.kind]
    n = len(init)
    results = []

    def rec(pos, ffted, moves, visited, last_moved):
        n_moves = sum(1 for m in moves if m[0] == "move")
        if len(ffted) == 3:
            kind = "natural" if pos == init else "spectral"
            if kind in layouts:
                results.append((moves, kind))
            if "natural" not in layouts or pos == init \
                    or n_moves >= max_transposes:
                return
            # restore phase: only home-bound moves remain
            for c in range(n):
                home = init[c]
                if pos[c] == home or home in pos:
                    continue
                npos = pos[:c] + (home,) + pos[c + 1:]
                rec(npos, ffted, moves + ((("move", c, pos[c], home),)),
                    visited, c)
            return
        for d in range(3):
            if d not in ffted and d not in pos:
                rec(pos, ffted | {d}, moves + ((("fft", d),)), visited, None)
        if n_moves >= max_transposes:
            return
        for c in range(n):
            if c == last_moved:
                continue
            for dst in range(3):
                if dst == pos[c] or dst in pos:
                    continue
                npos = pos[:c] + (dst,) + pos[c + 1:]
                state = (npos, frozenset(ffted))
                if state in visited:
                    continue
                rec(npos, ffted, moves + ((("move", c, pos[c], dst),)),
                    visited | {state}, c)

    start = (init, frozenset())
    rec(init, frozenset(), (), {start}, None)
    return results


def _pack_stages(moves: tuple, fuse: bool) -> tuple:
    """Turn a move sequence into a StageSpec tuple.

    ``fuse=True`` merges each FFT into the immediately following
    transpose when the FFT dim takes part in it (the builders' fused
    ``x-fft+xy`` shape — legal because the forced chunk axis is the
    third dim, never the FFT dim); ``fuse=False`` keeps every FFT and
    transpose as its own stage (more, smaller pipeline steps).
    """
    stages, pending_fft = [], None
    for mv in moves:
        if mv[0] == "fft":
            if pending_fft is not None:
                stages.append(StageSpec(fft=pending_fft))
            pending_fft = mv[1]
            continue
        _, c, src, dst = mv
        chunk = 3 - src - dst
        if fuse and pending_fft is not None and pending_fft in (src, dst):
            stages.append(StageSpec(fft=pending_fft, comm=c, split=dst,
                                    concat=src, chunk=chunk))
            pending_fft = None
        else:
            if pending_fft is not None:
                stages.append(StageSpec(fft=pending_fft))
                pending_fft = None
            stages.append(StageSpec(comm=c, split=dst, concat=src,
                                    chunk=chunk))
    if pending_fft is not None:
        stages.append(StageSpec(fft=pending_fft))
    return tuple(stages)


def _override_combos(stages: tuple, decomp: Decomposition,
                     sched, shape, axis_sizes,
                     stage_impls: Sequence[str],
                     overlap_ks: Sequence[int]) -> Iterator[tuple]:
    """(impl, k) override assignments per comm stage.

    With <= 2 comm stages (every spectral-layout order) the full product
    is small and exhaustive; beyond that (natural orders with restores)
    the space is pruned to homogeneous assignments plus the structured
    mixed points that motivate the search: ring on the smallest
    communicator / alltoall elsewhere (and the inverse), and the largest
    K from ``overlap_ks`` that divides each stage's own chunk extent.
    """
    comm_ids = [i for i, sp in enumerate(stages) if sp.comm is not None]
    per_stage_impls = []
    for i in comm_ids:
        folded = isinstance(decomp.axes[stages[i].comm], tuple)
        per_stage_impls.append(tuple(
            im for im in stage_impls
            if im == "alltoall" or not folded))
    sizes = dict(axis_sizes)
    csizes = [math.prod(sizes[s] for s in _flatten(decomp.axes[stages[i].comm]))
              for i in comm_ids]
    exts = {}
    ci = 0
    for j, st in enumerate(sched.stages):
        if st.comm_axis is not None:
            exts[comm_ids[ci]] = sched.points[j].entry.local_shape(
                shape, axis_sizes)[st.chunk_axis]
            ci += 1
    fit_ks = tuple(max((k for k in overlap_ks if exts[i] % k == 0),
                       default=1) for i in comm_ids)
    if len(comm_ids) <= 2:
        impl_combos = list(itertools.product(*per_stage_impls))
        k_combos = list(itertools.product(overlap_ks, repeat=len(comm_ids)))
    else:
        impl_combos = {tuple("alltoall" for _ in comm_ids)}
        if all("ring" in ch for ch in per_stage_impls):
            impl_combos.add(tuple("ring" for _ in comm_ids))
            small = min(csizes)
            impl_combos.add(tuple("ring" if cs == small else "alltoall"
                                  for cs in csizes))
            impl_combos.add(tuple("alltoall" if cs == small else "ring"
                                  for cs in csizes))
        impl_combos = sorted(impl_combos)
        k_combos = sorted({tuple(k for _ in comm_ids) for k in overlap_ks}
                          | {fit_ks})
    for impls in impl_combos:
        for ks in k_combos:
            yield comm_ids, impls, ks


def _flatten(axis) -> tuple:
    if isinstance(axis, tuple):
        out = []
        for a in axis:
            out.extend(_flatten(a))
        return tuple(out)
    return (axis,)


def enumerate_schedule_candidates(
        shape: Sequence[int],
        axis_sizes: Mapping[str, int],
        *,
        overlap_ks: Sequence[int] = DEFAULT_OVERLAP_KS,
        stage_impls: Sequence[str] = ("alltoall", "ring"),
        local_impl="matmul",
        layouts: Sequence[str] = DEFAULT_LAYOUTS,
        problem: str = "c2c",
        max_transposes: int = 4,
) -> list[ScheduleCandidate]:
    """The schedule-space search: every buildable pipeline over every
    slab/pencil decomposition — alternative transpose orders (including
    z-first spectral orders), fused vs split FFT/transpose stages, and
    per-stage impl/K overrides — normalized and deduped by plan token.

    Candidates already expressible by the fixed builders are *excluded*
    (they are exactly the knob space ``enumerate_candidates`` emits; the
    planner unions both lists and ``dedupe_candidates`` keeps one copy).
    Cell decompositions are out of scope: their regroup/scatter stages
    carry packing ops the symbolic move space does not model.
    """
    if problem not in SCHED_PROBLEMS:
        raise ValueError(f"schedule search covers {SCHED_PROBLEMS}, "
                         f"got {problem!r}")
    out, seen = [], set()
    for dec in decompositions_for(shape, axis_sizes, overlap_k=1):
        if dec.kind == "cell":
            continue
        for moves, layout_kind in _orders(dec, layouts, max_transposes):
            for fuse in (True, False):
                stages = _pack_stages(moves, fuse)
                base_opts = FFTOptions(overlap_k=1, local_impl=local_impl,
                                       output_layout=layout_kind,
                                       transpose_impl="alltoall")
                probe = ScheduleCandidate(dec, base_opts, stages,
                                          problem=problem)
                try:
                    sched = probe.build_schedule()
                except Exception:
                    continue
                if not _layouts_divisible(sched, shape, axis_sizes):
                    continue
                for comm_ids, impls, ks in _override_combos(
                        stages, dec, sched, shape, axis_sizes,
                        stage_impls, overlap_ks):
                    spec = list(stages)
                    for i, im, k in zip(comm_ids, impls, ks):
                        spec[i] = dataclasses.replace(spec[i], impl=im, k=k)
                    cand = ScheduleCandidate(dec, base_opts, tuple(spec),
                                             problem=problem).normalized()
                    if cand.as_options_candidate() is not None:
                        continue
                    if cand.plan_key in seen:
                        continue
                    seen.add(cand.plan_key)
                    out.append(cand)
    return out
