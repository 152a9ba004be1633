"""Named mesh axes over ``torch.distributed`` process groups.

New in the port: it stands in for the reference's ``jax.sharding.Mesh``
+ ``shard_map`` + ``lax.axis_index``/``axis_size``/``all_to_all``/
``ppermute``.  Every rank runs the same program on its own local block;
a mesh axis is one process group per line of the mesh
(``torch.distributed.device_mesh``), and a folded axis (a tuple of
names, major first) one group per line of its set of axes, made for
every set when the mesh is made.  ``mesh=None`` (one rank) is the
meshless path, as in the reference.

Collectives are issued asynchronously and return a :class:`Pending`;
the caller waits where it consumes the result, so the executor can issue
chunk i's collective and go on with chunk i+1's FFT (the paper's
communication thread).  :meth:`Mesh.reshard` (any block layout to any
other, the port of the reference's sharding constraint) and
:meth:`Mesh.gather` (a whole array on every rank) run outside the stage
list and return the result.

The process group's backend is the caller's choice, made when it calls
``torch.distributed.init_process_group``.  NCCL moves CUDA tensors
itself.  A gloo group (torch 2.11, on an H100) takes CUDA tensors for
``all_to_all_single`` but not for ``batch_isend_irecv`` (its TCP
transport then writes from the device pointer and fails), so for a CUDA
tensor each point-to-point piece is copied to pinned host memory before
the wire and back after it: that copy is the transport of a gloo group,
written once in :meth:`Mesh._to_wire`/:meth:`Mesh._from_wire` and
counted in ``host_staged_bytes``.  The code never switches backend by
itself.

:meth:`Mesh.counting` counts, per kind, what the collectives put on the
wire (the port's stand-in for counting collectives in compiled HLO): one
``"all-to-all"`` per ``all_to_all_single`` (:meth:`Mesh.all_to_all`,
:meth:`Mesh.reshard`, :meth:`Mesh.mirror`, :meth:`Mesh.gather`), one
``"collective-permute"`` per point-to-point round of
:meth:`Mesh.exchange` and one ``"all-reduce"`` per
:meth:`Mesh.all_reduce` (a sum or a max), with the bytes this rank
hands them.

An NCCL group makes its communicator at its first collective.  The
host seconds of the mesh's folded groups (``dist.new_group``) and of
the first collective on each group go into the process registry's
``mesh_comm_init_seconds`` counter (one clock read per group, once).
:meth:`Mesh.all_to_all` and :meth:`Mesh.exchange` open the executor's
``transpose:pack``/``transpose:collective``/``transpose:unpack`` spans
(``repro_torch.obs.tracer.span``).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.decomposition import spec_slices
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.tracer import span

COMM_INIT = "mesh_comm_init_seconds"
_WARM = contextlib.nullcontext()


@contextlib.contextmanager
def _comm_init_timed():
    """Add the scope's host seconds to ``mesh_comm_init_seconds``."""
    t = time.perf_counter()
    try:
        yield
    finally:
        metrics_lib.get_registry().counter(
            COMM_INIT, "host seconds of NCCL groups and their communicators"
        ).inc(time.perf_counter() - t)


class Pending:
    """A collective in flight: :meth:`wait` blocks on its work handles,
    then runs ``finish`` (unstaging, reshaping, unpacking) and returns
    the result."""

    def __init__(self, works: Sequence = (),
                 finish: Optional[Callable[[], torch.Tensor]] = None):
        self._works = list(works)
        self._finish = finish

    @classmethod
    def done(cls, value: torch.Tensor) -> "Pending":
        return cls((), lambda: value)

    @property
    def in_flight(self) -> bool:
        """Whether a collective is posted and not yet waited on."""
        return bool(self._works)

    def wait(self) -> torch.Tensor:
        works, self._works = self._works, []
        for w in works:
            w.wait()
        return self._finish()


class CollectiveCount:
    """Per-kind collective launches and bytes on one rank, the reference's
    HLO collective statistics in the same form: ``collectives`` maps a
    kind to ``{"count": n, "bytes": b}``.

    The bytes are what this rank hands each collective to send, as the
    reference counts a collective's operand: an all-to-all's whole send
    buffer (the chunk a rank sends itself included), a ring or pairwise
    round's one piece (the piece a rank keeps is never sent)."""

    def __init__(self):
        self.collectives: dict = {}

    def add(self, kind: str, nbytes: int) -> None:
        e = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += int(nbytes)

    @property
    def counts(self) -> dict:
        return {k: e["count"] for k, e in self.collectives.items()}

    @property
    def bytes(self) -> int:
        return sum(e["bytes"] for e in self.collectives.values())


class Mesh:
    """A named mesh of ranks; build with :func:`make_mesh`."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = dist.get_backend()
        self.host_staged_bytes = 0
        self.reshard_bytes = 0
        self._members = {}
        self._moves = {}
        # every rank's coordinates as plain ints, read from the device
        # mesh's tensor once: no tensor indexing after construction (a
        # reshard under FakeTensorMode reads no value)
        grid = device_mesh.mesh
        self._coords = [None] * math.prod(grid.shape)
        self._rank_at = {}
        for idx, r in zip(itertools.product(*(range(n) for n in grid.shape)),
                          grid.reshape(-1).tolist()):
            self._coords[r] = dict(zip(self.axis_names, idx))
            self._rank_at[idx] = r
        self._warm = set()
        with _comm_init_timed():
            self._folded = self._fold_groups()
        self._count: Optional[CollectiveCount] = None

    @contextlib.contextmanager
    def counting(self):
        """Count this rank's collectives inside the scope (host-side
        bookkeeping from tensor shapes: no synchronisation, nothing
        launched).  Yields the :class:`CollectiveCount`."""
        prev, self._count = self._count, CollectiveCount()
        try:
            yield self._count
        finally:
            self._count = prev

    def _counted(self, kind: str, nbytes: int) -> None:
        if self._count is not None:
            self._count.add(kind, nbytes)

    def _first_use(self, group):
        """The scope of a collective on ``group``: the first on each group
        (where NCCL makes its communicator) is timed into
        ``mesh_comm_init_seconds``, every later one gets a shared null
        context."""
        if group in self._warm:
            return _WARM
        self._warm.add(group)
        return _comm_init_timed()

    def _fold_groups(self) -> dict:
        """One process group per line of every set of two or more axes,
        keyed by the set.  ``dist.new_group`` is collective over the
        whole world, so every rank makes every group, in the same order,
        here and not on first use (ranks that reached different stages
        would wait on each other's groups)."""
        names = self.axis_names
        grid = self.device_mesh.mesh
        mine = {}
        for k in range(2, len(names) + 1):
            for subset in itertools.combinations(range(len(names)), k):
                rest = [d for d in range(len(names)) if d not in subset]
                lines = grid.permute(*rest, *subset).reshape(
                    -1, math.prod(grid.shape[d] for d in subset))
                for line in lines.tolist():
                    group = dist.new_group(sorted(line))
                    if dist.get_rank() in line:
                        mine[frozenset(names[d] for d in subset)] = group
        return mine

    def close(self) -> None:
        """Destroy the process groups this mesh made, on every rank in one
        order: the folded axes' groups (by their axis names), then the
        device mesh's own (last axis first).  Call it on every rank once
        the mesh's last collective has run, before
        ``destroy_process_group``; the mesh is unusable after."""
        if self.device_mesh is None:
            return
        groups = [self._folded[k] for k in sorted(self._folded, key=sorted)]
        groups += [self.device_mesh.get_group(a)
                   for a in reversed(self.axis_names)]
        # drop this mesh's references, so that plans still holding the
        # mesh (the autograd plan caches) hold no group past this call
        self._folded, self.device_mesh = {}, None
        for g in groups:
            if g is not dist.GroupMember.WORLD and g in _live_groups():
                dist.destroy_process_group(g)

    # -- shape and coordinates ----------------------------------------------
    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return math.prod(self.device_mesh.shape)

    @property
    def coords(self) -> dict:
        """This rank's index along every axis."""
        return {a: self.device_mesh.get_local_rank(a) for a in self.axis_names}

    def axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    def axis_index(self, axis) -> int:
        """Index along ``axis``; a folded axis counts major-first."""
        if isinstance(axis, tuple):
            idx = 0
            for a in axis:
                idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
            return idx
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis):
        """The process group of this rank's line along ``axis``; a folded
        axis (a tuple of names) takes the group of its set of axes."""
        if isinstance(axis, tuple):
            return self._folded[frozenset(axis)]
        return self.device_mesh.get_group(axis)

    def members(self, axis) -> list:
        """Global ranks of this rank's line along ``axis``, by index along
        it (a folded axis counts major-first, as :meth:`axis_index`)."""
        got = self._members.get(axis)
        if got is None:
            names = axis if isinstance(axis, tuple) else (axis,)
            here = self.coords
            got = []
            for idx in itertools.product(*(range(self.shape[a])
                                           for a in names)):
                at = dict(here, **dict(zip(names, idx)))
                got.append(self._rank_at[tuple(at[a]
                                               for a in self.axis_names)])
            self._members[axis] = got
        return got

    def _group_order(self, axis) -> Optional[list]:
        """Group rank of each index along ``axis``, or None where the two
        agree.  A group numbers its ranks in increasing global rank; a
        fold whose major axis is not the mesh's major one (the cell's
        (y, x) communicator) counts them in another order."""
        members = self.members(axis)
        ranked = sorted(members)
        order = [ranked.index(m) for m in members]
        return None if order == sorted(order) else order

    # -- the gloo transport of point-to-point pieces -------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if not self._staged(t):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.host_staged_bytes += t.numel() * t.element_size()
        return host

    def _wire_buffer(self, like: torch.Tensor) -> torch.Tensor:
        if not self._staged(like):
            return like
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _from_wire(self, wire: torch.Tensor, dst: torch.Tensor) -> None:
        if wire is not dst:
            dst.copy_(wire)
            self.host_staged_bytes += wire.numel() * wire.element_size()

    # -- collectives ---------------------------------------------------------
    def all_to_all(self, x: torch.Tensor, axis, split_axis: int,
                   concat_axis: int) -> Pending:
        """Tiled all-to-all over ``axis`` (``jax.lax.all_to_all(...,
        tiled=True)``): ``split_axis`` is cut into P chunks, chunk j goes
        to rank j, and the received chunks are concatenated along
        ``concat_axis`` in source order.  Its unpack span opens after
        the wait."""
        p = self.axis_size(axis)
        if p == 1:
            return Pending.done(x)
        shape = list(x.shape)
        if shape[split_axis] % p:
            raise ValueError(f"split axis extent {shape[split_axis]} not "
                             f"divisible by {p}")
        piece = list(shape)
        piece[split_axis] //= p
        with span("transpose:pack", "pack", self.device):
            chunks = (x.reshape(shape[:split_axis] + [p, piece[split_axis]]
                                + shape[split_axis + 1:])
                      .movedim(split_axis, 0))
            order = (self._group_order(axis) if isinstance(axis, tuple)
                     else None)
            if order is not None:
                # chunk j goes to the group rank of index j, and what
                # group rank order[j] sends lands at index j
                chunks = chunks[torch.tensor(
                    sorted(range(p), key=order.__getitem__),
                    device=x.device)]
            chunks = chunks.contiguous()
        nbytes = chunks.numel() * chunks.element_size()
        group = self.group(axis)
        with span("transpose:collective", "collective", bytes=nbytes):
            recv = torch.empty_like(chunks)
            self._counted("all-to-all", nbytes)
            with self._first_use(group):
                work = dist.all_to_all_single(recv, chunks, group=group,
                                              async_op=True)

        def finish():
            with span("transpose:unpack", "unpack", self.device):
                out = list(piece)
                out[concat_axis] *= p
                got = recv if order is None else recv[torch.tensor(
                    order, device=recv.device)]
                return got.movedim(0, concat_axis).reshape(out)
        return Pending([work], finish)

    def all_reduce(self, x: torch.Tensor, axis,
                   op=dist.ReduceOp.SUM) -> Pending:
        """Sum (``jax.lax.psum``), or another ``op`` (``ReduceOp.MAX``:
        ``jax.lax.pmax``), over ``axis``, into ``x`` in place (a
        contiguous tensor); the result is ``x``.  Counted as one
        ``"all-reduce"`` whatever the op, as the reference's HLO counts
        a ``pmax``."""
        if self.axis_size(axis) == 1:
            return Pending.done(x)
        if not x.is_contiguous():
            raise ValueError("all_reduce sums in place: x must be contiguous")
        self._counted("all-reduce", x.numel() * x.element_size())
        group = self.group(axis)
        with self._first_use(group):
            work = dist.all_reduce(x, op=op, group=group, async_op=True)
        return Pending([work], lambda: x)

    def exchange(self, sends: Sequence, recvs: Sequence, axis) -> Pending:
        """Point-to-point transfers over ``axis``, all posted at once:
        ``sends`` are (tensor, destination index), ``recvs`` (contiguous
        buffer, source index); indices count along the axis.  The buffers
        hold the received data once the result is waited on."""
        group = self.group(axis)
        ops, landings = [], []
        nbytes = sum(t.numel() * t.element_size() for t, _ in sends)
        with span("transpose:collective", "collective", bytes=nbytes):
            for t, dst in sends:
                self._counted("collective-permute",
                              t.numel() * t.element_size())
                ops.append(dist.P2POp(dist.isend, self._to_wire(t),
                                      dist.get_global_rank(group, dst),
                                      group))
            for buf, src in recvs:
                wire = self._wire_buffer(buf)
                landings.append((wire, buf))
                ops.append(dist.P2POp(dist.irecv, wire,
                                      dist.get_global_rank(group, src),
                                      group))
            with self._first_use(group):
                works = dist.batch_isend_irecv(ops) if ops else []

        def finish():
            for wire, buf in landings:
                self._from_wire(wire, buf)
        return Pending(works, finish)

    def rank_coords(self) -> list:
        """Mesh coordinates of every rank, indexed by global rank (a new
        list of the table made once, at construction)."""
        return [dict(c) for c in self._coords]

    def reshard(self, blk: torch.Tensor, shape: Sequence[int], src_spec,
                dst_spec) -> torch.Tensor:
        """This rank's block of the global array ``shape`` (the trailing
        dims of ``blk``; leading dims ride along) laid out by
        ``src_spec``, re-laid out by ``dst_spec``, as one all-to-all over
        every rank of the mesh.

        Each rank sends every rank the intersection of its source block
        with that rank's destination block, and places what it receives
        by the sender's intersection (``decomposition.spec_slices``);
        where the source is replicated, only the lowest rank of each
        replica set sends.  Two per-axis transposes cannot do this when a
        dim's shards nest (pencil y: Py-major, then Pz).
        ``reshard_bytes`` counts what left this rank.

        Differentiable: the gradient is the reshard back.  A replicated
        block stands for one global array, as in the reference: the
        gradient of a replicated destination is read from one replica
        (all replicas must hold the same gradient), and a replicated
        source gets the gradient on every replica."""
        return _Move.apply(blk, self, tuple(shape), tuple(src_spec),
                           tuple(dst_spec), ())

    def mirror(self, blk: torch.Tensor, shape: Sequence[int], spec,
               dims: Sequence[int]) -> torch.Tensor:
        """This rank's block, laid out by ``spec``, of the global array
        ``shape`` with each trailing dim in ``dims`` (negative indices)
        read backwards by k -> (-k) mod N (``packing.negate_freq``): a
        reshard of the mirrored block, never a gather.  Each rank sends
        every rank the part of its block that the mirror moves into that
        rank's block.  Differentiable, as :meth:`reshard`."""
        return _Move.apply(blk, self, tuple(shape), tuple(spec), tuple(spec),
                           tuple(sorted(d % len(spec) for d in dims)))

    def _move(self, blk: torch.Tensor, shape: tuple, src_spec: tuple,
              dst_spec: tuple, negate: tuple = ()) -> torch.Tensor:
        """The all-to-all of :meth:`reshard` and :meth:`mirror`, by this
        rank's plan for the block shape and layouts (:class:`_MovePlan`,
        made on first use and kept)."""
        key = (tuple(blk.shape), tuple(shape), src_spec, dst_spec, negate)
        plan = self._moves.get(key)
        if plan is None:
            plan = self._moves[key] = self._move_plan(*key)
        send = plan.pack(blk)
        recv = torch.empty(sum(plan.recv_sizes), dtype=blk.dtype,
                           device=blk.device)
        self.reshard_bytes += plan.sent * blk.element_size()
        self._counted("all-to-all", send.numel() * send.element_size())
        with self._first_use(None):
            dist.all_to_all_single(recv, send, plan.recv_sizes,
                                   plan.send_sizes)
        return plan.unpack(recv, blk)

    def _move_plan(self, blk_shape: tuple, shape: tuple, src_spec: tuple,
                   dst_spec: tuple, negate: tuple) -> "_MovePlan":
        """What this rank sends each rank and places from each, for
        :meth:`_move` (host arithmetic only: no tensor is made)."""
        nd = len(src_spec)
        lead = blk_shape[:len(blk_shape) - nd]
        grid = shape[len(shape) - nd:]
        sizes = self.shape
        src = [spec_slices(src_spec, shape, sizes, c) for c in self._coords]
        dst = [spec_slices(dst_spec, shape, sizes, c) for c in self._coords]
        first = {}
        for r, box in enumerate(src):
            first.setdefault(tuple((b.start, b.stop) for b in box), r)
        canon = [first[tuple((b.start, b.stop) for b in box)] == r
                 for r, box in enumerate(src)]
        me = dist.get_rank()
        want = tuple(s.stop - s.start for s in src[me])
        if blk_shape[len(lead):] != want:
            raise ValueError(f"block {blk_shape} is not this rank's "
                             f"{want} block of {shape}")

        def link(s, d):
            """Per dim (selection in d's block, selection in s's block) of
            what source rank s gives destination rank d, or None."""
            if not canon[s]:
                return None
            out = []
            for i, (a, b) in enumerate(zip(src[s], dst[d])):
                if i in negate:
                    k = np.arange(b.start, b.stop)
                    m = (-k) % grid[i]
                    keep = (m >= a.start) & (m < a.stop)
                    if not keep.any():
                        return None
                    out.append((k[keep] - b.start, m[keep] - a.start))
                    continue
                lo, hi = max(a.start, b.start), min(a.stop, b.stop)
                if lo >= hi:
                    return None
                out.append((slice(lo - b.start, hi - b.start),
                            slice(lo - a.start, hi - a.start)))
            return out

        return _MovePlan(lead, [link(me, d) for d in range(self.size)],
                         [link(s, me) for s in range(self.size)],
                         lead + tuple(b.stop - b.start for b in dst[me]), me)

    def gather(self, blk: torch.Tensor, shape: Sequence[int],
               spec) -> torch.Tensor:
        """The whole array ``shape`` on every rank, from this rank's block
        laid out by ``spec`` (a :meth:`reshard` to the replicated
        layout)."""
        return self.reshard(blk, shape, spec, (None,) * len(spec))

    def collect(self, blk: torch.Tensor, shape: Sequence[int],
                spec) -> Optional[torch.Tensor]:
        """The whole array ``shape`` in host memory on global rank 0,
        from this rank's block laid out by ``spec`` (one entry per dim);
        None on every other rank.  One all-to-all in which the lowest
        rank of each replica set sends its block to rank 0 and nothing
        else moves, so no other rank holds more than its own block, and
        rank 0 one received copy besides the array.  For checkpoints:
        not differentiable."""
        shape, spec = tuple(shape), tuple(spec)
        boxes = [spec_slices(spec, shape, self.shape, c)
                 for c in self.rank_coords()]
        first = {}
        for r, box in enumerate(boxes):
            first.setdefault(tuple((b.start, b.stop) for b in box), r)
        senders = sorted(first.values())
        extents = [[b.stop - b.start for b in box] for box in boxes]
        sizes = [math.prod(e) for e in extents]
        me = dist.get_rank()
        blk = blk.detach()
        send_sizes = [0] * self.size
        if me in senders:
            send_sizes[0] = sizes[me]
            send = blk.contiguous().reshape(-1)
        else:
            send = blk.new_empty(0)
        recv_sizes = [sizes[r] if me == 0 and r in senders else 0
                      for r in range(self.size)]
        recv = blk.new_empty(sum(recv_sizes))
        self._counted("all-to-all", send.numel() * send.element_size())
        with self._first_use(None):
            dist.all_to_all_single(recv, send, recv_sizes, send_sizes)
        if me != 0:
            return None
        out = torch.empty(shape, dtype=blk.dtype)
        at = 0
        for r in senders:
            out[boxes[r]] = recv[at:at + sizes[r]].reshape(extents[r])
            at += sizes[r]
        return out

    def ppermute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        """``jax.lax.ppermute``: ``perm`` lists (source, destination)
        index pairs along ``axis``; a rank no pair sends to gets zeros."""
        me = self.axis_index(axis)
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        sends = [(x.contiguous(), d) for s, d in perm if s == me]
        recvs = [(out, s) for s, d in perm if d == me]
        self.exchange(sends, recvs, axis).wait()
        return out

    # -- differentiable collectives of the sharded LM ------------------------
    def permute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        """:meth:`ppermute` under autograd: the gradient goes back along
        the inverse pairs.  Every rank of the axis must use the result
        (its backward is a collective): a rank that receives nothing gets
        zeros and must still consume them."""
        return _Permute.apply(x, self, axis, tuple(perm))

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Sum over ``axis`` (``jax.lax.psum``) into a new tensor, under
        autograd: every rank uses the sum, so the gradient of each
        summand is the sum of every rank's gradient of the result."""
        return _Psum.apply(x, self, axis)

    def gather_sum(self, blk: torch.Tensor, shape: Sequence[int], spec,
                   view, reduce=None) -> torch.Tensor:
        """This rank's block of the global array ``shape`` (trailing dims
        of ``blk``; leading dims ride along) laid out by ``spec``,
        re-laid out by the coarser ``view`` (each entry ``spec``'s or
        None): an all-gather over the axes ``view`` drops, through
        :meth:`reshard`'s all-to-all.

        Its adjoint sums: the gradient of the view is all-reduced over
        ``reduce`` (an axis, a tuple of axes, or None for none), then
        sliced to this rank's block.  That is what a weight gathered for
        a data-parallel step needs (each rank's gradient comes from its
        own tokens) and what K/V gathered along a sequence axis need
        (each rank's queries send gradient to every key).  The reshard's
        own adjoint, which reads one replica, is right only where every
        replica holds the same gradient (the FFT plans)."""
        spec, view = tuple(spec), tuple(view)
        reduce = axis_arg(reduce)
        if view == spec and (reduce is None or not (
                torch.is_grad_enabled() and blk.requires_grad)):
            return blk
        return _GatherSum.apply(blk, self, tuple(shape), spec, view, reduce)

    def block_of(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``full`` (trailing dims laid out by
        ``spec``), as a view."""
        box = spec_slices(spec, full.shape, self.shape, self.coords)
        return full[(Ellipsis,) + box]


class _MovePlan:
    """One rank's side of a move's all-to-all: ``sends[d]`` and
    ``recvs[s]`` are the per-dim links (selection in the destination's
    block, selection in the source's block) of what goes to rank d and
    comes from rank s, or None.  :meth:`pack` reads the rank's pieces out
    of its block into one send buffer and :meth:`unpack` places the
    received ones, each in as few tensor ops as the links allow: a block
    cut into a regular grid of pieces is one permuted copy, one piece
    sent to many ranks one repeated copy; other links (the mirror's
    index lists) take a slice and a copy a piece."""

    def __init__(self, lead: tuple, sends: list, recvs: list,
                 out_shape: tuple, me: int):
        def count(sels):
            return 0 if sels is None else math.prod(lead) * math.prod(
                len(x) if not isinstance(x, slice) else x.stop - x.start
                for x in sels)
        self.lead, self.out_shape = lead, out_shape
        self.send_sizes = [count(None if s is None else [p[1] for p in s])
                           for s in sends]
        self.recv_sizes = [count(None if s is None else [p[0] for p in s])
                           for s in recvs]
        self.sent = sum(n for d, n in enumerate(self.send_sizes) if d != me)
        self._sends = [[p[1] for p in s] for s in sends if s is not None]
        self._recvs = [[p[0] for p in s] for s in recvs if s is not None]

    def pack(self, blk: torch.Tensor) -> torch.Tensor:
        """The send buffer, contiguous (a collective's requirement) for
        any layout of ``blk``."""
        sels = self._sends
        if not sels:
            return blk.new_empty(0)
        if len(sels) > 1 and _plain(sels[0]) and all(
                s == sels[0] for s in sels):
            return blk[(Ellipsis,) + tuple(sels[0])].reshape(-1).repeat(
                len(sels))
        tiles = _tiling(sels, blk.shape[len(self.lead):])
        if tiles is None:
            pieces = [blk[_index(s, blk.device)].reshape(-1) for s in sels]
            return (torch.cat(pieces) if len(pieces) > 1
                    else pieces[0].contiguous())
        counts, order = tiles
        nl, nd = len(self.lead), len(counts)
        steps = [e // c for e, c in zip(blk.shape[nl:], counts)]
        x = blk.reshape(self.lead + tuple(
            v for c, st in zip(counts, steps) for v in (c, st)))
        x = x.permute([nl + 2 * i for i in range(nd)] + list(range(nl))
                      + [nl + 2 * i + 1 for i in range(nd)])
        x = x.reshape(len(order), -1)
        if order != sorted(order):
            # buffer piece k is grid piece f_k: order[f_k] = k
            f = sorted(range(len(order)), key=order.__getitem__)
            x = x[torch.tensor(f, device=blk.device)]
        return x.reshape(-1).contiguous()

    def unpack(self, recv: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
        sels = self._recvs
        tiles = _tiling(sels, self.out_shape[len(self.lead):])
        if tiles is None:
            out = torch.empty(self.out_shape, dtype=blk.dtype,
                              device=blk.device)
            at = 0
            for s in sels:
                ext = self.lead + tuple(
                    x.stop - x.start if isinstance(x, slice) else len(x)
                    for x in s)
                n = math.prod(ext)
                out[_index(s, blk.device)] = recv[at:at + n].reshape(ext)
                at += n
            return out
        counts, order = tiles
        nl, nd = len(self.lead), len(counts)
        steps = [e // c for e, c in zip(self.out_shape[nl:], counts)]
        x = recv.reshape(len(order), -1)
        if order != sorted(order):
            x = x[torch.tensor(order, device=recv.device)]
        x = x.reshape(tuple(counts) + self.lead + tuple(steps))
        perm = list(range(nd, nd + nl))
        for i in range(nd):
            perm += [i, nd + nl + i]
        return x.permute(perm).reshape(self.out_shape)


def _plain(sels) -> bool:
    return all(isinstance(x, slice) for x in sels)


def _index(sels, device) -> tuple:
    """The indexing tuple of a link's selections: basic slices, or (a
    mirror's) broadcast index tensors, one per dim."""
    if _plain(sels):
        return (Ellipsis,) + tuple(sels)
    nd = len(sels)
    return (Ellipsis,) + tuple(
        (torch.arange(x.start, x.stop) if isinstance(x, slice)
         else torch.from_numpy(x)).to(device).view(
            [-1 if i == d else 1 for i in range(nd)])
        for d, x in enumerate(sels))


def _tiling(boxes: list, extents) -> Optional[tuple]:
    """(counts, order) when ``boxes`` (per-dim slices, in buffer order)
    tile a block of ``extents`` as a regular grid: ``counts[i]`` equal
    pieces along dim i, and ``order[f]`` the buffer position of the
    piece at row-major grid index f.  None otherwise."""
    if not boxes or not all(_plain(b) for b in boxes):
        return None
    counts, flat = [], [0] * len(boxes)
    for i, e in enumerate(extents):
        starts = sorted({b[i].start for b in boxes})
        step = e // len(starts) if e else 0
        if not step or starts != list(range(0, e, step)) or any(
                b[i].stop - b[i].start != step for b in boxes):
            return None
        counts.append(len(starts))
        for k, b in enumerate(boxes):
            flat[k] = flat[k] * len(starts) + b[i].start // step
    if sorted(flat) != list(range(math.prod(counts))):
        return None
    order = [0] * len(flat)
    for k, f in enumerate(flat):
        order[f] = k
    return counts, order


def axis_arg(axes):
    """An axis argument of the collectives from a name, a tuple of names
    or None: a 1-tuple is its name, an empty one None."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _live_groups():
    """The process groups ``torch.distributed`` still holds."""
    return dist.distributed_c10d._world.pg_map


class _Move(torch.autograd.Function):
    """:meth:`Mesh.reshard`/:meth:`Mesh.mirror` under autograd: a copy of
    elements between ranks, so its adjoint is the move back (the mirror
    is its own inverse)."""

    @staticmethod
    def forward(ctx, blk, mesh, shape, src_spec, dst_spec, negate):
        ctx.args = (mesh, shape, src_spec, dst_spec, negate)
        return mesh._move(blk, shape, src_spec, dst_spec, negate)

    @staticmethod
    def backward(ctx, g):
        mesh, shape, src_spec, dst_spec, negate = ctx.args
        return (mesh._move(g.contiguous(), shape, dst_spec, src_spec, negate),
                None, None, None, None, None)


class _Permute(torch.autograd.Function):
    """:meth:`Mesh.permute`: the adjoint of a permutation of blocks is the
    permutation back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return mesh.ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        back = [(d, s) for s, d in perm]
        return mesh.ppermute(g.contiguous(), axis, back), None, None, None


class _Psum(torch.autograd.Function):
    """:meth:`Mesh.psum`: y = sum of every rank's x, used by every rank, so
    dL/dx = sum of every rank's dL/dy."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axis).wait()

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return (mesh.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                axis).wait(), None, None)


class _GatherSum(torch.autograd.Function):
    """:meth:`Mesh.gather_sum`: the reshard to the coarser view forward;
    backward, the sum over ``reduce`` and this rank's slice of it."""

    @staticmethod
    def forward(ctx, blk, mesh, shape, spec, view, reduce):
        ctx.args = (mesh, shape, spec, view, reduce)
        if view == spec:
            return blk.clone()
        return mesh._move(blk.contiguous(), shape, spec, view)

    @staticmethod
    def backward(ctx, g):
        mesh, shape, spec, view, reduce = ctx.args
        g = g.clone(memory_format=torch.contiguous_format)
        if reduce is not None:
            g = mesh.all_reduce(g, reduce).wait()
        if view != spec:
            sizes, coords = mesh.shape, mesh.coords
            mine = spec_slices(spec, shape, sizes, coords)
            held = spec_slices(view, shape, sizes, coords)
            g = g[(Ellipsis,) + tuple(
                slice(a.start - b.start, a.stop - b.start)
                for a, b in zip(mine, held))]
        return g, None, None, None, None, None


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh over the default process group (initialized by the
    caller, with the backend it names), ranks laid out row-major like
    ``jax.make_mesh``.  Local blocks live on ``device`` (the CUDA card
    unless the caller passes ``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group "
                           "first")
    if math.prod(axis_sizes) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(axis_sizes)} does not cover "
                         f"{dist.get_world_size()} ranks")
    # the device mesh's own type only selects how it builds its groups:
    # gloo (and the dry run's fake) groups are built as a "cpu" mesh,
    # whatever holds the blocks
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, tuple(axis_sizes),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dm, resolve_device(device))
