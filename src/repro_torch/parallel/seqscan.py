"""LASP-style sequence-parallel linear recurrences.

Port of ``repro/parallel/seqscan.py``.  When the sequence axis is
sharded over a mesh axis (context parallelism), a linear recurrence
needs its state threaded across shards.  Both RG-LRU (vector state) and
RWKV-6 (matrix state) updates are affine maps, so shard composition is
associative and the cross-shard prefix is a log-depth Hillis–Steele scan
over ``Mesh.ppermute`` steps: the distributed analogue of the chunked
scans in ``models/recurrent.py``, and the sequence-domain cousin of
CROFT's transpose pipeline.

Each function works on this rank's block, as ``distributed_seq_fft``
does, and every rank of the axis calls it: one local pass (state
starting from zero), a log-depth exclusive prefix of (total decay,
contribution) across shards (⌈log2 P⌉ rounds plus one shift, each a
``ppermute`` of both tensors), a cheap local correction, and the final
state broadcast from the last rank with one ``Mesh.all_reduce`` (the
reference's ``psum``).  The transfers go through ``Mesh.permute``,
whose gradient flows back along the inverse pairs, so a training pass
differentiates through the scan.  Every rank applies every round's
combine: a rank that receives nothing gets zeros, the combine's identity
(log-decay 0, contribution 0), which leaves its values as they were
bit for bit and keeps every rank's backward in step.

A block-per-rank port also owes the layers what GSPMD gives the
reference for free: the halo of the previous rank's last inputs
(:func:`cp_halo`: RWKV's token shift, RG-LRU's causal conv) and, after a
prefill, the new state from the last rank of the axis
(:func:`from_last_rank`).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import recurrent as rec


def _prefix_scan(combine: Callable, local: tuple, mesh, axis) -> tuple:
    """Hillis–Steele inclusive scan over the mesh axis, then shift by one
    rank to make it exclusive (rank 0 receives zeros, the identity)."""
    n = mesh.axis_size(axis)
    acc = local
    d = 1
    while d < n:
        perm = [(i, i + d) for i in range(n - d)]
        incoming = tuple(mesh.permute(x, axis, perm) for x in acc)
        acc = combine(incoming, acc)           # incoming applied first
        d *= 2
    perm1 = [(i, i + 1) for i in range(n - 1)]
    return tuple(mesh.permute(x, axis, perm1) for x in acc)


def from_last_rank(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The last rank's ``x`` on every rank of the axis (a summed
    all-reduce of it and zeros, as the reference's ``psum``).  Not
    differentiated: it carries the state a pass leaves behind."""
    last = mesh.axis_index(axis) == mesh.axis_size(axis) - 1
    x = x.detach()
    buf = x.clone(memory_format=torch.contiguous_format) if last \
        else torch.zeros_like(x, memory_format=torch.contiguous_format)
    return mesh.all_reduce(buf, axis).wait()


def cp_halo(x: torch.Tensor, mesh, axis, width: int = 1,
            first: torch.Tensor = None) -> torch.Tensor:
    """The ``width`` positions that precede this rank's block x (B, T, ...)
    of a sequence split over ``axis``: the previous rank's last ``width``
    (one ``Mesh.permute``).  Rank 0 takes ``first`` (B, width, ...), the
    state a cache carries in, or, when it is None, the zeros it receives
    (a pass from the start of the sequence; pass None under autograd, so
    that every rank consumes its transfer)."""
    n = mesh.axis_size(axis)
    got = mesh.permute(x[:, x.shape[1] - width:].contiguous(), axis,
                       [(i, i + 1) for i in range(n - 1)])
    if first is not None and mesh.axis_index(axis) == 0:
        return first.to(x.dtype)
    return got


def cp_vector_recurrence(log_a, b, h0, *, mesh, cp_axis, batch_spec=None,
                         chunk: int = 256):
    """Distributed ``rec.vector_recurrence`` on this rank's (B, T/P, D)
    block of a sequence sharded over ``cp_axis``; h0 (B, D) is the same
    on every rank of the axis.  ``batch_spec`` names the axis the batch
    is sharded over (the reference's ``shard_map`` spec); each rank holds
    its own batch block, so the computation does not read it.  Returns
    (h, the global final state)."""
    del batch_spec
    h_loc, h_last = rec.vector_recurrence(log_a, b, torch.zeros_like(h0),
                                          chunk)
    l_tot = log_a.sum(1)                                    # (B, D)

    def combine(first, second):
        lf, cf = first
        ls, cs = second
        return lf + ls, torch.exp(ls) * cf + cs

    l_ex, c_ex = _prefix_scan(combine, (l_tot, h_last), mesh, cp_axis)
    h_in = torch.exp(l_ex) * h0 + c_ex          # state entering the shard
    # correction: h_t += exp(cum log_a through t) * h_in
    h = h_loc + torch.exp(log_a.cumsum(1)) * h_in[:, None, :]
    return h, from_last_rank(h[:, -1], mesh, cp_axis)


def cp_matrix_recurrence(log_w, k, v, r, u, s0, *, mesh, cp_axis,
                         batch_spec=None, chunk: int = 64):
    """Distributed ``rec.matrix_recurrence`` on this rank's (B, T/P, H, *)
    blocks of a sequence sharded over ``cp_axis``; s0 (B, H, K, V) and
    u (H, K) are the same on every rank of the axis.  Returns (o, the
    global final state)."""
    del batch_spec
    o_loc, s_loc = rec.matrix_recurrence(log_w, k, v, r, u,
                                         torch.zeros_like(s0), chunk)
    l_tot = log_w.sum(1)                                    # (B, H, K)

    def combine(first, second):
        lf, cf = first
        ls, cs = second
        return lf + ls, torch.exp(ls)[..., None] * cf + cs

    l_ex, c_ex = _prefix_scan(combine, (l_tot, s_loc), mesh, cp_axis)
    s_in = torch.exp(l_ex)[..., None] * s0 + c_ex
    # correction: o_t += (r_t ⊙ exp(cum log_w through t-1)) · s_in
    dcum = log_w.cumsum(1)
    d_prev = dcum - log_w
    o = o_loc + torch.einsum("bthk,bhkv->bthv", r * torch.exp(d_prev), s_in)
    s_out = torch.exp(dcum[:, -1])[..., None] * s_in + s_loc
    return o, from_last_rank(s_out, mesh, cp_axis)
