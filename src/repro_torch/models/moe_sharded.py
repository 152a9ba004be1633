"""Sharding-explicit MoE dispatch over a mesh.

Port of ``repro/models/moe_sharded.py``.  The reference pins the
communication of ``moe.moe_fwd`` down with ``shard_map``; here every rank
runs :func:`moe_fwd_sharded` on its own block, as
``models/spectral.py:distributed_seq_fft`` does:

  mode "ep"  (E divisible by the tp axis, tokens sequence-sharded):
      each rank dispatches its local tokens into a local (E, C, D)
      buffer; ONE all-to-all over the tp axis swaps the expert dim for
      the capacity dim, through CROFT's K-chunked stage
      (``core.distributed._stage``, chunks on the model dim: a pencil
      transpose of real blocks); the rank's experts compute; the reverse
      stage restores the token layout.

  mode "tp"  (otherwise):
      no token movement: every rank holds the same tokens, dispatches
      locally and computes ALL experts with ffn-dim-sliced weights; the
      only collective is the all-reduce of the combined output.

Both modes keep the router numerics of ``moe.moe_fwd``.  The weights a
rank needs are its block of the full ``MoE`` (:func:`shard_moe`); on a
mesh ``models.model.forward`` routes MoE layers here outside decode and
hands each rank its experts' (or ffn columns') block of the layer's
weights.  Both modes are differentiable: the transposes' adjoints are
the transposes back, the all-reduce's is the all-reduce.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.distributed import FFTOptions, transpose_stage
from repro_torch.models.config import MoESpec
from repro_torch.models.layers import ffn_fwd
from repro_torch.models.moe import (MoE, _capacity, _combine, _dispatch,
                                    _experts)


def moe_mode(m: MoESpec, mesh, cp_axis, tp_axis: str) -> str:
    """"ep" when the experts divide the tp axis and the tokens are
    sequence-sharded (decode segments are too small to shuffle), else
    "tp"."""
    tp = mesh.axis_size(tp_axis)
    return "ep" if m.n_experts % tp == 0 and cp_axis is not None else "tp"


def shard_moe(p: MoE, m: MoESpec, mesh, *, cp_axis, tp_axis: str) -> MoE:
    """This rank's block of the full ``p``: its E/|tp| experts ("ep"), or
    every expert's ffn columns f/|tp| ("tp"), as copies; the router and
    the shared experts are whole (shared with ``p``)."""
    n, i = mesh.axis_size(tp_axis), mesh.axis_index(tp_axis)
    local = MoE(p.router.shape[0], m, "meta")  # every tensor replaced below
    if moe_mode(m, mesh, cp_axis, tp_axis) == "ep":
        e = m.n_experts // n
        cut = {name: getattr(p, name)[i * e:(i + 1) * e]
               for name in ("w_gate", "w_up", "w_down")}
    else:
        if m.d_ff_expert % n:
            raise ValueError(f"tp mode: d_ff_expert {m.d_ff_expert} does "
                             f"not divide over {n} ranks")
        f = m.d_ff_expert // n
        cut = {"w_gate": p.w_gate[:, :, i * f:(i + 1) * f],
               "w_up": p.w_up[:, :, i * f:(i + 1) * f],
               "w_down": p.w_down[:, i * f:(i + 1) * f]}
    for name, w in cut.items():
        setattr(local, name, nn.Parameter(w.clone(), requires_grad=False))
    local.router = p.router
    if m.n_shared:
        local.shared = p.shared
    return local


def moe_fwd_sharded(p: MoE, x: torch.Tensor, m: MoESpec, *, mesh,
                    cp_axis, tp_axis: str, overlap_k: int = 2
                    ) -> torch.Tensor:
    """This rank's block x (B_loc, S_loc, D) -> the same block of the
    output; every rank of the mesh calls it.  ``p`` is this rank's block
    of the weights (:func:`shard_moe`).

    The mode (:func:`moe_mode`) fixes the token layout, as the
    reference's ``shard_map`` specs do: "ep" takes the (dp, cp_axis)
    block, "tp" the dp block with the whole sequence (the same tokens on
    every rank of ``tp_axis``).  Each rank holds its own batch block, so
    the reference's ``dp`` axis argument has no counterpart here.  The
    capacity is the local token count's.
    """
    bb, ss, d = x.shape
    t = bb * ss
    n = mesh.axis_size(tp_axis)
    mode = moe_mode(m, mesh, cp_axis, tp_axis)
    want = ((m.n_experts // n, d, m.d_ff_expert) if mode == "ep"
            else (m.n_experts, d, m.d_ff_expert // n))
    if tuple(p.w_gate.shape) != want:
        raise ValueError(f"{mode} mode wants this rank's w_gate block {want}, "
                         f"got {tuple(p.w_gate.shape)} (see shard_moe)")
    xt = x.reshape(t, d)
    buf, meta = _dispatch(xt, p.router, m, _capacity(t, m))
    if mode == "ep":
        # CROFT transpose: expert dim scattered out, capacity gathered,
        # (E, C, D) -> (E/tp, C*tp, D), K chunks on D for the overlap
        opts = FFTOptions(overlap_k=overlap_k)
        buf = transpose_stage(buf, comm_axis=tp_axis, split_axis=0,
                              concat_axis=1, chunk_axis=2, opts=opts,
                              mesh=mesh)
        y = _experts(buf, p.w_gate, p.w_up, p.w_down)
        y = transpose_stage(y, comm_axis=tp_axis, split_axis=1,
                            concat_axis=0, chunk_axis=2, opts=opts,
                            mesh=mesh)
        out = _combine(y, meta, t, d, x.dtype)
    else:
        y = _experts(buf, p.w_gate, p.w_up, p.w_down)
        # the combine is linear in y: all-reduce after it, so the wire
        # carries (T, D) tokens, not the k*capacity-padded buffer
        out = mesh.psum(_combine(y, meta, t, d, x.dtype), tp_axis)
    if m.n_shared:
        out = out + ffn_fwd(p.shared, xt, "swiglu")
    return out.reshape(bb, ss, d)
