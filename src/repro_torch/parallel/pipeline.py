"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis).

Port of ``repro/parallel/pipeline.py``.  The production meshes run the
pod axis as pure data parallelism; at >2 pods, or when per-pod memory is
the binding constraint, pipeline staging is the alternative.  The
schedule:

  * stage p holds layers [p·L/P, (p+1)·L/P) — this rank's block of the
    stacked leaves along ``stage_axis`` (``Mesh.block_of``), or with
    ``local=True`` the only layers the caller gave it;
  * microbatches flow stage to stage through ``Mesh.permute`` (i -> i+1)
    with the GPipe schedule: step t processes microbatch (t - stage) at
    each stage, so a P-stage pipeline with M microbatches takes M + P - 1
    steps (bubble fraction (P-1)/(M+P-1));
  * both collectives are differentiable, so a backward through the
    pipelined forward is the pipelined backward.

``pipeline_apply`` is model-agnostic: it pipelines any ``layer_fn(params,
h) -> h`` whose stacked params divide across stages.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(layer_fn: Callable, stacked_params, x, *, mesh,
                   stage_axis: str, n_micro: int, local: bool = False):
    """Run ``x`` through all stacked layers, pipelined over ``stage_axis``
    of ``mesh`` (a ``core.mesh.Mesh``); every rank calls it with the same
    arguments, in the same order as its other collectives.

    layer_fn(params_l, h) -> h applies ONE layer; ``params_l`` is the
    tree of ``stacked_params`` at one layer.
    stacked_params: a tree (dicts, lists, tuples) of tensors with leading
    layer axis L (L % n_stages == 0), whole on every rank, as the
    reference's caller passes global arrays: the rank runs its own L/P
    layers, a view of them.  With ``local=True`` the leaves hold only
    this rank's block (leading axis L/P, the layers [p·L/P, (p+1)·L/P)),
    so that a stage keeps only its own layers in memory.
    x: (B, ...) global batch on every rank; B % n_micro == 0.

    Returns the (B, ...) output on every rank.  A stage runs its layers
    only on steps where it holds a microbatch (bubble steps run nothing)
    but every rank takes part in every step's permute; stage 0 receives
    zeros, the last stage sends nothing.  The output is the last stage's,
    summed over the axis with every other stage's zeros.

    Gradients: the adjoint of the final sum hands each stage the mean of
    the ranks' cotangents, so the gradients are those of the mean of the
    ranks' losses.  Precondition: every rank computes the same loss on
    the (replicated) output, as the reference's caller computes one loss
    on its global output; then the mean is that loss and the gradients
    are the sequential pass's.  Ranks whose losses differ get the
    gradient of their mean, not of any one rank's loss.  The gradient a
    rank holds for a stacked leaf is its own L/P block of it, with zeros
    elsewhere (with ``local=True``, the whole of its leaf).  With
    gradients on, every rank must call ``backward()``: it is
    collective."""
    n_stages = mesh.axis_size(stage_axis)
    leaves = pytree.tree_leaves(stacked_params)
    lead = leaves[0].shape[0]
    if not local and lead % n_stages:
        raise ValueError(f"{lead} layers do not split over {n_stages} "
                         f"stages")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    per = lead if local else lead // n_stages
    stage = mesh.axis_index(stage_axis)
    mine = stacked_params if local else pytree.tree_map(
        lambda t: mesh.block_of(t, (stage_axis,) + (None,) * (t.ndim - 1)),
        stacked_params)
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    # with gradients on, every rank records every permute and the sum,
    # and its loss reaches each of them, so that every rank runs their
    # backward collectives, in one order: the first buffer requires grad,
    # a bubble passes on what it got, and the output holds the last
    # buffer (with weight zero, the reference's masked select)
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + [x])
    buf = micro.new_zeros(micro.shape[1:]).requires_grad_(track)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    outputs = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        h = buf
        if 0 <= m < n_micro:
            if stage == 0:
                h = micro[m] + buf       # buf: the zeros stage 0 receives
            for i in range(per):
                h = layer_fn(pytree.tree_map(lambda p, i=i: p[i], mine), h)
            if stage == n_stages - 1:
                outputs.append(h)
        buf = mesh.permute(h, stage_axis, fwd_perm)
    if stage == n_stages - 1:
        out = torch.stack(outputs)
    else:
        out = micro.new_zeros(micro.shape)
    if track:
        out = torch.where(torch.zeros((), dtype=torch.bool,
                                      device=out.device), buf, out)
        out.register_hook(lambda g: g / n_stages)
    return mesh.psum(out, stage_axis).reshape(x.shape)
