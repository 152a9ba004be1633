"""Gradient compression for the cross-pod (slow-link) reduction.

Port of ``repro/parallel/compression.py``.  The ``pod`` axis reduction
can run through int8 error-feedback compression: quantize (per-tensor
scale), sum the int8 payload (widened to int32 for the reduction),
dequantize, and carry the quantization residual into the next step's
gradients (EF-SGD, Karimireddy et al. 2019 — keeps convergence unbiased
to first order).

What goes on the wire, as the reference writes it and as here: one
all-reduce (MAX) of a float32 scalar per tensor for the shared scale,
then one all-reduce (SUM) of the int32 payload, which is as many bytes
as a float32 all-reduce of the tensor.  Nothing is put on the wire as
int8 (an int8 sum would overflow).  No train step calls
:func:`compressed_psum`.

Trees are dicts, lists or tuples of tensors (the reference's pytrees);
a residual may be None.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_residual(x: torch.Tensor, residual: Optional[torch.Tensor]):
    """Error-feedback step: add carried residual, quantize, compute new
    residual.  Returns (q, scale, new_residual)."""
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual
    q, scale = quantize_int8(xf)
    new_residual = xf - dequantize_int8(q, scale)
    return q, scale, new_residual


def _flatten(tree) -> list:
    """The leaves of ``tree`` (dicts, lists, tuples), None included, in
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves``, in :func:`_flatten`'s order."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def compressed_psum(tree, axis_name: str, residuals=None, *, mesh):
    """int8 error-feedback sum of ``tree`` over ``axis_name`` of ``mesh``
    (a ``core.mesh.Mesh``); every rank of the axis calls it with its own
    tree of the same structure.

    Returns (reduced_tree, new_residuals).  The scale of a leaf is shared
    by every member: the MAX all-reduce of ``max|x + res|``, over 127.
    The payload ``round((x + res) / scale)`` is summed as int32 and
    dequantized with that scale; the new residual is what the rounding
    dropped.  Both all-reduces are ``Mesh.all_reduce``'s, counted under
    ``Mesh.counting()``."""
    xs = _flatten(tree)
    rs = [None] * len(xs) if residuals is None else _flatten(residuals)

    def one(x, res):
        xf = x.to(torch.float32)
        if res is not None:
            xf = xf + res
        # consistent per-tensor scale across participants
        amax = mesh.all_reduce(xf.abs().max().reshape(1), axis_name,
                               op=dist.ReduceOp.MAX).wait()[0]
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(xf / scale), -127, 127)
        summed = mesh.all_reduce(q.to(torch.int32), axis_name).wait()
        out = summed.to(torch.float32) * scale
        new_res = xf - q * scale
        return out.to(x.dtype), new_res

    outs, new = zip(*(one(x, r) for x, r in zip(xs, rs))) if xs else ((), ())
    return _unflatten(tree, iter(outs)), _unflatten(tree, iter(new))


def topk_sparsify(x: torch.Tensor, frac: float = 0.01):
    """Top-k magnitude sparsification (alternative compressor): returns
    (values, flat_indices) of the largest-|x| fraction."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_densify(values: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=values.dtype,
                      device=values.device)
    out[idx] = values
    return out.reshape(shape)
