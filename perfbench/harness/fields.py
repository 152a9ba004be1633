"""Seeded input fields, made on the device in a few large calls.

The global field is drawn in fixed blocks of ``PLANES`` x-planes, each
from a generator of its own seeded from ``(seed, block)``.  So any rank,
and the reference after the window, can make any block of the same field
without the rest: a rank's block is the planes of its x range cut to its
y and z ranges.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import torch

PLANES = 16


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    text = ":".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def planes(seed: int, shape: Sequence[int], dtype: torch.dtype, x0: int,
           x1: int, device, ys: slice = slice(None),
           zs: slice = slice(None)) -> torch.Tensor:
    """Planes ``[x0, x1)`` of the seeded global field, cut to ``ys``,
    ``zs``."""
    nx, ny, nz = shape
    out = None
    for b in range(x0 // PLANES, math.ceil(x1 / PLANES)):
        lo, hi = b * PLANES, min(nx, (b + 1) * PLANES)
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "field", b))
        blk = torch.randn((hi - lo, ny, nz), dtype=dtype, device=device,
                          generator=gen)[:, ys, zs]
        if out is None:
            out = torch.empty((x1 - x0,) + blk.shape[1:], dtype=dtype,
                              device=device)
        s0, s1 = max(lo, x0), min(hi, x1)
        out[s0 - x0:s1 - x0] = blk[s0 - lo:s1 - lo]
        del blk
    return out


def block(seed: int, shape: Sequence[int], dtype: torch.dtype,
          slices: Sequence[slice], device) -> torch.Tensor:
    """The block ``slices`` of the seeded global field."""
    sx, ys, zs = slices
    return planes(seed, shape, dtype, sx.start, sx.stop, device, ys, zs)


def sample_points(seed: int, tag: str, numel: int, count: int,
                  device) -> torch.Tensor:
    """``count`` flat indices into a block of ``numel`` elements, drawn
    from the seed."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "points", tag))
    return torch.randint(0, numel, (count,), generator=gen).to(device)
