"""The least work of the DFT products of a four-step local FFT, counted
from the problem's shapes.

A 1-D FFT of n points computed as DFT products (the ``matmul`` local
FFT) factors n into radices and applies one dense DFT product a radix.
A product of radix r over an array of E complex elements reads and
writes the array once (2 * E * 8 bytes) and does 8 * r * E operations
(r complex multiply-adds an output element, 8 real operations each).
Its least time is ``work.bound_s`` of those.

An axis's least is the smallest, over every factorisation of n into
radices of at most ``MAX_RADIX``, of the sum of its products' least
times.  So whatever split the program takes, its products cannot read
above 100 % of this least: a program that splits 1024 as 32 x 32 meets
it, one that splits as 64 x 16 takes longer.  A step's least is the sum
over its transforms' axes, on one rank's share of the elements (half of
them for a real transform, as in ``work.Transform``).
"""

from __future__ import annotations

import functools

from perfbench.harness import work as work_lib

MAX_RADIX = 64


def product_s(radix: int, elements: float) -> float:
    """Least time of one DFT product of ``radix`` over ``elements``."""
    return work_lib.bound_s(2 * elements * work_lib.C64,
                            8 * radix * elements)[0]


@functools.lru_cache(maxsize=None)
def axis_least_s(n: int, elements: float) -> float:
    """Least time of the DFT products of an n-point axis over
    ``elements`` complex elements."""
    if n == 1:
        return 0.0
    return min(product_s(r, elements) + axis_least_s(n // r, elements)
               for r in range(2, min(n, MAX_RADIX) + 1) if n % r == 0)


def step_least_s(step: work_lib.StepWork) -> float:
    """Least time of the DFT products of a step's transforms: 3 axes a
    transform, on one rank's share of the elements."""
    total = 0.0
    for t in step.transforms:
        e = t.points / t.ranks / (1 if t.kind == "c2c" else 2)
        total += sum(axis_least_s(n, e) for n in t.grid)
    return total
