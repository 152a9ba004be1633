"""The least work of the complex128 DFT products of a four-step local
FFT, counted from the problem's shapes: ``dft_work.py``'s count for
16-byte elements at the FP64 peak.

A product of radix r over an array of E complex128 elements reads and
writes the array once (2 * E * 16 bytes) and does 8 * r * E operations
(r complex multiply-adds an output element, 8 real operations each), at
67 TFLOP/s, the FP64 tensor-core rate of one H100 SXM (NVIDIA's data
sheet, dense, at its 700 W limit).  Every radix up to 64 is bound by the
bytes there: 32 bytes an element over 3.35 TB/s is 9.55 ps, 8 * 64
operations over 67 TFLOP/s 7.64 ps.  So a 1024-point axis is two
products, 10.26 ms each over 2^30 elements.

An axis's least is the smallest, over every factorisation of n into
radices of at most ``MAX_RADIX``, of the sum of its products' least
times; a step's least is the sum over its transforms' axes, on one
rank's share of the elements.
"""

from __future__ import annotations

import functools

from perfbench.harness import work as work_lib

FP64_FLOP_S = 67e12        # FP64 tensor cores, dense
C128 = 16                  # bytes of a complex128 element
MAX_RADIX = 64


def product_s(radix: int, elements: float) -> float:
    """Least time of one complex128 DFT product of ``radix`` over
    ``elements``."""
    return work_lib.bound_s(2 * elements * C128, 8 * radix * elements,
                            FP64_FLOP_S)[0]


@functools.lru_cache(maxsize=None)
def axis_least_s(n: int, elements: float) -> float:
    """Least time of the DFT products of an n-point axis over
    ``elements`` complex128 elements."""
    if n == 1:
        return 0.0
    return min(product_s(r, elements) + axis_least_s(n // r, elements)
               for r in range(2, min(n, MAX_RADIX) + 1) if n % r == 0)


def step_least_s(step: work_lib.StepWork) -> float:
    """Least time of the complex128 DFT products of a step's c2c
    transforms: 3 axes a transform, on one rank's share of the
    elements."""
    return sum(axis_least_s(n, t.points / t.ranks)
               for t in step.transforms if t.kind == "c2c" for n in t.grid)
