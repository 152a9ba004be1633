"""dft_rows_roofline: the least time of the contiguous-axis passes that
``csrc/dft_rows.cu`` runs over the device time per step of its kernel,
in %.  The kernel computes an n-point axis as two dense DFT products of
the split n = n1 * n2 and the twiddle between them, in one read and one
write of the array: its least over E complex elements is the larger of
2 * E * 8 bytes and 8 * (n1 + n2) * E operations (``harness/work.py``'s
``bound_s``; 8 operations a complex multiply-add, the twiddle left
out), at the cheapest split into radices of at most 64 (32 x 32 for
1024: 8.2 ms at 2^30 elements, bound by operations).  A step holds one
such axis a c2c transform of 128 to 4096 points along its last, unit
stride dim, on one rank's share of the elements.  The lowest rank's.
Layer: Kernels (``kernels/dft_rows.py``, ``csrc/dft_rows.cu``).  Moves
``step_ms``.  Nothing to read where no such kernel ran."""

from perfbench.harness import work as work_lib

COMBINE = "min"

MAX_RADIX = 64


def axis_least_s(n: int, elements: float) -> float:
    """Least time of one pass of the kernel over an n-point axis."""
    return min(work_lib.bound_s(2 * elements * work_lib.C64,
                                8 * (r + n // r) * elements)[0]
               for r in range(2, MAX_RADIX + 1)
               if n % r == 0 and 2 <= n // r <= MAX_RADIX)


def step_least_s(step: work_lib.StepWork) -> float:
    return sum(axis_least_s(t.grid[-1], t.points / t.ranks)
               for t in step.transforms
               if t.kind == "c2c" and MAX_RADIX < t.grid[-1] <= MAX_RADIX ** 2)


def read(ctx):
    if not ctx.on_card():
        return None
    t = ctx.timeline.time_s(ctx.kernel_ops("dft_rows")) / ctx.steps
    least = step_least_s(ctx.work)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
