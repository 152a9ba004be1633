"""dft_c128_roofline: the least time of a step's complex128 DFT products
(``harness/dft_work_c128.py``: each product of radix r over E elements
reads and writes them once, 32 E bytes, and does 8 r E operations at the
FP64 peak; a 1024-point axis is two products, 10.26 ms each over 2^30
elements, bound by the bytes) over the device time per step of the
kernels that run those products: the cuBLAS GEMMs launched in the port's
calls (a name holding ``gemm``, no kernel of ``csrc/``, no NCCL), and
the kernels of any ``csrc/dft*.cu`` source, so that a hand-written
complex128 DFT kernel keeps the reading comparable.  In %.  The lowest
rank's.  Layer: Local FFT (matmul) (``core/local_fft.py:fft_matmul``).
Moves ``step_ms``.  Its count is of complex128 products: it is listed
only for cells whose every product is one.  Nothing to read where no
such kernel ran."""

from perfbench.harness import dft_work_c128
from perfbench.harness.timeline import is_nccl, name_matcher

COMBINE = "min"


def is_gemm(name: str) -> bool:
    return "gemm" in name.lower()


def read(ctx):
    if not ctx.on_card():
        return None
    dft = name_matcher(n for stem, names in ctx.kernels.items()
                       if stem.startswith("dft") for n in names)
    ops = ctx.timeline.select(
        lambda op: (op[3] is None or op[3] in ctx.port_ranges)
        and not is_nccl(op[0])
        and (dft(op[0]) or (is_gemm(op[0]) and not ctx.is_handwritten(op[0]))))
    t = ctx.timeline.time_s(ops) / ctx.steps
    if t <= 0:
        return None
    return 100.0 * dft_work_c128.step_least_s(ctx.work) / t
