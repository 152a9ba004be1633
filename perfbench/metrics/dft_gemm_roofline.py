"""dft_gemm_roofline: the least time of a step's DFT products
(``harness/dft_work.py``: each product of radix r over E complex
elements reads and writes them once and does 8 r E operations; an
axis's least is its cheapest factorisation into radices of at most 64,
two 32-point products for 1024) over the device time per step of the
cuBLAS GEMM kernels those products run as: the device ops launched in
the port's calls whose name holds ``gemm``, that are no kernel of
``csrc/`` and no NCCL kernel.  In %.  The lowest rank's.  Layer: Local
FFT (matmul) (``core/local_fft.py:fft_matmul``).  Moves ``step_ms``.
Nothing to read where no such kernel ran."""

from perfbench.harness import dft_work
from perfbench.harness.timeline import is_nccl

COMBINE = "min"


def is_gemm(name: str) -> bool:
    return "gemm" in name.lower()


def read(ctx):
    if not ctx.on_card():
        return None
    ops = ctx.timeline.select(
        lambda op: (op[3] is None or op[3] in ctx.port_ranges)
        and is_gemm(op[0]) and not is_nccl(op[0])
        and not ctx.is_handwritten(op[0]))
    t = ctx.timeline.time_s(ops) / ctx.steps
    if t <= 0:
        return None
    return 100.0 * dft_work.step_least_s(ctx.work) / t
