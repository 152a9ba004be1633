"""plain_axis_ms_per_step: device milliseconds per step of the port's
``matmul:plain`` spans, the contiguous axes that the fused DFT kernel's
plain version runs (complex128: two cuBLAS ``zgemm`` products and the
twiddle pass between them, three passes over the field), from their
timing events.  Stream idle inside the spans counts
(``harness/spans.py``).  The largest rank's.  Layer: Local FFT (matmul)
(``core/local_fft.py:fft_matmul``, ``kernels/dft_rows.py``).  Moves
``step_ms``.  Nothing to read where the program records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"

SPANS = ("matmul:plain",)


def read(ctx):
    return device_ms_per_step(ctx, SPANS)
