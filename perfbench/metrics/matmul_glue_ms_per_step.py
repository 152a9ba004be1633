"""matmul_glue_ms_per_step: device milliseconds per step of the passes
of the matmul local FFT outside its DFT products, from the timing
events of the port's spans ``matmul:twiddle`` (the twiddle multiply)
and ``matmul:relayout`` (the output's transposed copy); the copies
``einsum`` makes around its GEMMs lie inside ``matmul:dft``.  Stream
idle inside the spans counts (``harness/spans.py``).  The largest
rank's.  Layer: Local FFT (matmul) (``core/local_fft.py:fft_matmul``).
Moves ``step_ms``.  Nothing to read where the program records no such
span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"

SPANS = ("matmul:twiddle", "matmul:relayout")


def read(ctx):
    return device_ms_per_step(ctx, SPANS)
