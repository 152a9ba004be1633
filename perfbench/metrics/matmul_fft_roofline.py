"""matmul_fft_roofline: the least time of the 1-D FFT passes a step's
transforms need (``harness/work.py``, as ``fft4step_roofline`` counts
them: 3 passes a 3-D transform, each reading and writing the array once)
over the device time per step of the port's ``matmul:dft``,
``matmul:twiddle`` and ``matmul:relayout`` spans, the whole of the
matmul local FFT, from their timing events.  In %.  Stream idle inside
the spans counts (``harness/spans.py``).  The lowest rank's.  Layer:
Local FFT (matmul) (``core/local_fft.py:fft_matmul``).  Moves
``step_ms``.  Nothing to read where the program records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "min"

SPANS = ("matmul:dft", "matmul:twiddle", "matmul:relayout")


def read(ctx):
    ms = device_ms_per_step(ctx, SPANS)
    if not ms:
        return None
    return 100.0 * ctx.work.fft_least_s() * 1e3 / ms
