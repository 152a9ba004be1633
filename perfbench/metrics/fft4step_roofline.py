"""fft4step_roofline: the least time of the 1-D FFT passes a step's
transforms need (``harness/work.py``: 3 passes a 3-D transform, each
reading and writing the transformed array once, the larger of its bytes
over 3.35 TB/s and 5 N log2 N a row over 67 TFLOP/s) over the device
time per step of the kernels of ``csrc/fft4step.cu``, in %.  The lowest
rank's.  Layer: Kernels (``kernels/fft_matmul.py``, ``csrc/fft4step.cu``).
Moves ``step_ms``.  Nothing to read where no such kernel ran."""

COMBINE = "min"


def read(ctx):
    if not ctx.on_card():
        return None
    t = ctx.timeline.time_s(ctx.kernel_ops("fft4step")) / ctx.steps
    if t <= 0:
        return None
    return 100.0 * ctx.work.fft_least_s() / t
