"""realpipe_roofline: the least time of the real pipeline's streaming
work in a step (``harness/work.py``: the split of the packed spectrum,
the Hermitian extension and the k-space multiply, each input byte read
once and each output byte written once) over the device time per step
of the kernels of ``csrc/hermitian.cu`` and ``csrc/spectral_scale.cu``,
in %.  The lowest rank's.  Layer: Real pipeline (``real/pipeline.py``,
``real/packing.py``, ``kernels/hermitian.py``,
``kernels/spectral_scale.py``).  Moves ``step_ms``.  Nothing to read in a
cell without the packed real pipeline."""

COMBINE = "min"


def read(ctx):
    if not ctx.on_card() or ctx.work.realpipe_bytes <= 0:
        return None
    ops = ctx.kernel_ops("hermitian", "spectral_scale")
    t = ctx.timeline.time_s(ops) / ctx.steps
    if t <= 0:
        return None
    return 100.0 * ctx.work.realpipe_least_s() / t
