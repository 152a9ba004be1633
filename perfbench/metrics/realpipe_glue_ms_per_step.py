"""realpipe_glue_ms_per_step: device milliseconds per step of the packed
real pipeline's PyTorch glue, from the timing events of the port's
spans ``real:pack_two`` (the complex cast of two real pencils),
``real:unfold_dc_plane`` and ``real:fold_dc_plane`` (the DC/Nyquist
plane and the ``cat`` around it) and ``real:split_pairs`` (the ``cat``
of real and imaginary parts).  The spans of the ``hermitian.cu``
kernels, ``real:unpack_two`` and ``real:repack_halves``, are left out:
``realpipe_roofline`` reads those kernels.  Stream idle inside the
spans counts (``harness/spans.py``).  The largest rank's.  Layer: Real
pipeline.  Moves ``step_ms``.  Nothing to read where the program
records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"

SPANS = ("real:pack_two", "real:unfold_dc_plane", "real:fold_dc_plane",
         "real:split_pairs")


def read(ctx):
    return device_ms_per_step(ctx, SPANS)
